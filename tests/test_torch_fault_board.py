"""The port's fault scoreboard against the JAX package's on the same
streams: the port's stream synthesis is swapped for JAX's own board
streams, so rows, degradation curves and exposures must agree at the JAX
package's kernel-vs-lax standard (``rtol=3e-4, atol=1e-4``, plus the
boards' 4-decimal rounding)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.faults.scoreboard import fault_scoreboard as jfault_scoreboard
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu_torch.faults.scoreboard import fault_scoreboard
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

N_TRACES, STEPS, TRACE_SEED = 8, 32, 97
POLICIES = ("rule", "carbon", "flagship")


def jax_stream_for(source, jc, steps, batch, trace_seed):
    """JAX's packed stream for a port source's lane configs: what the JAX
    board generates for the same intensity or scenario on the CPU
    (``t_chunk`` 32)."""
    faults = (None if source.faults is None else jcfg.FaultsConfig(
        **dataclasses.asdict(source.faults)))
    workloads = (None if source.workloads is None else jcfg.WorkloadsConfig(
        **dataclasses.asdict(source.workloads)))
    stream = JSource(jc.cluster, jc.workload, jc.sim, jc.signals,
                     faults=faults, workloads=workloads).packed_trace_device(
        steps, jax.random.key(trace_seed), batch, t_chunk=32)
    return torch.from_numpy(np.array(stream))


def use_jax_streams(monkeypatch, jc):
    def packed(self, steps, seed, batch, *, t_pad=None, device=None):
        return jax_stream_for(self, jc, steps, batch, seed)

    monkeypatch.setattr(SyntheticSignalSource, "packed_trace_device", packed)


# The shipped flagship's batch means are held to the short-horizon
# standard (`tests/test_torch_neural.py`): 1e-3 relative, 2e-2 for the
# counters near zero. A bf16 feedback policy turns a last-bit difference
# into a flipped hidden unit, which JAX's own kernel and lax path show
# against each other too.
FLAGSHIP_LOOSE = ("interruptions", "denials", "evictions", "queue_depth_mean",
                  "inf_dropped", "batch_deadline_misses",
                  "vs_calm_usd_per_slo_hour_se")


def assert_close(got, want, what: str, policy: str = "rule",
                 field: str = "") -> float:
    """Board numbers (rounded to 4 decimals on both sides) within the
    standard: ``rtol=3e-4, atol=1e-4`` for the rule and carbon rows, the
    flagship's batch-mean standard for its rows; returns the worst
    |a - b| / bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol = 3e-4
    if policy == "flagship":
        rtol = 2e-2 if field in FLAGSHIP_LOOSE else 1e-3
    bound = 1e-4 + rtol * np.abs(want) + 1e-4
    assert np.all(np.abs(got - want) <= bound), (what, got, want)
    return float((np.abs(got - want) / bound).max())


def test_board_matches_jax_on_the_same_streams(monkeypatch):
    """Multiregion, four intensities, rule/carbon/flagship, B = 8 x T = 32,
    deterministic on both sides (JAX's interpret-mode kernels)."""
    jc, tc = jcfg.PRESETS["multiregion"](), tcfg.PRESETS["multiregion"]()
    want = jfault_scoreboard(jc, policies=POLICIES, n_traces=N_TRACES,
                             eval_steps=STEPS, trace_seed=TRACE_SEED)
    use_jax_streams(monkeypatch, jc)
    got = fault_scoreboard(tc, policies=POLICIES, n_traces=N_TRACES,
                           eval_steps=STEPS, trace_seed=TRACE_SEED,
                           device="cpu")
    assert got["stochastic"] is False and got["eval_steps"] == STEPS
    assert got["flagship_source"] == want["flagship_source"]
    assert list(got["intensities"]) == list(want["intensities"])
    worst = 0.0
    for name, board in want["intensities"].items():
        mine = got["intensities"][name]
        assert mine["faults"] == board["faults"], name
        for k, v in board["exposure"].items():
            worst = max(worst, assert_close(mine["exposure"][k], v,
                                            f"{name} exposure {k}"))
        assert list(mine["rows"]) == list(board["rows"]) == list(POLICIES)
        for p, row in board["rows"].items():
            assert set(mine["rows"][p]) == set(row), (name, p)
            for k, v in row.items():
                worst = max(worst, assert_close(mine["rows"][p][k], v,
                                                f"{name} {p} {k}", p, k))
    for p, curve in want["degradation_curves"].items():
        assert got["degradation_curves"][p]["intensities"] == \
            curve["intensities"]
        for k, v in curve.items():
            if k != "intensities":
                worst = max(worst, assert_close(
                    got["degradation_curves"][p][k], v, f"curve {p} {k}", p,
                    k))
    # The board is not trivially calm: severe degrades every policy.
    for p in POLICIES:
        assert got["degradation_curves"][p]["vs_calm_usd_per_slo_hour"][-1] \
            > 1.0, p
    print(f"\n# fault board: worst {worst:.3g} of the standard")


def test_board_refuses_before_any_stream():
    tc = tcfg.PRESETS["multiregion"]()
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        fault_scoreboard(tc, policies=("rule", "mpc"), device="cpu")
    with pytest.raises(ValueError, match="unknown policies"):
        fault_scoreboard(tc, policies=("rule", "typo"), device="cpu")
    with pytest.raises(ValueError, match='"off"'):
        fault_scoreboard(tc, intensities=("mild",), device="cpu")
    with pytest.raises(ValueError, match="unknown fault intensities"):
        fault_scoreboard(tc, intensities=("off", "hurricane"), device="cpu")


def test_board_runs_on_its_own_streams_on_the_cpu():
    """The port's own synthesis end to end at a small size: every row
    finite, the exo rows shared, severe worse than calm."""
    tc = tcfg.PRESETS["default"]()
    board = fault_scoreboard(tc, intensities=("off", "severe"),
                             policies=("rule", "carbon"), n_traces=16,
                             eval_steps=48, device="cpu")
    assert "flagship_source" not in board
    for name in ("off", "severe"):
        for p in ("rule", "carbon"):
            assert np.isfinite(board["intensities"][name]["rows"][p][
                "usd_per_slo_hour"])
    sev = board["intensities"]["severe"]
    assert sev["exposure"]["mean_hazard"] > 1.0
    assert board["intensities"]["off"]["exposure"]["mean_hazard"] == 1.0
    assert sev["rows"]["rule"]["vs_calm_usd_per_slo_hour"] > 1.0


def test_boards_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a CUDA device the boards and the new entry points raise
    instead of falling back; with ``device="cpu"`` they run."""
    from ccka_tpu_torch.faults.types import FaultStep
    from ccka_tpu_torch.workloads.scoreboard import workload_scoreboard
    from ccka_tpu_torch.workloads.types import WorkloadState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = tcfg.PRESETS["default"]()
    src = SyntheticSignalSource(tc.cluster, tc.workload, tc.sim, tc.signals,
                                faults=tcfg.FAULT_PRESETS["mild"])
    for call in (lambda: fault_scoreboard(tc, policies=("rule",)),
                 lambda: workload_scoreboard(tc, policies=("rule",)),
                 lambda: src.packed_trace_device(8, 1, 4),
                 lambda: FaultStep.neutral(3),
                 lambda: WorkloadState.zero(16, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert src.packed_trace_device(8, 1, 4, device="cpu").shape == (
        8, src.packed_rows(), 4)
