"""The port's workload scoreboard against the JAX package's on the same
streams (JAX's own board streams swapped in for the port's synthesis):
rows, per-family curves and exposures at the JAX package's kernel-vs-lax
standard (``rtol=3e-4, atol=1e-4``, plus the boards' 4-decimal
rounding)."""

from __future__ import annotations

import numpy as np
import pytest

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.workloads.scoreboard import \
    workload_scoreboard as jworkload_scoreboard
from ccka_tpu_torch.workloads.scoreboard import workload_scoreboard
from test_torch_fault_board import (N_TRACES, POLICIES, STEPS, TRACE_SEED,
                                    assert_close, mpc_close,
                                    use_jax_streams)

SCENARIOS = ("flash-crowd", "mixed")


def test_board_matches_jax_on_the_same_streams(monkeypatch):
    """Multiregion; flash-crowd (workload lanes) and mixed (fault and
    workload lanes); rule/carbon/flagship, B = 8 x T = 32, deterministic
    on both sides."""
    jc, tc = jcfg.PRESETS["multiregion"](), tcfg.PRESETS["multiregion"]()
    want = jworkload_scoreboard(jc, scenarios=SCENARIOS, policies=POLICIES,
                                n_traces=N_TRACES, eval_steps=STEPS,
                                trace_seed=TRACE_SEED)
    use_jax_streams(monkeypatch, jc)
    got = workload_scoreboard(tc, scenarios=SCENARIOS, policies=POLICIES,
                              n_traces=N_TRACES, eval_steps=STEPS,
                              trace_seed=TRACE_SEED, device="cpu")
    assert got["row_fields"] == want["row_fields"]
    assert got["flagship_source"] == want["flagship_source"]
    assert list(got["scenarios"]) == list(SCENARIOS)
    worst = 0.0
    for name, board in want["scenarios"].items():
        mine = got["scenarios"][name]
        for k in ("description", "family_mix", "fault_preset",
                  "stream_rows", "stream_bytes_per_cluster_tick"):
            assert mine[k] == board[k], (name, k)
        for k, v in board["exposure"].items():
            worst = max(worst, assert_close(mine["exposure"][k], v,
                                            f"{name} exposure {k}"))
        assert list(mine["rows"]) == list(board["rows"]) == list(POLICIES)
        for p, row in board["rows"].items():
            for k, v in row.items():
                worst = max(worst, assert_close(mine["rows"][p][k], v,
                                                f"{name} {p} {k}", p, k))
    for p, curve in want["per_family_curves"].items():
        assert got["per_family_curves"][p]["scenarios"] == curve["scenarios"]
        for k, v in curve.items():
            if k != "scenarios":
                worst = max(worst, assert_close(
                    got["per_family_curves"][p][k], v, f"curve {p} {k}", p,
                    k))
    assert max(got["per_family_curves"]["rule"]["inf_slo_violations"]) > 0
    print(f"\n# workload board: worst {worst:.3g} of the standard")


def test_mpc_row_matches_jax_on_the_same_streams(monkeypatch):
    """The mpc row on flash-crowd and mixed (multiregion, B = 8 x T = 32,
    deterministic), planned once on the shared exo rows and played back on
    each scenario, against JAX's board on its own streams: the rule rows
    at the kernel standard, the mpc rows at the fault board's
    ``MPC_RTOL``; the planner's record and its plan rows."""
    jc, tc = jcfg.PRESETS["multiregion"](), tcfg.PRESETS["multiregion"]()
    want = jworkload_scoreboard(jc, scenarios=SCENARIOS,
                                policies=("rule", "mpc"), n_traces=N_TRACES,
                                eval_steps=STEPS, trace_seed=TRACE_SEED)
    use_jax_streams(monkeypatch, jc)
    got = workload_scoreboard(tc, scenarios=SCENARIOS,
                              policies=("rule", "mpc"), n_traces=N_TRACES,
                              eval_steps=STEPS, trace_seed=TRACE_SEED,
                              device="cpu")
    for k in ("horizon", "replan_every", "iters", "n_traces", "plan_rows"):
        assert got["mpc_planner"][k] == want["mpc_planner"][k], k
    assert got["mpc_planner"]["plan_rows"] == 24
    worst = 0.0
    for name in SCENARIOS:
        rows, wrows = (got["scenarios"][name]["rows"],
                       want["scenarios"][name]["rows"])
        assert list(rows) == list(wrows) == ["rule", "mpc"]
        for k, v in wrows["rule"].items():
            assert_close(rows["rule"][k], v, f"{name} rule {k}")
        worst = max(worst, mpc_close(rows["mpc"], wrows["mpc"],
                                     f"{name} mpc"))
    print(f"\n# workload board mpc rows: worst {worst:.3g} of MPC_RTOL")


def test_board_refuses_before_any_stream():
    tc = tcfg.PRESETS["multiregion"]()
    with pytest.raises(ValueError, match="unknown scenarios"):
        workload_scoreboard(tc, scenarios=("mixed", "typo"), device="cpu")
    with pytest.raises(ValueError, match="unknown policies"):
        workload_scoreboard(tc, policies=("rul",), device="cpu")


def test_board_runs_on_its_own_streams_on_the_cpu():
    """The port's own synthesis end to end at a small size, each
    scenario under its own WorkloadsConfig."""
    tc = tcfg.PRESETS["default"]()
    board = workload_scoreboard(tc, scenarios=("flash-crowd", "mixed"),
                                policies=("rule",), n_traces=16,
                                eval_steps=48, device="cpu")
    assert board["scenarios"]["mixed"]["fault_preset"] == "mild"
    assert board["scenarios"]["mixed"]["stream_rows"] == 16 + 8 + 16
    for sc in board["scenarios"].values():
        row = sc["rows"]["rule"]
        assert all(np.isfinite(v) for v in row.values())
        assert sc["exposure"]["inference_arrivals_mean"] > 0
