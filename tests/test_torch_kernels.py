"""The port's CUDA kernels against their plain PyTorch versions on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip on a machine without a CUDA device; `chip_smoke.py` runs the same
checks at full size. Run them on a GPU host with
``python -m pytest tests/test_torch_kernels.py -q -m gpu``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ccka_tpu_torch import PRESETS
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy, offpeak_action, peak_action
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim import random as prandom
from ccka_tpu_torch.sim.rollout import batched_rollout_summary, initial_state
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train.flagship import load_flagship_backend

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no "
                    "CPU mode (chip_smoke.py checks them on the card)")
    return torch.device("cuda")


def test_philox_kernel_bitwise_equals_torch_stream(cuda):
    seed, nb, tick0, nt, nr = 2**35 + 9, 300, 4000, 7, 6
    got = prandom.uniform_grid(seed, nb, tick0, nt, nr, cuda)
    ar = lambda n: torch.arange(n, device=cuda)  # noqa: E731
    want = prandom.uniforms(seed, ar(nb)[None, None, :],
                            (tick0 + ar(nt))[:, None, None],
                            ar(nr)[None, :, None])
    assert torch.equal(got, want)


@pytest.mark.parametrize("preset", ["default", "multiregion"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_rollout_kernel_matches_plain_version(cuda, preset, stochastic):
    cfg = PRESETS[preset]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    B, T = 512, 2880
    traces = src.batch_trace_device(
        T, torch.Generator(device=cuda).manual_seed(1), B, device=cuda)
    params = SimParams.from_config(cfg, device=cuda)
    before = mk.megakernel_summary_from_packed.launches
    k = mk.megakernel_rollout_summary(
        params, offpeak_action(cfg.cluster, cuda),
        peak_action(cfg.cluster, cuda), traces, seed=4,
        stochastic=stochastic, device=cuda)
    assert mk.megakernel_summary_from_packed.launches == before + 1
    _, p = batched_rollout_summary(
        params, initial_state(cfg, B, cuda),
        RulePolicy(cfg.cluster, cuda).action_fn(), traces, 4,
        stochastic=stochastic)
    agree = torch.ones(B, dtype=torch.bool, device=cuda)
    for f in p._fields:
        a, b = getattr(k, f), getattr(p, f)
        assert torch.isfinite(a).all(), f
        agree &= (a - b).abs() <= 2e-3 * (b.abs() + 1e-6)
    assert agree.double().mean().item() >= (0.99 if stochastic else 0.999)
    assert mk.mean_parity_violations(k, p) == {}


def test_kernel_refuses_unbuilt_topology(cuda):
    cfg = PRESETS["default"]()
    params = SimParams.from_config(cfg, device=cuda)
    params = params._replace(provision_pipeline_k=5)
    exo = torch.zeros((8, mk.exo_rows(3), 64), device=cuda)
    with pytest.raises(ValueError, match="built for"):
        mk.megakernel_summary_from_packed(
            params, offpeak_action(cfg.cluster, cuda),
            peak_action(cfg.cluster, cuda), exo, 8, stochastic=False)


@pytest.mark.parametrize("preset", ["default", "multiregion"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_carbon_kernel_matches_plain_version(cuda, preset, stochastic):
    cfg = PRESETS[preset]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    B, T = 512, 2880
    traces = src.batch_trace_device(
        T, torch.Generator(device=cuda).manual_seed(2), B, device=cuda)
    params = SimParams.from_config(cfg, device=cuda)
    constants = dict(sharpness=25.0, min_weight=0.1, stickiness=0.5)
    before = mk.carbon_megakernel_summary_from_packed.launches
    rule_before = mk.megakernel_summary_from_packed.launches
    k = mk.carbon_megakernel_rollout_summary(
        params, offpeak_action(cfg.cluster, cuda),
        peak_action(cfg.cluster, cuda), traces, seed=4,
        stochastic=stochastic, device=cuda, **constants)
    assert mk.carbon_megakernel_summary_from_packed.launches == before + 1
    assert mk.megakernel_summary_from_packed.launches == rule_before
    _, p = batched_rollout_summary(
        params, initial_state(cfg, B, cuda),
        CarbonAwarePolicy(cfg.cluster, device=cuda, **constants).action_fn(),
        traces, 4, stochastic=stochastic)
    agree = torch.ones(B, dtype=torch.bool, device=cuda)
    for f in p._fields:
        a, b = getattr(k, f), getattr(p, f)
        assert torch.isfinite(a).all(), f
        agree &= (a - b).abs() <= 2e-3 * (b.abs() + 1e-6)
    assert agree.double().mean().item() >= (0.99 if stochastic else 0.999)
    assert mk.mean_parity_violations(k, p) == {}


@pytest.mark.parametrize("preset,variant", [("default", "replay"),
                                            ("multiregion", "")])
def test_mlp_kernel_matches_plain_version(cuda, preset, variant):
    """Short horizon per cluster (1e-3, five near-zero-denominator fields
    2e-2) and a longer stochastic one by batch means."""
    cfg = PRESETS[preset]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    B, T = 512, 288
    traces = src.batch_trace_device(
        T, torch.Generator(device=cuda).manual_seed(3), B, device=cuda)
    params = SimParams.from_config(cfg, device=cuda)
    net = load_flagship_backend(cfg, variant=variant, device=cuda)[0].params
    exo = mk._pack_exo(traces, T)
    action_fn = mk.kernel_numerics_action_fn(net, cfg.cluster, params)
    loose = ("evictions", "queue_depth_mean", "interruptions",
             "spot_exposure", "waste_frac")
    before = mk.neural_megakernel_summary_from_packed.launches
    for horizon, stochastic in ((32, False), (T, True)):
        k = mk.neural_megakernel_summary_from_packed(
            params, cfg.cluster, net, exo, horizon, 4, stochastic=stochastic)
        short = type(traces)(*(x[:, :horizon] for x in traces))
        _, p = batched_rollout_summary(
            params, initial_state(cfg, B, cuda), action_fn, short, 4,
            stochastic=stochastic)
        if horizon == 32:
            for f in p._fields:
                a, b = getattr(k, f), getattr(p, f)
                rel = ((a - b).abs() / (b.abs() + 1e-6)).max().item()
                assert rel <= (2e-2 if f in loose else 1e-3), (f, rel)
        assert mk.mean_parity_violations(
            k, p, mk.NEURAL_MEAN_PARITY_TOLERANCES) == {}
    assert mk.neural_megakernel_summary_from_packed.launches == before + 2


def test_mlp_kernel_population_axis(cuda):
    cfg = PRESETS["multiregion"]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    B, T = 256, 96
    traces = src.batch_trace_device(
        T, torch.Generator(device=cuda).manual_seed(5), B, device=cuda)
    params = SimParams.from_config(cfg, device=cuda)
    net = load_flagship_backend(cfg, device=cuda)[0].params
    stacked = mk._tree_map(lambda x: np.stack([x, 0.5 * x, x]), net)
    before = mk.neural_megakernel_summary_from_packed.launches
    pop = mk.neural_megakernel_rollout_summary(
        params, cfg.cluster, stacked, traces, seed=4, device=cuda)
    assert mk.neural_megakernel_summary_from_packed.launches == before + 1
    single = mk.neural_megakernel_rollout_summary(
        params, cfg.cluster, net, traces, seed=4, device=cuda)
    assert tuple(pop.cost_usd.shape) == (3, B)
    for f in single._fields:
        assert torch.equal(getattr(pop, f)[0], getattr(single, f)), f
        assert torch.equal(getattr(pop, f)[2], getattr(single, f)), f
    assert not torch.equal(pop.cost_usd[1], pop.cost_usd[0])


def test_mlp_kernel_refuses_other_widths(cuda):
    cfg = PRESETS["default"]()
    params = SimParams.from_config(cfg, device=cuda)
    rng = np.random.default_rng(0)

    def dense(i, o):
        return {"kernel": rng.normal(size=(i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    net = {"params": {"Dense_0": dense(29, 64), "Dense_1": dense(64, 64),
                      "actor_mean": dense(64, 16)}}
    exo = torch.zeros((8, mk.exo_rows(3), 64), device=cuda)
    with pytest.raises(ValueError, match="hidden width 128"):
        mk.neural_megakernel_summary_from_packed(params, cfg.cluster, net,
                                                 exo, 8, stochastic=False)


def _lane_world(cuda, preset: str):
    from ccka_tpu_torch.config import FAULT_PRESETS, WorkloadsConfig

    cfg = PRESETS[preset]()
    zero = WorkloadsConfig(enabled=True, inference_rate_pods=0.0,
                           batch_rate_pods=0.0, background_rate_pods=0.0)
    net = load_flagship_backend(
        cfg, variant="" if cfg.cluster.regions else "replay",
        device=cuda)[0].params
    params = SimParams.from_config(cfg, device=cuda)
    off, peak = offpeak_action(cfg.cluster, cuda), peak_action(cfg.cluster,
                                                               cuda)
    entries = {
        "rule": lambda p, s, T, st: mk.megakernel_summary_from_packed(
            p, off, peak, s, T, seed=4, stochastic=st),
        "carbon": lambda p, s, T, st: mk.carbon_megakernel_summary_from_packed(
            p, off, peak, s, T, seed=4, stochastic=st),
        "mlp": lambda p, s, T, st: mk.neural_megakernel_summary_from_packed(
            p, cfg.cluster, net, s, T, seed=4, stochastic=st),
    }

    def stream(T, B, **kw):
        return SyntheticSignalSource(
            cfg.cluster, cfg.workload, cfg.sim, cfg.signals, **kw
        ).packed_trace_device(T, 6, B, device=cuda)

    return cfg, params, entries, stream, FAULT_PRESETS, zero


def _lane_plain(cuda, cfg, params, policy, packed, T, stochastic):
    """The plain rollout on the card with the stream's lanes threaded
    through, under ``policy``'s action function."""
    from ccka_tpu_torch.faults.process import unpack_fault_lanes
    from ccka_tpu_torch.sim.lanes import resolve_layout
    from ccka_tpu_torch.workloads.process import unpack_workload_lanes

    Z = cfg.cluster.n_zones
    layout = resolve_layout(packed.shape[1], Z)
    action_fn = {
        "rule": lambda: RulePolicy(cfg.cluster, cuda).action_fn(),
        "carbon": lambda: CarbonAwarePolicy(cfg.cluster,
                                            device=cuda).action_fn(),
        "mlp": lambda: mk.kernel_numerics_action_fn(
            load_flagship_backend(cfg, device=cuda)[0].params, cfg.cluster,
            params)}[policy]()
    return batched_rollout_summary(
        params, initial_state(cfg, packed.shape[2], cuda), action_fn,
        mk.unpack_exo(packed, T, Z), 4, stochastic=stochastic,
        faults=(unpack_fault_lanes(packed, T, Z) if layout.has("faults")
                else None),
        workloads=(unpack_workload_lanes(packed, T, Z)
                   if layout.has("workloads") else None))[1]


@pytest.mark.parametrize("preset", ["default", "multiregion"])
@pytest.mark.parametrize("policy", ["rule", "carbon", "mlp"])
def test_zero_lane_gates_are_bitwise(cuda, preset, policy):
    """The FAULTS kernels on neutral ("off") lanes and the WL_D kernels on
    zero arrivals give, bitwise, the plain-stream kernel's result (the
    five family fields 0 and, on faults, denials and stale ticks 0)."""
    cfg, params, entries, stream, presets, zero = _lane_world(cuda, preset)
    T, B = 288, 1024
    run = entries[policy]
    for stochastic in (False, True):
        plain = run(params, stream(T, B), T, stochastic)
        for kw in ({"faults": presets["off"]}, {"workloads": zero},
                   {"faults": presets["off"], "workloads": zero}):
            got = run(params, stream(T, B, **kw), T, stochastic)
            for f in plain._fields:
                assert torch.equal(getattr(got, f), getattr(plain, f)), (
                    kw, f)


@pytest.mark.parametrize("scenario", ["severe", "mixed"])
@pytest.mark.parametrize("policy", ["rule", "carbon", "mlp"])
def test_widened_kernels_match_plain_version(cuda, scenario, policy):
    """One widened instantiation per kernel (faults; faults + workloads,
    D = 16) against the plain rollout with the lanes threaded through:
    deterministic per cluster, stochastic by batch means."""
    import dataclasses

    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    scenario_source)

    cfg, params, entries, stream, presets, _ = _lane_world(cuda,
                                                           "multiregion")
    T, B = 288, 512
    if scenario == "severe":
        packed = stream(T, B, faults=presets["severe"])
    else:
        sc = WORKLOAD_SCENARIOS["mixed"]
        packed = scenario_source(cfg, sc).packed_trace_device(T, 6, B,
                                                              device=cuda)
        params = SimParams.from_config(
            dataclasses.replace(cfg, workloads=sc.workloads), device=cuda)
    run = entries[policy]
    tol = mk.NEURAL_MEAN_PARITY_TOLERANCES if policy == "mlp" else None
    for stochastic in (False, True):
        k = run(params, packed, T, stochastic)
        p = _lane_plain(cuda, cfg, params, policy, packed, T, stochastic)
        agree = torch.ones(B, dtype=torch.bool, device=cuda)
        for f in p._fields:
            a, b = getattr(k, f), getattr(p, f)
            assert torch.isfinite(a).all(), f
            agree &= (a - b).abs() <= 2e-3 * (b.abs() + 1e-6)
        assert agree.double().mean().item() >= (0.99 if stochastic
                                                else 0.999)
        assert mk.mean_parity_violations(k, p, tol) == {}


def test_kernel_refuses_unbuilt_deadline(cuda):
    import dataclasses

    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    scenario_source)

    cfg = PRESETS["default"]()
    wl = dataclasses.replace(WORKLOAD_SCENARIOS["flash-crowd"].workloads,
                             batch_deadline_ticks=6)
    params = SimParams.from_config(dataclasses.replace(cfg, workloads=wl),
                                   device=cuda)
    sc = dataclasses.replace(WORKLOAD_SCENARIOS["flash-crowd"], workloads=wl)
    exo = scenario_source(cfg, sc).packed_trace_device(8, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="batch deadlines"):
        mk.megakernel_summary_from_packed(
            params, offpeak_action(cfg.cluster, cuda),
            peak_action(cfg.cluster, cuda), exo, 8, stochastic=False)
