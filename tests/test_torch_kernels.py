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
from ccka_tpu_torch.signals.base import ExogenousTrace
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


@pytest.mark.parametrize("preset,variant", [("default", "replay"),
                                            ("multiregion", "")])
def test_mlp_forward_entry_holds_its_standard(cuda, preset, variant):
    """The kernel's forward (`ccka_mlp_forward`) on the observations of a
    plain rollout's states (B = 300, a ragged last warp) at
    `check_mlp_forward`'s standard: each pre-activation within the sum
    bound, x, the epilogues and the head bitwise given the kernel's own
    inputs; every sum within the near-tie window and h1, h2, u wholly
    bitwise the plain forward (`mlp_forward_departures`); one launch
    counted."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.base import observe

    cfg = PRESETS[preset]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    B, T = 300, 12
    traces = src.batch_trace_device(
        T, torch.Generator(device=cuda).manual_seed(7), B, device=cuda)
    params = SimParams.from_config(cfg, device=cuda)
    net = load_flagship_backend(cfg, variant=variant, device=cuda)[0].params
    plain = mk.kernel_numerics_action_fn(net, cfg.cluster, params)
    seen = {}

    def action_fn(state, exo, t):
        seen[t] = observe(params, state, exo).flatten()
        return plain(state, exo, t)

    batched_rollout_summary(params, initial_state(cfg, B, cuda), action_fn,
                            traces, 4, stochastic=True)
    weights = mk._pack_mlp_tensors(net, cuda)
    before = build.launch_mlp_forward.launches
    got = mk.mlp_forward(seen[T - 1].contiguous(), weights)
    assert build.launch_mlp_forward.launches == before + 1
    rep = mk.check_mlp_forward(got, seen[T - 1], weights)
    assert set(rep["violations"].values()) == {0}, rep
    assert mk.mlp_forward_departures(rep) == {}, rep


@pytest.mark.parametrize("stream", ["plain", "severe", "flash-crowd",
                                    "mixed"])
@pytest.mark.parametrize("preset", ["default", "multiregion"])
def test_mlp_instantiations_are_deterministic(cuda, preset, stream):
    """Two launches of each MLP instantiation on the same inputs (both
    modes, non-carry and CARRY) are bitwise each other: the tensor-core
    torso adds in a fixed order."""
    cfg = PRESETS[preset]()
    src, pcfg = _stream_source(cfg, stream)
    params = SimParams.from_config(pcfg, device=cuda)
    net = load_flagship_backend(
        cfg, variant="" if cfg.cluster.regions else "replay",
        device=cuda)[0].params
    B, T = 288, 32
    packed = src.packed_trace_device(T, 5, B, device=cuda)
    for stochastic in (False, True):
        runs = [mk.neural_megakernel_summary_from_packed(
            params, cfg.cluster, net, packed, T, 3, stochastic=stochastic)
            for _ in range(2)]
        for f in runs[0]._fields:
            assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        fns = mk.packed_mode_block_summary_fn(
            params, cfg.cluster, "neural", T=T, block_T=T, t_chunk=16,
            stochastic=stochastic, net_params=net)
        state = fns.init_state(packed.shape[1], B, device=cuda)
        outs = [fns.step(packed, state, 0, 3,
                         state_out=torch.zeros_like(state))[1]
                for _ in range(2)]
        assert torch.equal(outs[0], outs[1])


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


def _random_plan(cfg, B, T, T_pad, device, seed=3):
    from ccka_tpu_torch.models.nets import latent_dim, latent_to_action

    g = torch.Generator(device=device).manual_seed(seed)
    lat = 0.3 * torch.randn((B, T, latent_dim(cfg.cluster)), generator=g,
                            device=device)
    return mk.pack_plan(latent_to_action(lat, cfg.cluster), T_pad)


def _plan_plain(cfg, params, plan, packed, T, stochastic, **lanes):
    Z = cfg.cluster.n_zones
    return batched_rollout_summary(
        params, initial_state(cfg, packed.shape[2], packed.device),
        mk.plan_action_fn(mk.unpack_plan(plan, T, cfg.cluster.n_pools, Z),
                          plan.dim() == 3),
        mk.unpack_exo(packed, T, Z), 4, stochastic=stochastic, **lanes)[1]


@pytest.mark.parametrize("preset", ["default", "multiregion"])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("form", ["per-cluster", "broadcast"])
def test_plan_kernel_is_bitwise_its_plain_version(cuda, preset, stochastic,
                                                  form):
    """The PLAN instantiation on a plain stream, B = 512 x T = 288: every
    field bitwise the plain rollout under the same plan, one launch."""
    cfg = PRESETS[preset]()
    params = SimParams.from_config(cfg, device=cuda)
    T, B = 288, 512
    packed = SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals).packed_trace_device(
        T, 6, B, device=cuda)
    plan = _random_plan(cfg, B, T, T, cuda)
    if form == "broadcast":
        plan = plan[..., 0].contiguous()
    before = mk.plan_megakernel_summary_from_packed.launches
    k = mk.plan_megakernel_summary_from_packed(params, cfg.cluster, plan,
                                               packed, T, seed=4,
                                               stochastic=stochastic)
    assert mk.plan_megakernel_summary_from_packed.launches == before + 1
    p = _plan_plain(cfg, params, plan, packed, T, stochastic)
    for f in p._fields:
        assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.parametrize("preset", ["default", "multiregion"])
def test_rule_equivalent_plan_is_bitwise_the_rule_kernel(cuda, preset):
    cfg = PRESETS[preset]()
    params = SimParams.from_config(cfg, device=cuda)
    off, peak = offpeak_action(cfg.cluster, cuda), peak_action(cfg.cluster,
                                                               cuda)
    T, B = 288, 512
    packed = SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals).packed_trace_device(
        T, 8, B, device=cuda)
    is_peak = mk.unpack_exo(packed, T, cfg.cluster.n_zones).is_peak > 0.5
    plan = mk.pack_plan(type(off)(*(
        torch.where(is_peak.reshape(B, T, *([1] * o.dim())), q, o)
        for o, q in zip(off, peak))), T)
    for stochastic in (False, True):
        k = mk.plan_megakernel_summary_from_packed(
            params, cfg.cluster, plan, packed, T, seed=4,
            stochastic=stochastic)
        want = mk.megakernel_summary_from_packed(
            params, off, peak, packed, T, seed=4, stochastic=stochastic)
        for f in want._fields:
            assert torch.equal(getattr(k, f), getattr(want, f)), f


@pytest.mark.parametrize("scenario", ["severe", "flash-crowd", "mixed"])
def test_plan_kernel_on_lane_streams(cuda, scenario):
    """The PLAN instantiations with fault lanes, workload lanes and both
    (multiregion, B = 512 x T = 288) bitwise the plain rollout with the
    lanes threaded through."""
    import dataclasses

    from ccka_tpu_torch.config import FAULT_PRESETS
    from ccka_tpu_torch.faults.process import unpack_fault_lanes
    from ccka_tpu_torch.workloads.process import unpack_workload_lanes
    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    scenario_source)

    cfg = PRESETS["multiregion"]()
    T, B, Z = 288, 512, cfg.cluster.n_zones
    if scenario == "severe":
        src, c2 = SyntheticSignalSource(
            cfg.cluster, cfg.workload, cfg.sim, cfg.signals,
            faults=FAULT_PRESETS["severe"]), cfg
    else:
        sc = WORKLOAD_SCENARIOS[scenario]
        src = scenario_source(cfg, sc)
        c2 = dataclasses.replace(cfg, workloads=sc.workloads)
    params = SimParams.from_config(c2, device=cuda)
    packed = src.packed_trace_device(T, 6, B, device=cuda)
    plan = _random_plan(cfg, B, T, T, cuda)
    faults = scenario != "flash-crowd"
    workloads = scenario != "severe"
    lanes = dict(
        faults=unpack_fault_lanes(packed, T, Z) if faults else None,
        workloads=unpack_workload_lanes(packed, T, Z) if workloads else None)
    from ccka_tpu_torch.kernels import build

    name = build.instantiation("plan", faults, 16 if workloads else 0)
    before = build.launch_rollout_plan.launches[name]
    for stochastic in (False, True):
        k = mk.plan_megakernel_summary_from_packed(
            params, cfg.cluster, plan, packed, T, seed=4,
            stochastic=stochastic)
        p = _plan_plain(cfg, params, plan, packed, T, stochastic, **lanes)
        for f in p._fields:
            assert torch.equal(getattr(k, f), getattr(p, f)), f
    assert build.launch_rollout_plan.launches[name] == before + 2


def test_graphed_planner_is_bitwise_the_eager_one(cuda):
    from ccka_tpu_torch.train import mpc

    cfg = PRESETS["multiregion"]()
    params = SimParams.from_config(cfg, device=cuda)
    N, T = 256, 48
    traces = mk.unpack_exo(SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals).packed_trace_device(
        T, 2, N, device=cuda), T, cfg.cluster.n_zones)
    lat0 = mpc.zero_latent(cfg.cluster, cuda)
    lat0 = lat0.expand(N, 8, *lat0.shape)
    got = [mpc.receding_horizon_plan_batch(
        params, cfg.cluster, cfg.train, initial_state(cfg, N, cuda), traces,
        lat0, horizon=8, replan_every=8, iters=2, graph=graph)
        for graph in (False, True)]
    assert torch.equal(got[0], got[1])
    assert float(got[0].abs().max()) > 1e-3


def test_plan_kernel_refuses_mismatched_plans(cuda):
    cfg = PRESETS["default"]()
    params = SimParams.from_config(cfg, device=cuda)
    exo = torch.zeros((64, mk.exo_rows(3), 128), device=cuda)
    plan = _random_plan(cfg, 128, 64, 64, cuda)
    for bad in (plan[:32], plan[:, :8], plan[..., :64],
                plan.cpu()):
        with pytest.raises(ValueError, match="plan"):
            mk.plan_megakernel_summary_from_packed(params, cfg.cluster, bad,
                                                   exo, 64, stochastic=False)


def _stream_source(cfg, name: str):
    """(source, SimParams config) of the plain stream or a lane stream."""
    import dataclasses

    from ccka_tpu_torch.config import FAULT_PRESETS
    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    scenario_source)

    if name in WORKLOAD_SCENARIOS:
        sc = WORKLOAD_SCENARIOS[name]
        return (scenario_source(cfg, sc),
                dataclasses.replace(cfg, workloads=sc.workloads))
    return SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals,
        faults=None if name == "plain" else FAULT_PRESETS[name]), cfg


@pytest.mark.parametrize("stream", ["plain", "severe", "flash-crowd",
                                    "mixed"])
@pytest.mark.parametrize("mode", ["rule", "carbon", "neural", "plan"])
def test_carry_kernels_are_bitwise_their_plain_version(cuda, mode, stream):
    """Each CARRY instantiation (multiregion B = 256, T = 45 in blocks of
    16, both modes): the carried state after every block bitwise its plain
    version's `pack_carry` (`plain_step`); the finalized last block
    bitwise the non-carry kernel on the concatenated blocks; the
    synchronous and double-buffered drives bitwise that too; launches
    counted under the CARRY instantiation."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.sim import streaming as stm

    cfg = PRESETS["multiregion"]()
    src, pcfg = _stream_source(cfg, stream)
    params = SimParams.from_config(pcfg, device=cuda)
    net = load_flagship_backend(cfg, device=cuda)[0].params
    plan = _random_plan(cfg, 256, 45, 48, cuda)
    blocks = [src.packed_block_trace_device(16, 3, 256, j, t_chunk=16,
                                            device=cuda) for j in range(3)]
    kw = dict(net_params=net if mode == "neural" else None,
              plan_packed=plan if mode == "plan" else None)
    counter = {"neural": build.launch_rollout_mlp,
               "plan": build.launch_rollout_plan}.get(
        mode, build.launch_rollout_profiles).launches
    for stochastic in (False, True):
        fns = mk.packed_mode_block_summary_fn(
            params, cfg.cluster, mode, T=45, block_T=16, t_chunk=16,
            stochastic=stochastic, **kw)
        state = fns.init_state(blocks[0].shape[1], 256, device=cuda)
        k_state, p_state = torch.zeros_like(state), torch.zeros_like(state)
        before = sum(v for k, v in counter.items() if "CARRY" in k)
        for j, blk in enumerate(blocks):
            fns.step(blk, state, j, 8, state_out=k_state)
            fns.plain_step(blk, state, j, 8, state_out=p_state)
            assert torch.equal(k_state, p_state), (mode, stream, j)
            state, p_state = p_state, state
        assert sum(v for k, v in counter.items() if "CARRY" in k) == \
            before + 3
        got = fns.finalize(k_state[..., :21, :])
        want = mk.packed_mode_summary(params, cfg.cluster, mode,
                                      torch.cat(blocks), 45, 8,
                                      stochastic=stochastic, **kw)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        drive = dict(key=3, batch=256, T=45, block_T=16, seed=8, t_chunk=16,
                     stochastic=stochastic, device=cuda, **kw)
        for pipelined in (False, True):
            s, rep = stm.streaming_rollout_summary(
                src, params, cfg.cluster, mode, pipelined=pipelined, **drive)
            for f in s._fields:
                assert torch.equal(getattr(s, f), getattr(want, f).cpu()), f
        assert rep["stream_buffers"] == 2


def test_carry_kernel_refuses_bad_states(cuda):
    from ccka_tpu_torch.kernels import build

    cfg = PRESETS["multiregion"]()
    params = SimParams.from_config(cfg, device=cuda)
    fns = mk.packed_mode_block_summary_fn(params, cfg.cluster, "rule", T=32,
                                          block_T=16, t_chunk=16)
    exo = torch.zeros((16, mk.exo_rows(4), 64), device=cuda)
    state = fns.init_state(exo.shape[1], 64, device=cuda)
    acts = np.zeros((2, 18), np.float32)
    kw = dict(P=2, Z=4, K=3, T=16, seed=0, stochastic=False)
    pnp = mk._pack_params(params).cpu().numpy().ravel()
    for bad, match in (
            (build.BlockCarry(state, state, 0), "another buffer"),
            (build.BlockCarry(state, state[:8].clone(), 0), "state_in"),
            (build.BlockCarry(state, state.clone(), -1), "non-negative")):
        with pytest.raises(ValueError, match=match):
            build.launch_rollout_profiles(None, exo, pnp, acts, carry=bad,
                                          **kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        short = state[:40].clone()
        build.launch_rollout_profiles(
            None, exo, pnp, acts, carry=build.BlockCarry(
                short, short.clone(), 0), **kw)


@pytest.mark.parametrize("B", [1, 17, 300])
@pytest.mark.parametrize("policy", ["rule", "carbon", "plan"])
def test_pair_kernel_ragged_fleets_are_bitwise(cuda, policy, B):
    """A cluster is a pair of lanes: fleets that end inside a warp and a
    block (multiregion B in {1, 17, 300} x T = 64, both modes). Each
    kernel bitwise its plain version; in CARRY blocks of 16 the carried
    state after every block bitwise the plain version's, the finalized
    last block bitwise the plain rollout."""
    cfg = PRESETS["multiregion"]()
    params = SimParams.from_config(cfg, device=cuda)
    T, block_T = 64, 16
    packed = SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals).packed_trace_device(
        T, 6, B, device=cuda)
    plan = _random_plan(cfg, B, T, T, cuda) if policy == "plan" else None
    for stochastic in (False, True):
        want = (_plan_plain(cfg, params, plan, packed, T, stochastic)
                if policy == "plan" else
                _lane_plain(cuda, cfg, params, policy, packed, T, stochastic))
        got = mk.packed_mode_summary(params, cfg.cluster, policy, packed, T,
                                     4, stochastic=stochastic,
                                     plan_packed=plan)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        fns = mk.packed_mode_block_summary_fn(
            params, cfg.cluster, policy, T=T, block_T=block_T,
            t_chunk=block_T, stochastic=stochastic, plan_packed=plan)
        state = fns.init_state(packed.shape[1], B, device=cuda)
        k_state, p_state = torch.zeros_like(state), torch.zeros_like(state)
        for j in range(T // block_T):
            blk = packed[j * block_T:(j + 1) * block_T].contiguous()
            fns.step(blk, state, j, 4, state_out=k_state)
            fns.plain_step(blk, state, j, 4, state_out=p_state)
            assert torch.equal(k_state, p_state), (policy, B, j)
            state, p_state = p_state, state
        got = fns.finalize(k_state[..., :21, :])
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_pair_kernel_default_fleet_past_a_block(cuda):
    """The main path's instantiation (default preset, rule, stochastic)
    on B = 4097 x T = 64: one pair in the last block, bitwise the plain
    rollout."""
    cfg = PRESETS["default"]()
    params = SimParams.from_config(cfg, device=cuda)
    T, B = 64, 4097
    packed = SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals).packed_trace_device(
        T, 6, B, device=cuda)
    got = mk.packed_mode_summary(params, cfg.cluster, "rule", packed, T, 4,
                                 stochastic=True)
    want = _lane_plain(cuda, cfg, params, "rule", packed, T, True)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- the trainers (slice 8) -------------------------------------------------


def test_trainer_entry_points_default_to_cuda(cuda):
    """With no device named, the trainers run on the card."""
    from ccka_tpu_torch.train.imitate import collect_dataset
    from ccka_tpu_torch.train.ppo import PPOTrainer

    cfg = PRESETS["multiregion"]()
    ts = PPOTrainer(cfg).init_state(0)
    assert ts.params["Dense_0.weight"].device.type == "cuda"
    assert ts.env_states.nodes.device.type == "cuda"
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    data = collect_dataset(cfg, CarbonAwarePolicy(cfg.cluster), src,
                           batch_clusters=4, steps=8)
    assert data.obs.device.type == "cuda"


def test_population_launch_bitwise_member_by_member(cuda):
    """A CEM generation's shape of population: 64 members in one MLP
    launch against each member launched alone on the same stream and
    seed, every field bitwise (the members share the worlds and the
    interruption draws)."""
    from ccka_tpu_torch.train.cem import _flatten, _unflatten

    cfg = PRESETS["multiregion"]()
    net = load_flagship_backend(cfg, device=cuda)[0].params
    flat, spec = _flatten(net, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    pop = flat[None] + 5e-3 * torch.randn((64, flat.shape[0]), device=cuda,
                                          generator=gen)
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    stream = src.packed_trace_device(288, 3, 256, device=cuda)
    params = SimParams.from_config(cfg, device=cuda)
    both = mk.neural_megakernel_summary_from_packed(
        params, cfg.cluster, _unflatten(pop, spec), stream, 288, 9)
    for m in range(64):
        one = mk.neural_megakernel_summary_from_packed(
            params, cfg.cluster, _unflatten(pop[m], spec), stream, 288, 9)
        for f in one._fields:
            assert torch.equal(getattr(both, f)[m], getattr(one, f)), (m, f)


def test_graphed_replan_is_bitwise_the_eager_one_and_counted(cuda):
    """`MPCBackend.replan` on the card replays a captured graph of the
    planner: bitwise the eager optimization, one capture per geometry
    (counted under "mpc.replan"), none on a second replan."""
    from ccka_tpu_torch.obs.compile import stats_for
    from ccka_tpu_torch.train import mpc

    cfg = PRESETS["multiregion"]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals, start_unix_s=8 * 3600.0)
    backend = mpc.MPCBackend(cfg, horizon=8, iters=3, device=cuda)
    state = initial_state(cfg, 1, cuda)
    window = ExogenousTrace(*(x[None] for x in src.forecast(
        0, 8, device=cuda)))
    s0 = stats_for("mpc.replan")
    c0 = s0.compiles if s0 is not None else 0
    init = backend._plan.expand(1, *backend._plan.shape)
    want = mpc.optimize_plan_batch(backend.params, cfg.cluster, cfg.train,
                                   state, window, init, iters=3)
    got = backend.replan(state, window)
    assert torch.equal(got.plan_latent, want.plan_latent)
    assert torch.equal(got.losses, want.losses)
    again = mpc.optimize_plan_batch(backend.params, cfg.cluster, cfg.train,
                                    state, window, got.plan_latent, iters=3)
    assert torch.equal(backend.replan(state, window).plan_latent,
                       again.plan_latent)
    s = stats_for("mpc.replan")
    assert s.compiles == c0 + 1 and s.recompiles == 0


def test_controller_ticks_on_the_card_as_on_the_cpu(cuda):
    """The rule loop on the card: the command stream of the CPU run, its
    reports within 1e-5, and the estimate stage fenced."""
    from ccka_tpu_torch.actuation.sink import DryRunSink
    from ccka_tpu_torch.harness.controller import Controller
    from ccka_tpu_torch.obs.trace import SpanTracer

    cfg = PRESETS["multiregion"]()
    runs = {}
    for dev in ("cpu", cuda):
        src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                    cfg.signals, start_unix_s=8 * 3600.0)
        sink, tracer = DryRunSink(), SpanTracer()
        reports = Controller(cfg, RulePolicy(cfg.cluster, device=dev), src,
                             sink, device=dev, tracer=tracer,
                             interval_s=0.0, log_fn=lambda s: None).run(8)
        runs[str(dev)] = (reports, sink.rendered(), tracer)
    (rc, kc, _), (rg, kg, tg) = runs["cpu"], runs[str(cuda)]
    assert kc == kg
    for a, b in zip(rc, rg):
        assert a.profile == b.profile and a.slo_ok == b.slo_ok
        for f in ("cost_usd_hr", "carbon_g_hr", "nodes_spot", "nodes_od"):
            assert np.isclose(getattr(b, f), getattr(a, f), rtol=1e-5,
                              atol=1e-6), f
    assert all(sp.cat == "device" for sp in tg.spans()
               if sp.name == "estimate")


@pytest.mark.parametrize("backend", ["rule", "carbon", "ppo"])
def test_fleet_graph_is_bitwise_its_eager_body(cuda, backend):
    """The fleet tick captured as one CUDA graph gives bitwise what its
    eager body gives, tick after tick, and is captured once."""
    from ccka_tpu_torch.cli import make_backend
    from ccka_tpu_torch.harness.fleet import fleet_controller_from_config
    from ccka_tpu_torch.obs.compile import stats_for

    cfg = PRESETS["multiregion"]()
    ctrl = fleet_controller_from_config(
        cfg, make_backend(cfg, backend, device=cuda), 64, horizon_ticks=32,
        seed=3, device=cuda)
    tick, xs = ctrl._tick_fn, ctrl._xs_all
    s_e = s_g = ctrl.states
    before = stats_for("fleet.tick").compiles if stats_for(
        "fleet.tick") else 0
    for t in range(6):
        e, g = tick.eager(s_e, xs, t), tick(s_g, xs, t)
        assert torch.equal(e[0], g[0]) and torch.equal(e[2], g[2])
        assert all(torch.equal(a, b) for a, b in zip(e[1], g[1]))
        s_e, s_g = e[1], type(g[1])(*(x.clone() for x in g[1]))
    st = stats_for("fleet.tick")
    assert st.compiles == before + 1 and st.recompiles == 0
    reports = ctrl.run(3)
    assert all(r.applied == 64 for r in reports)
    ctrl.close()


@pytest.mark.parametrize("backend", ["rule", "carbon", "ppo"])
def test_service_graph_is_bitwise_its_eager_body(cuda, backend):
    """The service tick captured as one CUDA graph, whole-fleet and as
    one k-tenant chunk graph replayed per chunk, gives bitwise what its
    eager body gives on mixed fresh/held/fallback lanes; a chunked
    service run is bitwise the unchunked one; each graph is captured
    once and the stream is copied into it once."""
    from ccka_tpu_torch.cli import make_backend
    from ccka_tpu_torch.config import SERVICE_PRESETS
    from ccka_tpu_torch.harness.service import (VirtualClock, _rows,
                                                fleet_service_from_config)

    cfg = PRESETS["multiregion"]()
    b = make_backend(cfg, backend, device=cuda)
    mk_svc = dict(service=SERVICE_PRESETS["default"], horizon_ticks=32,
                  seed=3, device=cuda)
    whole = fleet_service_from_config(cfg, b, 64, **mk_svc)
    chunked = fleet_service_from_config(cfg, b, 64, dispatch_chunk=16,
                                        **mk_svc)
    g = torch.Generator().manual_seed(1)
    a = whole._held.shape[1]
    for t in range(4):
        lanes = torch.randint(0, 3, (64,), generator=g,
                              dtype=torch.int32).to(cuda)
        held = torch.rand((64, a), generator=g).to(cuda)
        st = whole.states
        e = whole._tick_fn.eager(st, whole._xs, t, lanes, held)
        gw = whole._tick_fn(st, whole._xs, t, lanes, held)
        assert torch.equal(e[0], gw[0]) and torch.equal(e[2], gw[2])
        assert all(torch.equal(x, y) for x, y in zip(e[1], gw[1]))
        for lo in range(0, 64, 16):
            rows = _rows(st, lo, lo + 16)
            ec = chunked._tick_fn.eager(rows, chunked._xs, t, lo,
                                        lanes[lo:lo + 16],
                                        held[lo:lo + 16])
            gc = chunked._tick_fn(rows, chunked._xs, t, lo,
                                  lanes[lo:lo + 16], held[lo:lo + 16])
            assert torch.equal(ec[0], gc[0]) and torch.equal(ec[2], gc[2])
            assert torch.equal(gc[0], e[0][lo:lo + 16])
            assert torch.equal(gc[2], e[2][lo:lo + 16])
    assert whole._tick_fn.captures == chunked._tick_fn.captures == 1
    assert chunked._tick_fn.stream_copies == 1
    runs = []
    for chunk in (None, 16):
        svc = fleet_service_from_config(
            cfg, b, 64, profiles=["healthy", "slow", "flaky", "batch"] * 16,
            clock=VirtualClock(base=lambda: 0.0), dispatch_chunk=chunk,
            **mk_svc)
        svc.warmup()
        reps = svc.run(6)
        runs.append(([r.admitted for r in reps], svc.tenant_cost_usd.copy(),
                     [x.cpu() for x in svc.states], svc._held.copy()))
        svc.close()
    (ra, ca, sa, ha), (rb, cb, sb, hb) = runs
    assert ra == rb and np.array_equal(ca, cb) and np.array_equal(ha, hb)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    whole.close()
    chunked.close()


def test_replay_samplers_on_the_card(cuda):
    """The replay device samplers on the card: the packed stream is the
    pack of its windows, the blocks concatenate to it."""
    from ccka_tpu_torch.signals.replay import ReplaySignalSource
    from ccka_tpu_torch.signals.synthetic import family_generator

    import os

    src = ReplaySignalSource.from_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
        "replay_train_9day.npz"))
    stream = src.packed_trace_device(360, 5, 256, device=cuda)
    windows = src.batch_trace_device(360, family_generator(5, None, cuda),
                                     256, device=cuda)
    assert torch.equal(stream, mk._pack_exo(windows, 360))
    blocks = [src.packed_block_trace_device(120, 5, 256, j, total_steps=360,
                                            t_chunk=40, device=cuda)
              for j in range(3)]
    assert torch.equal(torch.cat(blocks), stream)
    assert torch.equal(torch.cat(blocks), stream)


def test_replay_samplers_reuse_buffers_on_the_card(cuda):
    """A bare ``cuda`` device and a caller's ``out=`` buffer (``cuda:0``)
    name the same card: the samplers write into the buffer (as the CEM
    generations and the streaming pipeline reuse theirs) and hit the
    cached extension instead of tiling the store again."""
    from ccka_tpu_torch.signals.replay import ReplaySignalSource

    import os

    src = ReplaySignalSource.from_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
        "replay_train_9day.npz"))
    want = src.packed_trace_device(360, 5, 256, device=cuda)
    ext = src._ext_dev
    buf = torch.empty_like(want)
    got = src.packed_trace_device(360, 5, 256, out=buf, device=cuda)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(got, want)
    assert src._ext_dev is ext
    blk = torch.empty((120,) + tuple(want.shape[1:]), device=cuda)
    for j in range(3):
        got = src.packed_block_trace_device(120, 5, 256, j, total_steps=360,
                                            out=blk, t_chunk=40, device=cuda)
        assert got.data_ptr() == blk.data_ptr()
        assert torch.equal(got, want[120 * j:120 * (j + 1)])
        ext = ext if j else src._ext_dev  # sized once for the horizon
        assert src._ext_dev is ext
