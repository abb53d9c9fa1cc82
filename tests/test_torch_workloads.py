"""The port's workload families against the JAX package on the same
inputs: the scenario library, the latent-to-lane transform fed JAX's own
latents (with per-trace clock offsets), the step's workload branch, and
the rollout of the rule, carbon and learned policies on JAX's own
workload-widened streams (``flash-crowd``; ``mixed`` also carries mild
fault lanes), against the JAX lax path and the interpret-mode kernels, at
the JAX package's standard ``rtol=3e-4, atol=1e-4``
(`tests/test_workloads.py::TestKernelLaxWorkloadParity`)."""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu_torch.config as tcfg
from ccka_tpu.faults import FaultStep as JFaultStep
from ccka_tpu.faults.process import unpack_fault_lanes as junpack_faults
from ccka_tpu.policy import CarbonAwarePolicy as JCarbonAwarePolicy
from ccka_tpu.policy import RulePolicy as JRulePolicy
from ccka_tpu.policy.rule import offpeak_action as joff
from ccka_tpu.policy.rule import peak_action as jpeak
from ccka_tpu.signals.synthetic import _ar1_device as jar1
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim.dynamics import ExoStep as JExoStep
from ccka_tpu.sim.dynamics import step as jstep
from ccka_tpu.sim.rollout import batched_rollout_summary as jrollout
from ccka_tpu.sim.types import Action as JAction
from ccka_tpu.sim.types import ClusterState as JClusterState
from ccka_tpu.workloads import WORKLOAD_SCENARIOS as JSCENARIOS
from ccka_tpu.workloads import WorkloadState as JWorkloadState
from ccka_tpu.workloads import WorkloadStep as JWorkloadStep
from ccka_tpu.workloads import scenario_source as jscenario_source
from ccka_tpu.workloads import unpack_workload_lanes as junpack_workloads
from ccka_tpu.workloads.process import WORKLOAD_KEY_TAG
from ccka_tpu.workloads.process import \
    packed_workload_lanes as jpacked_workload_lanes
from ccka_tpu_torch import bridge
from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim.dynamics import ExoStep, step
from ccka_tpu_torch.sim.types import ClusterState, SimParams
from ccka_tpu_torch.workloads.process import (has_workload_lanes,
                                              sample_workload_steps,
                                              unpack_workload_lanes,
                                              workload_lanes_from_latents)
from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS, Scenario,
                                                resolve_scenarios,
                                                scenario_source)
from ccka_tpu_torch.workloads.types import WorkloadState, WorkloadStep
from test_torch_faults import (KERNEL_KW, TIGHT, _random_step_inputs, _rel,
                               _worst)

PRESET_NAMES = ("default", "multiregion")
STEPS, B, T_CHUNK = 48, 16, 8


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def test_scenario_library_matches_jax():
    assert list(WORKLOAD_SCENARIOS) == list(JSCENARIOS)
    for name, sc in WORKLOAD_SCENARIOS.items():
        sc.validate()
        assert sc.to_doc() == JSCENARIOS[name].to_doc(), name
        assert sc.family_mix() == JSCENARIOS[name].family_mix()
        assert not sc.minted
    assert list(resolve_scenarios(["mixed", "flash-crowd"])) == [
        "mixed", "flash-crowd"]
    with pytest.raises(ValueError, match="unknown scenarios"):
        resolve_scenarios(["mixed", "typo"])
    with pytest.raises(ValueError, match="no scenarios"):
        resolve_scenarios([])
    minted = Scenario(name="cell", description="",
                      workloads=WORKLOAD_SCENARIOS["mixed"].workloads,
                      params_json="{}", params_digest="0" * 64)
    with pytest.raises(ValueError, match="tampered"):
        minted.validate()


class _Streams:
    """JAX's packed streams of one preset on one key, as numpy: plain,
    and the flash-crowd and mixed scenarios; both packages' params, each
    scenario's under its own WorkloadsConfig."""

    def __init__(self, preset: str):
        self.jc = jcfg.PRESETS[preset]()
        self.tc = tcfg.PRESETS[preset]()
        self.Z = self.jc.cluster.n_zones
        self.key = jax.random.key(5)
        self.j, self.jp, self.tp = {}, {}, {}
        for name in ("flash-crowd", "mixed"):
            sc = JSCENARIOS[name]
            self.j[name] = jscenario_source(self.jc, sc).packed_trace_device(
                STEPS, self.key, B, t_chunk=T_CHUNK)
            self.jp[name] = JSimParams.from_config(
                dataclasses.replace(self.jc, workloads=sc.workloads))
            self.tp[name] = bridge.sim_params(_np(self.jp[name]), "cpu")

    def t(self, name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(self.j[name]))

    def jax_lax(self, name: str, action_fn, T: int = STEPS):
        stream = self.j[name]
        states = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                              jinitial_state(self.jc))
        faults = (junpack_faults(stream, T, self.Z)
                  if name == "mixed" else None)
        return jrollout(self.jp[name], states, action_fn,
                        jmk.unpack_exo(stream, T, self.Z),
                        jax.random.split(jax.random.key(0), B),
                        stochastic=False, faults=faults,
                        workloads=junpack_workloads(stream, T, self.Z))[1]


@pytest.fixture(scope="module", params=PRESET_NAMES)
def streams(request):
    return _Streams(request.param)


def _jax_latents(key, wl, steps, batch):
    """The five latents JAX's `packed_workload_lanes` draws, from its own
    keys."""
    ki, kif, kb, kbf, kg = jax.random.split(
        jax.random.fold_in(key, WORKLOAD_KEY_TAG), 5)
    shape = (steps, batch)

    def window(k, mean):
        return jar1(k, shape, rho=math.exp(-1.0 / max(mean, 1)), sigma=1.0,
                    axis=0)

    return tuple(torch.from_numpy(np.array(x)) for x in jax.jit(
        lambda: (jar1(ki, shape, rho=0.9, sigma=0.2, axis=0),
                 window(kif, wl.inference_flash_mean_ticks),
                 jar1(kb, shape, rho=0.85, sigma=0.3, axis=0),
                 window(kbf, wl.batch_burst_mean_ticks),
                 jar1(kg, shape, rho=0.9, sigma=0.2, axis=0)))())


@pytest.mark.parametrize("scenario", list(WORKLOAD_SCENARIOS))
def test_lanes_from_jax_latents(scenario):
    """JAX's latents through the port's transform give JAX's
    `packed_workload_lanes` block within 1e-6, on the synthetic clock and
    with per-trace offsets into a wrapped store at epoch scale."""
    jwl = JSCENARIOS[scenario].workloads
    twl = WORKLOAD_SCENARIOS[scenario].workloads
    key, Z, T = jax.random.key(9), 4, 64
    lat = _jax_latents(key, jwl, T, B)
    offsets = np.random.default_rng(2).uniform(0, 3e5, B).astype(np.float32)
    for kw in ({}, dict(start_unix_s=1.7e9 + 1234.0, start_offset_s=offsets,
                        wrap_period_s=2.5e5)):
        want = jpacked_workload_lanes(jwl, key, T, 72, Z, B, dt_s=30.0, **kw)
        got = workload_lanes_from_latents(twl, lat, T, 72, Z, dt_s=30.0, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
        assert float(got[:T, :3].max()) > 0
        print(f"\n# workload lanes {scenario} {sorted(kw) or 'clock'}: "
              f"{_rel(got.numpy(), want)}")


def test_widened_streams_keep_exo_and_fault_rows_bitwise():
    """The port's synthesis: workload lanes draw from their own
    generator, so exo rows (and a scenario's fault rows) are bitwise those
    of the narrower stream on the same seed; zero rates give zero lanes;
    `mixed` carries faults and workloads in the JAX layout."""
    c = tcfg.PRESETS["multiregion"]()
    Z = c.cluster.n_zones
    base = lanes.exo_rows(Z)

    def stream(**kw):
        return SyntheticSignalSource(
            c.cluster, c.workload, c.sim, c.signals, **kw
        ).packed_trace_device(40, 11, 6, device="cpu")

    plain = stream()
    mixed = scenario_source(c, WORKLOAD_SCENARIOS["mixed"]) \
        .packed_trace_device(40, 11, 6, device="cpu")
    mild = stream(faults=tcfg.FAULT_PRESETS["mild"])
    assert mixed.shape[1] == base + lanes.fault_rows(Z) \
        + lanes.workload_rows(Z)
    assert torch.equal(mixed[:, :mild.shape[1]], mild)
    assert torch.equal(mild[:, :base], plain)
    assert has_workload_lanes(mixed, Z) and not has_workload_lanes(mild, Z)
    wl = unpack_workload_lanes(mixed, 40, Z)
    assert float(wl.inf_arrivals.min()) >= 0 and float(
        wl.batch_arrivals.max()) > 0
    zero = tcfg.WorkloadsConfig(enabled=True, inference_rate_pods=0.0,
                                batch_rate_pods=0.0,
                                background_rate_pods=0.0)
    z = stream(workloads=zero)
    assert torch.equal(z[:, :base], plain)
    assert float(z[:, base:].abs().max()) == 0.0
    one = sample_workload_steps(WORKLOAD_SCENARIOS["flash-crowd"].workloads,
                                torch.Generator().manual_seed(3), 32, Z)
    assert tuple(one.inf_arrivals.shape) == (32,)
    with pytest.raises(ValueError, match="no workload lanes"):
        unpack_workload_lanes(plain, 40, Z)


@pytest.mark.parametrize("preset,depth", [("default", 16),
                                          ("multiregion", 6)])
def test_step_with_workloads_matches_jax(preset, depth):
    """Random states, actions, signals, faults, arrivals and queues, one
    deterministic step: every state, metric and queue field within 1e-6
    relative of JAX's `step(fault=, workload=, wl_state=)`, vmapped, or
    1e-5 absolute: the queues subtract from a headroom of ~100 pods that
    JAX sums over (zone, type) in another order, so one ulp of it (7.6e-6)
    can show in a small difference (measured 3.8e-6 and 7.6e-6)."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    jc = dataclasses.replace(jc, workloads=dataclasses.replace(
        jc.workloads, batch_deadline_ticks=depth, inference_queue_max=16.0))
    P, Z, K = jc.cluster.n_pools, jc.cluster.n_zones, \
        jc.sim.provision_delay_steps
    rng = np.random.default_rng(11)
    state, action, exo, fault = _random_step_inputs(rng, 64, P, Z, K)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    arrivals = dict(inf_arrivals=30 * f(64), batch_arrivals=20 * f(64),
                    bg_arrivals=10 * f(64))
    backlog = 8 * f(64, depth)
    backlog[:, -1] = 0.0
    queues = dict(inf_queue=20 * f(64), batch_backlog=backlog,
                  bg_backlog=10 * f(64))
    jp = JSimParams.from_config(jc)
    js, jm, jw = jax.vmap(lambda s, a, e, fl, w, q: jstep(
        jp, s, a, e, jax.random.key(0), fault=fl, workload=w, wl_state=q))(
        JClusterState(**state), JAction(**action), JExoStep(**exo),
        JFaultStep(**fault), JWorkloadStep(**arrivals),
        JWorkloadState(**queues))
    ts, tm, tw = step(
        bridge.sim_params(_np(jp), "cpu"),
        ClusterState(**{k: torch.tensor(v) for k, v in state.items()}),
        bridge.action(action, "cpu"),
        ExoStep(**{k: torch.tensor(v) for k, v in exo.items()}),
        fault=bridge.fault_step(fault, "cpu"),
        workload=bridge.workload_step(arrivals, "cpu"),
        wl_state=WorkloadState(**{k: torch.tensor(v)
                                  for k, v in queues.items()}))
    pairs = ([(f"state.{k}", getattr(ts, k), getattr(js, k))
              for k in js._fields]
             + [(k, getattr(tm, k), getattr(jm, k)) for k in jm._fields]
             + [(f"wl.{k}", getattr(tw, k), getattr(jw, k))
                for k in jw._fields])
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, rtol=1e-6, atol=1e-5)
    print("\n# step(workload=), worst field: " + max(
        (_rel(got.numpy(), want) + f" ({name})"
         for name, got, want in pairs),
        key=lambda r: float(r.split()[1].rstrip(","))))
    for k in ("inf_slo_violation", "inf_dropped", "batch_deadline_miss",
              "batch_served"):
        assert float(getattr(tm, k).max()) > 0, k


@pytest.mark.parametrize("stochastic", [False, True])
def test_zero_arrivals_leave_the_program_bitwise(stochastic):
    """The zero-workload gate, step half: empty queues and no arrivals
    leave every state and shared metric field bitwise the step without
    workloads, and the family metrics 0; half the pair raises."""
    from ccka_tpu_torch.sim.random import uniforms
    from ccka_tpu_torch.sim.types import Action

    c = tcfg.PRESETS["default"]()
    P, Z, K = c.cluster.n_pools, c.cluster.n_zones, c.sim.provision_delay_steps
    state, action, exo, _ = _random_step_inputs(
        np.random.default_rng(8), 32, P, Z, K)
    params = SimParams.from_config(c, device="cpu")
    args = (params,
            ClusterState(**{k: torch.tensor(v) for k, v in state.items()}),
            Action(**{k: torch.tensor(v) for k, v in action.items()}),
            ExoStep(**{k: torch.tensor(v) for k, v in exo.items()}),
            uniforms(3, torch.arange(32)[:, None], 5,
                     torch.arange(P * Z)[None, :]).reshape(3, 32, P, Z)
            if stochastic else None)
    s1, m1 = step(*args, stochastic=stochastic)
    s2, m2, w2 = step(*args, stochastic=stochastic,
                      workload=WorkloadStep.neutral("cpu"),
                      wl_state=WorkloadState.zero(16, 32, "cpu"))
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    for f in m1._fields:
        if f.startswith(("inf_", "batch_", "bg_")):
            assert float(getattr(m2, f).abs().max()) == 0.0, f
        else:
            assert torch.equal(getattr(m1, f), getattr(m2, f)), f
    assert all(float(x.abs().max()) == 0.0 for x in w2)
    with pytest.raises(ValueError, match="both workload"):
        step(*args, stochastic=stochastic,
             workload=WorkloadStep.neutral("cpu"))


class TestRolloutOnJaxStreams:
    """The port's plain rollout on JAX's own workload-widened streams,
    deterministic, per cluster and field."""

    @pytest.mark.parametrize("name", ["flash-crowd", "mixed"])
    def test_rule_matches_jax_lax_and_interpret_kernel(self, streams, name):
        """Against the JAX lax path, and on the multiregion mixed stream
        (faults and workloads) also against the interpret-mode kernel."""
        s = streams
        port = mk.megakernel_summary_from_packed(
            s.tp[name], offpeak_action(s.tc.cluster, "cpu"),
            peak_action(s.tc.cluster, "cpu"), s.t(name), STEPS, seed=3,
            stochastic=False)
        worst = _worst(port, s.jax_lax(name,
                                       JRulePolicy(s.jc.cluster).action_fn()))
        if name == "mixed" and s.jc.cluster.regions:
            kern = jmk.megakernel_summary_from_packed(
                s.jp[name], joff(s.jc.cluster), jpeak(s.jc.cluster),
                s.j[name], STEPS, seed=3, **KERNEL_KW)
            worst = max(worst, _worst(port, kern))
        print(f"\n# rule {name}: worst {worst:.3g} of the standard")
        assert worst <= 1.0, worst
        assert float(port.inf_slo_violations.sum()) > 0
        assert float(port.inf_queue_mean.sum()) > 0

    def test_carbon_matches_jax_on_mixed(self, streams):
        s = streams
        port = mk.carbon_megakernel_summary_from_packed(
            s.tp["mixed"], offpeak_action(s.tc.cluster, "cpu"),
            peak_action(s.tc.cluster, "cpu"), s.t("mixed"), STEPS, seed=3,
            stochastic=False)
        worst = _worst(port, s.jax_lax(
            "mixed", JCarbonAwarePolicy(s.jc.cluster).action_fn()))
        print(f"\n# carbon mixed: worst {worst:.3g} of the standard")
        assert worst <= 1.0, worst

    def test_zero_rate_workloads_are_the_plain_program(self, streams):
        """The zero-workload gate, rollout half (the port's synthesis):
        with every rate 0 the entries give the plain stream's result
        bitwise on the core fields, in both modes, and 0 on the five
        family fields."""
        s = streams
        c = s.tc
        zero = tcfg.WorkloadsConfig(enabled=True, inference_rate_pods=0.0,
                                    batch_rate_pods=0.0,
                                    background_rate_pods=0.0)

        def stream(**kw):
            return SyntheticSignalSource(
                c.cluster, c.workload, c.sim, c.signals, **kw
            ).packed_trace_device(STEPS, 4, B, device="cpu")

        plain, widened = stream(), stream(workloads=zero)
        params = SimParams.from_config(c, device="cpu")
        off, peak = offpeak_action(c.cluster, "cpu"), peak_action(
            c.cluster, "cpu")
        for stochastic in (False, True):
            a = mk.carbon_megakernel_summary_from_packed(
                params, off, peak, plain, STEPS, seed=4,
                stochastic=stochastic)
            b = mk.carbon_megakernel_summary_from_packed(
                params, off, peak, widened, STEPS, seed=4,
                stochastic=stochastic)
            for f in a._fields:
                if f.startswith(("inf_", "batch_")):
                    assert float(getattr(b, f).abs().max()) == 0.0, f
                else:
                    assert torch.equal(getattr(a, f), getattr(b, f)), f
