"""The port's fault lanes against the JAX package on the same inputs: the
lane arithmetic, the latent-to-lane transform fed JAX's own latents, the
packed exo assembly, the step's fault branch, and the rollout of the
rule, carbon and learned policies on JAX's own fault-widened streams,
against the JAX lax path and the interpret-mode Pallas kernels.

Measured worst differences (printed with ``-s``) sit far inside the JAX
package's own standard for this comparison, ``rtol=3e-4, atol=1e-4``
(`tests/test_faults.py::TestKernelLaxFaultParity`)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.lanes as jlanes
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu_torch.config as tcfg
from ccka_tpu.faults import FaultStep as JFaultStep
from ccka_tpu.faults.process import FAULT_KEY_TAG as JFAULT_KEY_TAG
from ccka_tpu.faults.process import unpack_fault_lanes as junpack_faults
from ccka_tpu.policy import CarbonAwarePolicy as JCarbonAwarePolicy
from ccka_tpu.policy import RulePolicy as JRulePolicy
from ccka_tpu.policy.rule import offpeak_action as joff
from ccka_tpu.policy.rule import peak_action as jpeak
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.signals.synthetic import _ar1_device as jar1
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim.dynamics import ExoStep as JExoStep
from ccka_tpu.sim.dynamics import step as jstep
from ccka_tpu.sim.rollout import batched_rollout_summary as jrollout
from ccka_tpu.sim.types import Action as JAction
from ccka_tpu.sim.types import ClusterState as JClusterState
from ccka_tpu_torch import bridge
from ccka_tpu_torch.faults.process import (fault_lanes_from_latents,
                                           has_fault_lanes,
                                           sample_fault_steps,
                                           unpack_fault_lanes)
from ccka_tpu_torch.faults.types import FaultStep
from ccka_tpu_torch.policy import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim.dynamics import ExoStep, step
from ccka_tpu_torch.sim.random import uniforms
from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                        initial_state, observed_exo)
from ccka_tpu_torch.sim.types import Action, ClusterState, SimParams

PRESET_NAMES = ("default", "multiregion")
# tests/test_faults.py's sizes and interpret-mode grid.
STEPS, B, T_CHUNK = 48, 16, 8
KERNEL_KW = dict(stochastic=False, b_block=8, t_chunk=T_CHUNK,
                 interpret=True)
# The JAX package's kernel-vs-lax standard for widened streams.
STANDARD = dict(rtol=3e-4, atol=1e-4)
# Lanes from the same latents, and one step: float32 rounding only.
TIGHT = dict(rtol=1e-6, atol=1e-6)


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def _rel(got, want) -> str:
    """Largest absolute difference, and largest relative one where
    |want| > 1e-3."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    d = np.abs(a - b)
    big = np.abs(b) > 1e-3
    rel = float((d[big] / np.abs(b[big])).max()) if big.any() else 0.0
    return f"abs {float(d.max()):.3g}, rel {rel:.3g}"


def _worst(port, ref) -> float:
    """Largest |a - b| / (atol + rtol |b|) over fields and clusters, in
    units of STANDARD (<= 1 passes)."""
    worst = 0.0
    for f in ref._fields:
        a = getattr(port, f).detach().numpy().astype(np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        assert a.shape == b.shape, f
        ratio = np.abs(a - b) / (STANDARD["atol"]
                                 + STANDARD["rtol"] * np.abs(b))
        worst = max(worst, float(ratio.max()))
    return worst


@pytest.mark.parametrize("Z", range(1, 9))
def test_lane_arithmetic_matches_jax(Z):
    for f in ("exo_rows", "fault_rows", "workload_rows", "region_rows"):
        assert getattr(lanes, f)(Z) == getattr(jlanes, f)(Z), f
    for rows in range(0, 4 * lanes.region_rows(Z)):
        try:
            want = jlanes.resolve_layout(rows, Z)
        except ValueError:
            with pytest.raises(ValueError, match="expects one of"):
                lanes.resolve_layout(rows, Z)
            continue
        got = lanes.resolve_layout(rows, Z)
        assert got.families == want.families and got.offsets == want.offsets
        assert lanes.stream_layout(rows, Z) == jlanes.stream_layout(rows, Z)
        if want.has("workloads"):
            assert lanes.workload_base(rows, Z) == jlanes.workload_base(
                rows, Z)
    assert lanes.FAULT_KEY_TAG == JFAULT_KEY_TAG


class _Streams:
    """JAX's packed streams of one preset on one key (plain, "off",
    "severe"), as numpy, and the params of both packages."""

    def __init__(self, preset: str):
        self.jc = jcfg.PRESETS[preset]()
        self.tc = tcfg.PRESETS[preset]()
        self.Z = self.jc.cluster.n_zones
        self.jp = JSimParams.from_config(self.jc)
        self.tp = bridge.sim_params(_np(self.jp), device="cpu")
        self.key = jax.random.key(5)
        self.j = {name: self._jax_stream(preset_cfg) for name, preset_cfg in
                  (("plain", None), ("off", jcfg.FAULT_PRESETS["off"]),
                   ("severe", jcfg.FAULT_PRESETS["severe"]))}

    def _jax_stream(self, faults):
        src = JSource(self.jc.cluster, self.jc.workload, self.jc.sim,
                      self.jc.signals, faults=faults)
        return src.packed_trace_device(STEPS, self.key, B, t_chunk=T_CHUNK)

    def t(self, name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(self.j[name]))

    def jax_lax(self, name: str, action_fn):
        stream = self.j[name]
        traces = jmk.unpack_exo(stream, STEPS, self.Z)
        states = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                              jinitial_state(self.jc))
        return jrollout(self.jp, states, action_fn, traces,
                        jax.random.split(jax.random.key(0), B),
                        stochastic=False,
                        faults=junpack_faults(stream, STEPS, self.Z))[1]


@pytest.fixture(scope="module", params=PRESET_NAMES)
def streams(request):
    return _Streams(request.param)


def test_lanes_from_jax_latents(streams):
    """The latent-to-lane transform fed the latents JAX draws (its own
    keys, `split(fold_in(key, FAULT_KEY_TAG), 4)` and `_ar1_device`)
    gives JAX's severe `packed_fault_lanes` block within 1e-6."""
    s = streams
    cfg = jcfg.FAULT_PRESETS["severe"]
    jstream = s.j["severe"]

    @jax.jit
    def latents(key):
        ks, _, _ = jax.random.split(key, 3)
        price_dev = jar1(ks, (STEPS, s.Z, B), rho=0.97, sigma=0.04, axis=0)
        k4 = jax.random.split(jax.random.fold_in(key, JFAULT_KEY_TAG), 4)

        def window(k, mean):
            return jar1(k, (STEPS, B), rho=math.exp(-1.0 / max(mean, 1)),
                        sigma=1.0, axis=0)

        return (price_dev, window(k4[0], cfg.preempt_storm_mean_ticks),
                window(k4[1], cfg.ice_mean_ticks),
                jar1(k4[2], (STEPS, B), rho=0.8, sigma=1.0, axis=0),
                window(k4[3], cfg.outage_mean_ticks))

    price_dev, *lat = (torch.from_numpy(np.array(x)) for x in latents(s.key))
    got = fault_lanes_from_latents(
        tcfg.FAULT_PRESETS["severe"], tuple(lat), STEPS,
        jstream.shape[0], s.Z, price_dev=price_dev)
    base = jlanes.exo_rows(s.Z)
    np.testing.assert_allclose(got.numpy(), np.asarray(jstream[:, base:]),
                               **TIGHT)
    print(f"\n# fault lanes from JAX's latents: "
          f"{_rel(got.numpy(), jstream[:, base:])}")
    assert float(got[:STEPS, s.Z + 2].max()) == 1.0   # outages present


def test_assemble_packed_matches_jax(streams):
    """The packed exo assembly on JAX's own noise equals JAX's plain
    packed stream within 1e-6."""
    s = streams

    @jax.jit
    def noise(key):
        ks, kc, kd = jax.random.split(key, 3)
        return (jar1(ks, (STEPS, s.Z, B), rho=0.97, sigma=0.04, axis=0),
                jar1(kc, (STEPS, s.Z, B), rho=0.95, sigma=0.03, axis=0),
                jar1(kd, (STEPS, B), rho=0.9, sigma=0.5, axis=0))

    src = SyntheticSignalSource(s.tc.cluster, s.tc.workload, s.tc.sim,
                                s.tc.signals)
    got = src._assemble_packed(
        STEPS, s.j["plain"].shape[0],
        tuple(torch.from_numpy(np.array(x)) for x in noise(s.key)))
    np.testing.assert_allclose(got.numpy(), np.asarray(s.j["plain"]), **TIGHT)
    print(f"\n# packed assembly: {_rel(got.numpy(), s.j['plain'])}")


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_widened_stream_keeps_exo_rows_bitwise(preset):
    """The port's own synthesis: the fault block draws from its own
    generator, so the exo rows of a widened stream are bitwise those of
    the plain stream on the same seed; "off" lanes are exactly neutral;
    a disabled config adds no lanes."""
    c = tcfg.PRESETS[preset]()
    Z = c.cluster.n_zones

    def stream(faults):
        return SyntheticSignalSource(
            c.cluster, c.workload, c.sim, c.signals,
            faults=faults).packed_trace_device(40, 11, 6, t_pad=48,
                                               device="cpu")

    plain = stream(None)
    assert tuple(plain.shape) == (48, lanes.exo_rows(Z), 6)
    assert torch.equal(stream(tcfg.FaultsConfig(enabled=False)), plain)
    base = lanes.exo_rows(Z)
    for name in ("off", "severe"):
        s = stream(tcfg.FAULT_PRESETS[name])
        assert s.shape[1] == base + lanes.fault_rows(Z)
        assert torch.equal(s[:, :base], plain)
        assert has_fault_lanes(s, Z)
    off = stream(tcfg.FAULT_PRESETS["off"])[:40, base:]
    assert bool((off[:, :Z] == 1.0).all()) and bool((off[:, Z:] == 0).all())
    sev = unpack_fault_lanes(stream(tcfg.FAULT_PRESETS["severe"]), 40, Z)
    assert float(sev.preempt_hazard.min()) >= 1.0
    assert float(sev.preempt_hazard.max()) > 1.0
    assert 0.0 <= float(sev.deny_frac.min()) <= float(sev.deny_frac.max()) \
        <= 1.0
    assert float(sev.delay_frac.max()) <= 0.9
    assert not has_fault_lanes(plain, Z)
    with pytest.raises(ValueError, match="no fault lanes"):
        unpack_fault_lanes(plain, 40, Z)
    one = sample_fault_steps(tcfg.FAULT_PRESETS["off"],
                             torch.Generator().manual_seed(3), 16, Z)
    assert tuple(one.preempt_hazard.shape) == (16, Z)
    assert bool((one.preempt_hazard == 1.0).all())


def _random_step_inputs(rng, n, P, Z, K):
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    state = dict(
        nodes=0.3 * f(n, P, Z, 2), pipeline=0.1 * f(n, K, P, Z, 2),
        running=30.0 * f(n, 2), consol_timer_s=120.0 * f(n, P),
        time_s=3000.0 * f(n), acc_cost_usd=f(n), acc_carbon_g=100 * f(n),
        acc_requests=1e3 * f(n), acc_slo_ok_s=600 * f(n),
        acc_evictions=f(n))
    action = dict(zone_weight=f(n, P, Z), ct_allow=f(n, P, 2),
                  consolidation_aggr=f(n, P),
                  consolidate_after_s=300.0 * f(n, P),
                  hpa_scale=0.5 + f(n, 2))
    exo = dict(spot_price_hr=0.02 + 0.06 * f(n, Z),
               od_price_hr=np.full((n, Z), 0.096, np.float32),
               carbon_g_kwh=200 + 300 * f(n, Z),
               demand_pods=np.round(100.0 * f(n, 2)),
               is_peak=np.round(f(n)))
    fault = dict(preempt_hazard=1.0 + 40.0 * f(n, Z) * (f(n, Z) > 0.5),
                 deny_frac=f(n) * (f(n) > 0.5),
                 delay_frac=0.9 * f(n) * (f(n) > 0.5),
                 signal_stale=np.round(f(n)))
    return state, action, exo, fault


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_step_with_faults_matches_jax(preset):
    """Random states, actions, signals and per-cluster faults, one
    deterministic step: every state and metric field within 1e-6 of JAX's
    `step(fault=)`, vmapped."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    P, Z, K = jc.cluster.n_pools, jc.cluster.n_zones, \
        jc.sim.provision_delay_steps
    state, action, exo, fault = _random_step_inputs(
        np.random.default_rng(7), 64, P, Z, K)
    jp = JSimParams.from_config(jc)
    js, jm = jax.vmap(lambda s, a, e, f: jstep(
        jp, s, a, e, jax.random.key(0), fault=f))(
        JClusterState(**state), JAction(**action), JExoStep(**exo),
        JFaultStep(**fault))
    ts, tm = step(bridge.sim_params(_np(jp), device="cpu"),
                  ClusterState(**{k: torch.tensor(v)
                                  for k, v in state.items()}),
                  bridge.action(action, "cpu"), ExoStep(
                      **{k: torch.tensor(v) for k, v in exo.items()}),
                  fault=bridge.fault_step(fault, "cpu"))
    for name, got, want in (
            [(f"state.{f}", getattr(ts, f), getattr(js, f))
             for f in js._fields]
            + [(f, getattr(tm, f), getattr(jm, f)) for f in jm._fields]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TIGHT)
    print("\n# step(fault=), worst field: " + max(
        (_rel(got.numpy(), want) + f" ({name})" for name, got, want in
         [(f, getattr(tm, f), getattr(jm, f)) for f in jm._fields]
         + [(f, getattr(ts, f), getattr(js, f)) for f in js._fields]),
        key=lambda r: float(r.split()[1].rstrip(","))))
    assert float(tm.denied_nodes.max()) > 0 and float(
        tm.delayed_nodes.max()) > 0


@pytest.mark.parametrize("stochastic", [False, True])
def test_neutral_fault_step_is_bitwise_no_fault(stochastic):
    """The zero-fault gate, step half: a neutral FaultStep leaves every
    state and shared metric field bitwise the ``fault=None`` step's."""
    c = tcfg.PRESETS["multiregion"]()
    P, Z, K = c.cluster.n_pools, c.cluster.n_zones, c.sim.provision_delay_steps
    state, action, exo, _ = _random_step_inputs(
        np.random.default_rng(8), 32, P, Z, K)
    params = SimParams.from_config(c, device="cpu")
    st = ClusterState(**{k: torch.tensor(v) for k, v in state.items()})
    act = Action(**{k: torch.tensor(v) for k, v in action.items()})
    ex = ExoStep(**{k: torch.tensor(v) for k, v in exo.items()})
    u3 = (uniforms(3, torch.arange(32)[:, None], 5,
                   torch.arange(P * Z)[None, :]).reshape(3, 32, P, Z)
          if stochastic else None)
    s1, m1 = step(params, st, act, ex, u3, stochastic=stochastic)
    s2, m2 = step(params, st, act, ex, u3, stochastic=stochastic,
                  fault=FaultStep.neutral(Z, "cpu"))
    for a, b in zip(list(s1) + list(m1), list(s2) + list(m2)):
        assert torch.equal(a, b)


def test_observed_exo_holds_signals_not_the_clock():
    rng = np.random.default_rng(1)
    e0, e1 = (ExoStep(*(torch.tensor(rng.uniform(size=s).astype(np.float32))
                        for s in ((4, 3), (4, 3), (4, 3), (4, 2), (4,))))
              for _ in range(2))
    stale = torch.tensor([1.0, 0.0, 1.0, 0.0])
    held = observed_exo(e0, e1, stale)
    for f in ("spot_price_hr", "od_price_hr", "carbon_g_kwh", "demand_pods"):
        want = torch.where(stale[:, None] > 0.5, getattr(e0, f),
                           getattr(e1, f))
        assert torch.equal(getattr(held, f), want), f
    assert torch.equal(held.is_peak, e1.is_peak)


class TestRolloutOnJaxStreams:
    """The port's plain rollout (the CUDA kernels' oracle) on JAX's own
    fault-widened streams, deterministic, per cluster and field."""

    def _rule(self, s, name):
        return mk.megakernel_summary_from_packed(
            s.tp, offpeak_action(s.tc.cluster, "cpu"),
            peak_action(s.tc.cluster, "cpu"), s.t(name), STEPS, seed=3,
            stochastic=False)

    def test_rule_matches_jax_lax_and_interpret_kernel(self, streams):
        """Against the JAX lax path, and on the multiregion stream also
        against the interpret-mode kernel."""
        s = streams
        before = mk.megakernel_summary_from_packed.launches
        port = self._rule(s, "severe")
        assert mk.megakernel_summary_from_packed.launches == before
        lax_path = s.jax_lax("severe", JRulePolicy(s.jc.cluster).action_fn())
        worst = (_worst(port, lax_path), 0.0)
        if s.jc.cluster.regions:
            kern = jmk.megakernel_summary_from_packed(
                s.jp, joff(s.jc.cluster), jpeak(s.jc.cluster),
                s.j["severe"], STEPS, seed=3, **KERNEL_KW)
            worst = (worst[0], _worst(port, kern))
        print(f"\n# rule severe: worst vs lax {worst[0]:.3g}, vs kernel "
              f"{worst[1]:.3g} of the standard")
        assert max(worst) <= 1.0, worst
        assert float(port.denials.mean()) > 0 and float(
            port.stale_ticks.mean()) > 0

    def test_carbon_stale_observation_matches_jax(self, streams):
        """The carbon policy observes carbon: during outages both sides
        hold the same pre-outage values, or zone weights diverge."""
        s = streams
        port = mk.carbon_megakernel_summary_from_packed(
            s.tp, offpeak_action(s.tc.cluster, "cpu"),
            peak_action(s.tc.cluster, "cpu"), s.t("severe"), STEPS, seed=3,
            stochastic=False)
        lax_path = s.jax_lax("severe",
                             JCarbonAwarePolicy(s.jc.cluster).action_fn())
        worst = _worst(port, lax_path)
        if s.jc.cluster.regions:
            cp = JCarbonAwarePolicy(s.jc.cluster)
            kern = jmk.carbon_megakernel_summary_from_packed(
                s.jp, joff(s.jc.cluster), jpeak(s.jc.cluster),
                s.j["severe"], STEPS, seed=3, sharpness=cp.sharpness,
                min_weight=cp.min_weight, stickiness=cp.stickiness,
                **KERNEL_KW)
            worst = max(worst, _worst(port, kern))
        print(f"\n# carbon severe: worst {worst:.3g} of the standard")
        assert worst <= 1.0, worst
        # The outages matter to this policy: without the hold it differs.
        blind = batched_rollout_summary(
            s.tp, initial_state(s.tc, B, "cpu"),
            CarbonAwarePolicy(s.tc.cluster, device="cpu").action_fn(),
            mk.unpack_exo(s.t("severe"), STEPS, s.Z), 3,
            faults=unpack_fault_lanes(s.t("severe"), STEPS, s.Z)._replace(
                signal_stale=torch.zeros((B, STEPS))))[1]
        assert not torch.equal(blind.carbon_kg, port.carbon_kg)

    def test_neutral_lanes_are_the_plain_program(self, streams):
        """The zero-fault gate, rollout half: on the "off" stream the
        entries give, bitwise, what they give on the plain stream, in
        both modes, with denials and stale ticks 0."""
        s = streams
        off, peak = (offpeak_action(s.tc.cluster, "cpu"),
                     peak_action(s.tc.cluster, "cpu"))
        for stochastic in (False, True):
            for entry, kw in ((mk.megakernel_summary_from_packed, {}),
                              (mk.carbon_megakernel_summary_from_packed,
                               {"sharpness": 25.0})):
                a = entry(s.tp, off, peak, s.t("plain"), STEPS, seed=4,
                          stochastic=stochastic, **kw)
                b = entry(s.tp, off, peak, s.t("off"), STEPS, seed=4,
                          stochastic=stochastic, **kw)
                for f in a._fields:
                    assert torch.equal(getattr(a, f), getattr(b, f)), f
                assert float(b.denials.abs().max()) == 0.0
                assert float(b.stale_ticks.abs().max()) == 0.0

    def test_entry_refuses_a_malformed_stream(self, streams):
        s = streams
        bad = torch.zeros((STEPS, lanes.exo_rows(s.Z) + 3, 4))
        with pytest.raises(ValueError, match="does not fit"):
            mk.megakernel_summary_from_packed(
                s.tp, offpeak_action(s.tc.cluster, "cpu"),
                peak_action(s.tc.cluster, "cpu"), bad, STEPS)
