"""The port's carbon teacher against the JAX package on the same inputs:
the policy's decision on random states and signals, and the deterministic
carbon rollout against the JAX lax path and the interpret-mode Pallas
kernel, per cluster and field."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu_torch.config as tcfg
from ccka_tpu.policy import CarbonAwarePolicy as JCarbonAwarePolicy
from ccka_tpu.policy.carbon import carbon_zone_weight as jcarbon_zone_weight
from ccka_tpu.policy.rule import offpeak_action as joff
from ccka_tpu.policy.rule import peak_action as jpeak
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim.dynamics import ExoStep as JExoStep
from ccka_tpu.sim.rollout import batched_rollout_summary as jrollout
from ccka_tpu.sim.types import ClusterState as JClusterState
from ccka_tpu_torch import bridge
from ccka_tpu_torch.policy import CarbonAwarePolicy, carbon_zone_weight
from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.rollout import batched_rollout_summary, initial_state
from ccka_tpu_torch.sim.types import ClusterState

PRESET_NAMES = ("default", "multiregion")
# Per-cluster, per-field standard of tests/test_megakernel.py:186-203.
PER_CLUSTER_TOL = 2e-3


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def _field_rel(port, ref) -> dict:
    out = {}
    for f in ref._fields:
        a = getattr(port, f).detach().numpy().astype(np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        assert a.shape == b.shape, f
        out[f] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6)))
    return out


def _random_state_and_signals(rng, B, P, Z, K):
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    state = dict(
        nodes=5.0 * f(B, P, Z, 2), pipeline=2.0 * f(B, K, P, Z, 2),
        running=30.0 * f(B, 2), consol_timer_s=120.0 * f(B, P),
        time_s=3000.0 * f(B), acc_cost_usd=f(B), acc_carbon_g=100 * f(B),
        acc_requests=1e3 * f(B), acc_slo_ok_s=600 * f(B),
        acc_evictions=f(B))
    # A quarter of the clusters hold no fleet: the occupancy term's
    # denominator is then its epsilon alone.
    state["nodes"][: B // 4] = 0.0
    exo = dict(
        spot_price_hr=0.02 + 0.06 * f(B, Z),
        od_price_hr=np.full((B, Z), 0.096, np.float32),
        carbon_g_kwh=200 + 300 * f(B, Z),
        demand_pods=np.round(40.0 * f(B, 2)),
        is_peak=np.round(f(B)))
    return state, exo


@pytest.mark.parametrize("preset", PRESET_NAMES)
@pytest.mark.parametrize("constants", [
    {}, dict(sharpness=40.0, min_weight=0.2, stickiness=0.0)])
def test_decide_matches_jax(preset, constants):
    """Random states and signals: every leaf of the decided action within
    1e-6 of the JAX policy's, vmapped over clusters."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    P, Z, K = jc.cluster.n_pools, jc.cluster.n_zones, \
        jc.sim.provision_delay_steps
    state, exo = _random_state_and_signals(np.random.default_rng(5), 64,
                                           P, Z, K)
    jpolicy = JCarbonAwarePolicy(jc.cluster, **constants)
    want = jax.vmap(lambda s, e: jpolicy.decide(s, e, jnp.int32(0)))(
        JClusterState(**state), JExoStep(**exo))
    policy = CarbonAwarePolicy(tc.cluster, device="cpu", **constants)
    got = policy.decide(
        ClusterState(**{k: torch.tensor(v) for k, v in state.items()}),
        ExoStep(**{k: torch.tensor(v) for k, v in exo.items()}), 0)
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert tuple(got.zone_weight.shape) == (64, P, Z)
    assert float(got.zone_weight.min()) >= policy.min_weight
    assert policy.profile_name(True) == jpolicy.profile_name(True)
    assert policy.profile_name(False) == "offpeak+carbon"


def test_carbon_zone_weight_matches_jax():
    carbon = np.random.default_rng(2).uniform(150, 600, (16, 4)).astype(
        np.float32)
    want = jax.vmap(lambda c: jcarbon_zone_weight(c, sharpness=7.0))(carbon)
    got = carbon_zone_weight(torch.tensor(carbon), sharpness=7.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # Cleaner than the mean means a weight above one half.
    mean = carbon.mean(axis=1, keepdims=True)
    assert ((got.numpy() > 0.5) == (carbon < mean)).all()


class _World:
    """Both packages' params, profiles and one batch of traces, built from
    the same numpy noise."""

    def __init__(self, preset: str, B: int, T: int):
        self.jc = jcfg.PRESETS[preset]()
        self.tc = tcfg.PRESETS[preset]()
        self.jp = JSimParams.from_config(self.jc)
        self.tp = bridge.sim_params(_np(self.jp), device="cpu")
        src = JSource(self.jc.cluster, self.jc.workload, self.jc.sim,
                      self.jc.signals)
        self.jtr = src.batch_trace(T, range(200, 200 + B))
        self.ttr = bridge.trace(_np(self.jtr), device="cpu")
        self.B, self.T = B, T

    def port(self, **kw):
        return mk.carbon_megakernel_rollout_summary(
            self.tp, offpeak_action(self.tc.cluster, "cpu"),
            peak_action(self.tc.cluster, "cpu"), self.ttr, stochastic=False,
            device="cpu", **kw)

    def jax_kernel(self, **kw):
        return jmk.carbon_megakernel_rollout_summary(
            self.jp, joff(self.jc.cluster), jpeak(self.jc.cluster), self.jtr,
            stochastic=False, b_block=128, t_chunk=32, interpret=True, **kw)


@pytest.fixture(scope="module", params=PRESET_NAMES)
def world(request):
    return _World(request.param, 128, 96)


def test_deterministic_rollout_matches_jax_lax_and_interpret_kernel(world):
    """B = 128 x T = 96: every EpisodeSummary field of every cluster
    within 2e-3 of the JAX lax rollout under CarbonAwarePolicy and of the
    Pallas carbon kernel run in interpret mode."""
    w = world
    port = w.port()
    states = jax.tree.map(lambda x: jnp.broadcast_to(x, (w.B,) + x.shape),
                          jinitial_state(w.jc))
    keys = jax.random.split(jax.random.key(0), w.B)
    lax = jrollout(w.jp, states,
                   JCarbonAwarePolicy(w.jc.cluster).action_fn(), w.jtr, keys,
                   stochastic=False)[1]
    rel = _field_rel(port, lax)
    assert not {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}, rel
    rel = _field_rel(port, w.jax_kernel())
    assert not {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}, rel


def test_policy_constants_thread_through(world):
    """Non-default sharpness and stickiness change the rollout, and change
    it as they change the JAX kernel's."""
    w = world
    constants = dict(sharpness=40.0, stickiness=0.0)
    base, moved = w.port(), w.port(**constants)
    assert float((base.carbon_kg - moved.carbon_kg).abs().max()) > 0
    rel = _field_rel(moved, w.jax_kernel(**constants))
    assert not {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}, rel


def test_kernel_entry_on_cpu_is_the_plain_rollout(world):
    """A CPU stream takes the plain version under CarbonAwarePolicy, in
    both modes, pairs its draws with the rule entry's, and launches
    nothing."""
    w = world
    off = offpeak_action(w.tc.cluster, "cpu")
    peak = peak_action(w.tc.cluster, "cpu")
    before = mk.carbon_megakernel_summary_from_packed.launches
    policy = CarbonAwarePolicy(w.tc.cluster, device="cpu")
    for stochastic in (False, True):
        entry = mk.carbon_megakernel_summary_from_packed(
            w.tp, off, peak, mk._pack_exo(w.ttr, w.T + 8), w.T, seed=7,
            stochastic=stochastic)
        plain = batched_rollout_summary(
            w.tp, initial_state(w.tc, w.B, device="cpu"), policy.action_fn(),
            w.ttr, 7, stochastic=stochastic)[1]
        for f in plain._fields:
            assert torch.equal(getattr(entry, f), getattr(plain, f)), f
    assert mk.carbon_megakernel_summary_from_packed.launches == before
    with pytest.raises(ValueError, match="does not fit"):
        mk.carbon_megakernel_summary_from_packed(
            w.tp, off, peak, mk._pack_exo(w.ttr, w.T), w.T + 1)
