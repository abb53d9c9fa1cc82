"""The port's plan playback against the JAX package on the same inputs:
`pack_plan` bit for bit, the plain plan rollout against JAX's
interpret-mode plan kernel and its lax path (per cluster and per field,
``tests/test_megakernel.py``'s 2e-3 standard), the rule-equivalent plan
against the port's rule entry, and `rollout_actions` with the fault and
workload lanes against JAX's per tick."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu_torch.config as tcfg
from ccka_tpu.faults.process import unpack_fault_lanes as junpack_faults
from ccka_tpu.models import latent_to_action as jlatent_to_action
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim.rollout import rollout_actions as jrollout_actions
from ccka_tpu.sim.rollout import rollout_summary as jrollout_summary
from ccka_tpu.workloads.process import unpack_workload_lanes as junpack_wl
from ccka_tpu_torch import bridge
from ccka_tpu_torch.faults.process import unpack_fault_lanes
from ccka_tpu_torch.models.nets import latent_dim, latent_to_action
from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim.rollout import initial_state, rollout_actions
from ccka_tpu_torch.workloads.process import unpack_workload_lanes

PRESET_NAMES = ("default", "multiregion")
B, T = 128, 32
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


def _world(preset: str, seed: int):
    """Both packages' configs, params and one [B, T] trace batch."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    jparams = JSimParams.from_config(jc)
    traces = JSource(jc.cluster, jc.workload, jc.sim,
                     jc.signals).batch_trace_device(T, jax.random.key(seed),
                                                    B)
    return (jc, tc, jparams, bridge.sim_params(_np(jparams), "cpu"), traces,
            bridge.trace(_np(traces), "cpu"))


def _plans(jc, tc, lead, seed: int):
    """The same decoded random plan in both packages: latents 0.3 * N(0, 1)
    from numpy, leaves with leading axes ``lead``."""
    lat = (0.3 * np.random.default_rng(seed).standard_normal(
        lead + (latent_dim(tc.cluster),))).astype(np.float32)
    dec = lambda u: jlatent_to_action(u, jc.cluster)  # noqa: E731
    for _ in lead:
        dec = jax.vmap(dec)
    return dec(jnp.asarray(lat)), latent_to_action(torch.from_numpy(lat),
                                                   tc.cluster)


@pytest.mark.parametrize("preset", PRESET_NAMES)
@pytest.mark.parametrize("per_cluster", [True, False])
def test_pack_plan_is_jax_bitwise(preset, per_cluster):
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    lead = (B, T) if per_cluster else (T,)
    jacts, tacts = _plans(jc, tc, lead, 1)
    want = np.asarray(jmk.pack_plan(jacts, 64))
    got = mk.pack_plan(bridge.action(_np(jacts), "cpu"), 64)
    assert want.shape == tuple(got.shape)
    assert want.shape[1] == {"default": 16, "multiregion": 24}[preset]
    np.testing.assert_array_equal(got.numpy(), want)
    # The port's own decode packs to the same rows within float rounding,
    # and unpack_plan inverts pack_plan as views.
    np.testing.assert_allclose(mk.pack_plan(tacts, 64).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    back = mk.unpack_plan(got, T, tc.cluster.n_pools, tc.cluster.n_zones)
    for f in back._fields:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jacts, f)))


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_per_cluster_plan_matches_jax(preset):
    """B = 128 x T = 32, deterministic: the port's plan entry (its plain
    version on the CPU) against JAX's interpret-mode plan kernel and its
    lax path, per cluster and field; distinct plans give distinct costs."""
    jc, tc, jparams, tparams, jtraces, ttraces = _world(preset, 7)
    jacts, _ = _plans(jc, tc, (B, T), 3)
    jk = jmk.plan_megakernel_rollout_summary(
        jparams, jacts, jtraces, stochastic=False, b_block=128, t_chunk=32,
        interpret=True)
    states = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                          jinitial_state(jc))
    keys = jax.random.split(jax.random.key(0), B)

    def one(s, a, tr, k):
        fn = lambda state, exo, t: jax.tree.map(  # noqa: E731
            lambda x: x[t], a)
        return jrollout_summary(jparams, s, fn, tr, k, stochastic=False)[1]

    jl = jax.vmap(one)(states, jacts, jtraces, keys)
    got = mk.plan_megakernel_rollout_summary(
        tparams, bridge.action(_np(jacts), "cpu"), ttraces,
        stochastic=False, device="cpu")
    for ref in (jk, jl):
        rel = _field_rel(got, ref)
        bad = {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}
        assert not bad, bad
    assert float(got.cost_usd.std()) > 0


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_broadcast_plan_matches_jax(preset):
    jc, tc, jparams, tparams, jtraces, ttraces = _world(preset, 5)
    jacts, _ = _plans(jc, tc, (T,), 2)
    jk = jmk.plan_megakernel_rollout_summary(
        jparams, jacts, jtraces, stochastic=False, b_block=128, t_chunk=32,
        interpret=True)
    got = mk.plan_megakernel_rollout_summary(
        tparams, bridge.action(_np(jacts), "cpu"), ttraces,
        stochastic=False, device="cpu")
    rel = _field_rel(got, jk)
    bad = {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}
    assert not bad, bad


@pytest.mark.parametrize("preset", PRESET_NAMES)
@pytest.mark.parametrize("stochastic", [False, True])
def test_rule_equivalent_plan_is_the_rule_entry(preset, stochastic):
    """A per-cluster plan that replays the rule's profile choice per
    (cluster, tick) is the rule entry, bit for bit: the same step, only
    the source of the action differs. Broadcast plans of one profile are
    the rule with that profile at every tick."""
    tc = tcfg.PRESETS[preset]()
    _, _, _, tparams, _, ttraces = _world(preset, 11)
    off, peak = offpeak_action(tc.cluster, "cpu"), peak_action(tc.cluster,
                                                                "cpu")
    is_peak = ttraces.is_peak > 0.5
    plan = type(off)(*(
        torch.where(is_peak.reshape(B, T, *([1] * o.dim())), p, o)
        for o, p in zip(off, peak)))
    exo = mk._pack_exo(ttraces, T)
    pp = mk.pack_plan(plan, T)
    before = mk.plan_megakernel_summary_from_packed.launches
    got = mk.plan_megakernel_summary_from_packed(
        tparams, tc.cluster, pp, exo, T, seed=3, stochastic=stochastic)
    assert mk.plan_megakernel_summary_from_packed.launches == before
    want = mk.megakernel_summary_from_packed(tparams, off, peak, exo, T,
                                             seed=3, stochastic=stochastic)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    flat = type(off)(*(x.expand(T, *x.shape) for x in off))
    got = mk.plan_megakernel_summary_from_packed(
        tparams, tc.cluster, mk.pack_plan(flat, T), exo, T, seed=3,
        stochastic=stochastic)
    want = mk.megakernel_summary_from_packed(tparams, off, off, exo, T,
                                             seed=3, stochastic=stochastic)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_rejects_mismatched_plans():
    tc = tcfg.PRESETS["default"]()
    jc = jcfg.PRESETS["default"]()
    _, _, _, tparams, _, ttraces = _world("default", 13)
    _, short = _plans(jc, tc, (T // 2,), 4)
    with pytest.raises(ValueError, match="one action per tick"):
        mk.plan_megakernel_rollout_summary(tparams, short, ttraces,
                                           device="cpu")
    _, other_b = _plans(jc, tc, (B // 2, T), 4)
    with pytest.raises(ValueError, match="batch"):
        mk.plan_megakernel_rollout_summary(tparams, other_b, ttraces,
                                           device="cpu")
    exo = mk._pack_exo(ttraces, T)
    _, plan = _plans(jc, tc, (B, T), 4)
    for bad in (mk.pack_plan(plan, T + 8),
                mk.pack_plan(plan, T)[:, :8],
                mk.pack_plan(plan, T)[..., :B // 2]):
        with pytest.raises(ValueError, match="plan"):
            mk.plan_megakernel_summary_from_packed(tparams, tc.cluster, bad,
                                                   exo, T)


def _lane_stream(scenario: str, n: int):
    """JAX's packed stream and params of a fault intensity or a workload
    scenario (multiregion), with its unpacked lanes in both packages."""
    import dataclasses

    from ccka_tpu.workloads.scenarios import WORKLOAD_SCENARIOS
    from ccka_tpu.workloads.scenarios import scenario_source

    jc = jcfg.PRESETS["multiregion"]()
    if scenario in WORKLOAD_SCENARIOS:
        sc = WORKLOAD_SCENARIOS[scenario]
        src = scenario_source(jc, sc)
        params = JSimParams.from_config(
            dataclasses.replace(jc, workloads=sc.workloads))
    else:
        src = JSource(jc.cluster, jc.workload, jc.sim, jc.signals,
                      faults=jcfg.FAULT_PRESETS[scenario])
        params = JSimParams.from_config(jc)
    stream = src.packed_trace_device(T, jax.random.key(3), n, t_chunk=32)
    Z = jc.cluster.n_zones
    lay = jmk.lanes.resolve_layout(int(stream.shape[1]), Z)
    tstream = torch.from_numpy(np.array(stream))
    lanes = dict(
        faults=(unpack_fault_lanes(tstream, T, Z) if lay.has("faults")
                else None),
        workloads=(unpack_workload_lanes(tstream, T, Z)
                   if lay.has("workloads") else None))
    jlanes = dict(
        faults=(junpack_faults(stream, T, Z) if lay.has("faults") else None),
        workloads=(junpack_wl(stream, T, Z) if lay.has("workloads")
                   else None))
    return (jc, params, stream, jlanes, bridge.sim_params(_np(params), "cpu"),
            mk.unpack_exo(tstream, T, Z), lanes)


def test_rollout_actions_with_fault_lanes_matches_jax():
    """`rollout_actions` on the severe fault stream: every field's per-tick
    metrics against JAX's `rollout_actions` with the same lanes, 8
    clusters x 32 ticks, deterministic; the lanes reach the step."""
    n = 8
    tc = tcfg.PRESETS["multiregion"]()
    jc, params, stream, jlanes, tparams, ttraces, lanes = _lane_stream(
        "severe", n)
    jacts, _ = _plans(jc, tc, (n, T), 6)

    def one(tr, a, f):
        return jrollout_actions(params, jinitial_state(jc), a, tr,
                                jax.random.key(0), stochastic=False,
                                faults=f)[1]

    want = jax.vmap(one)(jmk.unpack_exo(stream, T, jc.cluster.n_zones),
                         jacts, jlanes["faults"])
    tacts = bridge.action(_np(jacts), "cpu")
    _, got = rollout_actions(tparams, initial_state(tc, n, "cpu"), tacts,
                             ttraces, **lanes)
    for f in want._fields:
        a = getattr(got, f).numpy().astype(np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=f)
    _, calm = rollout_actions(tparams, initial_state(tc, n, "cpu"), tacts,
                              ttraces)
    assert float(got.cost_usd.sum()) != float(calm.cost_usd.sum())
    assert float(got.denied_nodes.sum()) > 0


def test_rollout_actions_with_workload_lanes_matches_jax():
    """`rollout_actions` on the mixed stream (fault and workload lanes),
    folded by `summarize`, against JAX's lax plan engine
    (`lax_summary_from_packed` with the same plan latents) on the same
    stream, per cluster and field. (JAX's per-tick `rollout_actions` with
    the D = 16 batch queue takes minutes to compile on the CPU; the fault
    test above holds the per-tick metrics.)"""
    from ccka_tpu.sim.rollout import lax_summary_from_packed
    from ccka_tpu_torch.sim.metrics import summarize

    n = 8
    tc = tcfg.PRESETS["multiregion"]()
    jc, params, stream, _, tparams, ttraces, lanes = _lane_stream("mixed", n)
    lat = (0.3 * np.random.default_rng(6).standard_normal(
        (n, T, latent_dim(tc.cluster)))).astype(np.float32)
    want = lax_summary_from_packed(params, jc.cluster, stream, T,
                                   jax.random.key(0),
                                   plan_latents=jnp.asarray(lat))
    _, got = rollout_actions(
        tparams, initial_state(tc, n, "cpu"),
        latent_to_action(torch.from_numpy(lat), tc.cluster), ttraces,
        **lanes)
    rel = _field_rel(summarize(tparams, got), want)
    bad = {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}
    assert not bad, bad
    assert float(got.inf_served.sum()) > 0
    assert float(got.batch_served.sum()) > 0
