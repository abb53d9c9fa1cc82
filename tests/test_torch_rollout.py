"""The port's simulator against the JAX package on the same inputs: one
dynamics step, the deterministic rule rollout (against the lax reference
and the interpret-mode Pallas kernel, per cluster and field), the
stochastic rollout at distribution level, and the kernel's host side."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu_torch.config as tcfg
from ccka_tpu.policy import RulePolicy as JRulePolicy
from ccka_tpu.policy.rule import offpeak_action as joff
from ccka_tpu.policy.rule import peak_action as jpeak
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim.dynamics import ExoStep as JExoStep
from ccka_tpu.sim.dynamics import step as jstep
from ccka_tpu.sim.rollout import batched_rollout_summary as jrollout
from ccka_tpu.sim.types import Action as JAction
from ccka_tpu.sim.types import ClusterState as JClusterState
from ccka_tpu_torch import bridge
from ccka_tpu_torch.policy.rule import (RulePolicy, offpeak_action,
                                        peak_action, select_profile)
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim.dynamics import ExoStep, _poisson_small, step
from ccka_tpu_torch.sim.metrics import EpisodeSummary, summarize
from ccka_tpu_torch.sim.rollout import batched_rollout_summary, initial_state
from ccka_tpu_torch.sim.types import Action, ClusterState, SimParams

PRESET_NAMES = ("default", "multiregion")
# Per-cluster, per-field standard of tests/test_megakernel.py:100-109.
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


class _World:
    """Both packages' params, profiles and one batch of traces, built
    from the same numpy noise."""

    def __init__(self, preset: str, B: int, T: int):
        self.jc = jcfg.PRESETS[preset]()
        self.tc = tcfg.PRESETS[preset]()
        self.jp = JSimParams.from_config(self.jc)
        self.tp = bridge.sim_params(_np(self.jp), device="cpu")
        src = JSource(self.jc.cluster, self.jc.workload, self.jc.sim,
                      self.jc.signals)
        self.jtr = src.batch_trace(T, range(100, 100 + B))
        self.ttr = bridge.trace(_np(self.jtr), device="cpu")
        self.B, self.T = B, T

    def jax_lax(self, stochastic: bool):
        states = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (self.B,) + x.shape),
            jinitial_state(self.jc))
        keys = jax.random.split(jax.random.key(0), self.B)
        return jrollout(self.jp, states,
                        JRulePolicy(self.jc.cluster).action_fn(), self.jtr,
                        keys, stochastic=stochastic)[1]

    def port(self, stochastic: bool, seed: int = 0):
        return batched_rollout_summary(
            self.tp, initial_state(self.tc, self.B, device="cpu"),
            RulePolicy(self.tc.cluster, device="cpu").action_fn(), self.ttr,
            seed, stochastic=stochastic)[1]


@pytest.fixture(scope="module", params=PRESET_NAMES)
def short_world(request):
    return _World(request.param, 128, 96)


def _random_step_inputs(rng, B, P, Z, K):
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    state = dict(
        nodes=5.0 * f(B, P, Z, 2), pipeline=2.0 * f(B, K, P, Z, 2),
        running=30.0 * f(B, 2), consol_timer_s=120.0 * f(B, P),
        time_s=3000.0 * f(B), acc_cost_usd=f(B), acc_carbon_g=100 * f(B),
        acc_requests=1e3 * f(B), acc_slo_ok_s=600 * f(B),
        acc_evictions=f(B))
    action = dict(
        zone_weight=f(B, P, Z), ct_allow=f(B, P, 2),
        consolidation_aggr=f(B, P), consolidate_after_s=150.0 * f(B, P),
        hpa_scale=0.5 + 1.5 * f(B, 2))
    exo = dict(
        spot_price_hr=0.02 + 0.06 * f(B, Z),
        od_price_hr=np.full((B, Z), 0.096, np.float32),
        carbon_g_kwh=200 + 300 * f(B, Z),
        demand_pods=np.round(40.0 * f(B, 2)),
        is_peak=np.round(f(B)))
    return state, action, exo


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_one_step_matches_jax_step(preset):
    """Random state, action and signals: the port's batched step equals
    the JAX step vmapped over clusters (deterministic mode)."""
    cfg = jcfg.PRESETS[preset]()
    jp = JSimParams.from_config(cfg)
    P, Z, K = cfg.cluster.n_pools, cfg.cluster.n_zones, \
        cfg.sim.provision_delay_steps
    state, action, exo = _random_step_inputs(np.random.default_rng(4),
                                             64, P, Z, K)
    jfn = jax.vmap(lambda s, a, e: jstep(jp, s, a, e, jax.random.key(0),
                                         stochastic=False))
    js, jm = jfn(JClusterState(**state), JAction(**action), JExoStep(**exo))
    tp = bridge.sim_params(_np(jp), device="cpu")
    ts, tm = step(tp, ClusterState(**{k: torch.tensor(v)
                                      for k, v in state.items()}),
                  Action(**{k: torch.tensor(v) for k, v in action.items()}),
                  ExoStep(**{k: torch.tensor(v) for k, v in exo.items()}))
    for name, got, want in ((f"state.{f}", getattr(ts, f), getattr(js, f))
                            for f in js._fields):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=1e-5, err_msg=name)
    for f in jm._fields:
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)),
                                   rtol=2e-5, atol=1e-5, err_msg=f)


def test_step_refuses_lanes_of_later_slices():
    """The step refuses half of the workload pair (queues without
    arrivals) and stochastic mode without uniforms."""
    from ccka_tpu_torch.workloads.types import WorkloadState

    cfg = tcfg.default_config()
    tp = SimParams.from_config(cfg, device="cpu")
    state = initial_state(cfg, 2, device="cpu")
    exo = ExoStep(*(torch.ones(2, 3) for _ in range(3)), torch.ones(2, 2),
                  torch.ones(2))
    act = offpeak_action(cfg.cluster, "cpu")
    with pytest.raises(ValueError, match="both workload"):
        step(tp, state, act, exo, wl_state=WorkloadState.zero(16, 2, "cpu"))
    with pytest.raises(ValueError, match="uniforms"):
        step(tp, state, act, exo, stochastic=True)


def test_poisson_sampler_moments():
    """Truncated-CDF branch below lam = 0.5, rounded Gaussian above: the
    sample mean tracks lam (away from lam ~ 1-3, where clipping the
    Gaussian at 0 biases it up, as in the JAX sampler) and the cap
    binds."""
    from ccka_tpu_torch.sim.random import uniforms

    n = 200_000
    u3 = uniforms(11, torch.arange(n), 0, 0)                  # [3, n]
    for lam in (0.02, 0.3, 9.0, 25.0):
        lam_t = torch.full((n,), lam)
        x = _poisson_small(u3, lam_t, torch.full((n,), 1e9))
        assert torch.all(x == torch.round(x)) and torch.all(x >= 0)
        se = (lam / n) ** 0.5
        assert abs(x.mean().item() - lam) < 5 * se + 1e-3, lam
    capped = _poisson_small(u3, torch.full((n,), 9.0), torch.full((n,), 3.0))
    assert capped.max().item() == 3.0


def test_deterministic_rollout_matches_jax_lax_and_interpret_kernel(
        short_world):
    """B = 128 x T = 96: every EpisodeSummary field of every cluster
    within 2e-3 of the JAX lax rollout and of the Pallas kernel run in
    interpret mode."""
    w = short_world
    port = w.port(stochastic=False)
    rel = _field_rel(port, w.jax_lax(stochastic=False))
    assert not {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}, rel
    kern = jmk.megakernel_rollout_summary(
        w.jp, joff(w.jc.cluster), jpeak(w.jc.cluster), w.jtr,
        stochastic=False, b_block=128, t_chunk=32, interpret=True)
    rel = _field_rel(port, kern)
    assert not {f: r for f, r in rel.items() if r > PER_CLUSTER_TOL}, rel


def test_kernel_entry_on_cpu_is_the_plain_rollout(short_world):
    """A CPU stream takes the plain version through the kernel's own
    pack/unpack, draws the same Philox numbers, and launches nothing."""
    w = short_world
    before = mk.megakernel_summary_from_packed.launches
    for stochastic in (False, True):
        via_kernel_entry = mk.megakernel_rollout_summary(
            w.tp, offpeak_action(w.tc.cluster, "cpu"),
            peak_action(w.tc.cluster, "cpu"), w.ttr, seed=7,
            stochastic=stochastic, device="cpu")
        plain = w.port(stochastic=stochastic, seed=7)
        for f in plain._fields:
            assert torch.equal(getattr(via_kernel_entry, f),
                               getattr(plain, f)), f
    assert mk.megakernel_summary_from_packed.launches == before


def test_pack_exo_matches_jax_and_round_trips():
    w = _World("multiregion", 6, 50)
    want = np.asarray(jmk._pack_exo(w.jtr, 64))
    got = mk._pack_exo(w.ttr, 64)
    assert tuple(got.shape) == want.shape == (64, mk.exo_rows(4), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    back = mk.unpack_exo(got, 50, 4)
    for f in back._fields:
        assert torch.equal(getattr(back, f), getattr(w.ttr, f)), f
    assert mk.exo_rows(3) == jmk._exo_rows(3)
    np.testing.assert_array_equal(
        mk._pack_params(w.tp).numpy(), np.asarray(jmk._pack_params(w.jp)))
    np.testing.assert_array_equal(
        mk._pack_action(offpeak_action(w.tc.cluster, "cpu")).numpy(),
        np.asarray(jmk._pack_action(joff(w.jc.cluster))))


def test_mean_parity_violations_matches_jax():
    rng = np.random.default_rng(3)
    n = 400
    base = {f: rng.uniform(1.0, 2.0, n).astype(np.float32)
            for f in EpisodeSummary._fields}
    shifted = dict(base)
    shifted["cost_usd"] = base["cost_usd"] * 1.02          # real bias
    shifted["interruptions"] = base["interruptions"] * 1.01  # within tol
    shifted["evictions"] = base["evictions"] + rng.normal(0, 0.5, n)  # noise
    a = EpisodeSummary(**{f: torch.tensor(v) for f, v in shifted.items()})
    b = EpisodeSummary(**{f: torch.tensor(v) for f, v in base.items()})
    got = mk.mean_parity_violations(a, b)
    want = jmk.mean_parity_violations(_as_jax(shifted), _as_jax(base))
    assert got == want and "cost_usd" in got
    assert mk.mean_parity_violations(
        a, b, overrides={"cost_usd": 0.05}) == jmk.mean_parity_violations(
        _as_jax(shifted), _as_jax(base), overrides={"cost_usd": 0.05})
    assert mk.MEAN_PARITY_TOLERANCES == jmk.MEAN_PARITY_TOLERANCES
    assert mk.DEFAULT_MEAN_PARITY_TOL == jmk.DEFAULT_MEAN_PARITY_TOL


def _as_jax(fields: dict):
    from ccka_tpu.sim.metrics import EpisodeSummary as JEpisodeSummary

    return JEpisodeSummary(**{f: jnp.asarray(v) for f, v in fields.items()})


def test_finalize_matches_summarize_on_stacked_metrics():
    """The loop-carried SummaryAcc path equals reducing stacked per-tick
    metrics, as in the JAX package."""
    cfg = tcfg.default_config()
    tp = SimParams.from_config(cfg, device="cpu")
    tsrc = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals)
    tr = tsrc.batch_trace(64, range(8), device="cpu")
    policy = RulePolicy(cfg.cluster, device="cpu")
    state = initial_state(cfg, 8, device="cpu")
    states0 = state
    metrics = []
    for t in range(64):
        exo = ExoStep(*(x[:, t] for x in tr))
        state, m = step(tp, state, policy.decide(state, exo, t), exo)
        metrics.append(m)
    stacked = type(metrics[0])(*(torch.stack(xs, dim=1)
                                 for xs in zip(*metrics)))
    want = summarize(tp, stacked)
    _, got = batched_rollout_summary(tp, states0, policy.action_fn(), tr)
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


def test_deterministic_rollout_is_differentiable():
    """Gradients reach the profile constants through the whole horizon
    (the diff-MPC path needs autograd through `step`)."""
    cfg = tcfg.default_config()
    tp = SimParams.from_config(cfg, device="cpu")
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    tr = src.batch_trace(48, range(4), device="cpu")
    off = offpeak_action(cfg.cluster, "cpu")
    hpa = off.hpa_scale.clone().requires_grad_(True)
    off = off._replace(hpa_scale=hpa)
    peak = peak_action(cfg.cluster, "cpu")
    _, s = batched_rollout_summary(
        tp, initial_state(cfg, 4, device="cpu"),
        lambda st, e, t: select_profile(e.is_peak, off, peak), tr)
    s.cost_usd.sum().backward()
    assert hpa.grad is not None and torch.isfinite(hpa.grad).all()
    assert hpa.grad.abs().sum() > 0


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_policy_surface_matches_jax(preset):
    """Rule profiles, the neutral reset, the Kyverno projection of random
    actions, and the observation features, against the JAX package."""
    from ccka_tpu.policy.base import observe as jobserve
    from ccka_tpu.policy.constraints import project_feasible as jproject
    from ccka_tpu.policy.rule import neutral_action as jneutral
    from ccka_tpu_torch.policy.base import observe
    from ccka_tpu_torch.policy.constraints import project_feasible
    from ccka_tpu_torch.policy.rule import neutral_action

    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    for jfn, tfn in ((joff, offpeak_action), (jpeak, peak_action),
                     (jneutral, neutral_action)):
        want, got = jfn(jc.cluster), tfn(tc.cluster, "cpu")
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)

    P, Z, K = jc.cluster.n_pools, jc.cluster.n_zones, \
        jc.sim.provision_delay_steps
    state, action, exo = _random_step_inputs(np.random.default_rng(9),
                                             32, P, Z, K)
    # Out-of-range and collapsed inputs exercise every projection rule.
    action["zone_weight"][:8] = 1e-5
    action["ct_allow"] = 3.0 * action["ct_allow"] - 1.0
    action["consolidate_after_s"] *= 8.0
    action["hpa_scale"] *= 4.0
    want = jax.vmap(lambda a: jproject(a, jc.cluster))(JAction(**action))
    got = project_feasible(
        Action(**{k: torch.tensor(v) for k, v in action.items()}),
        tc.cluster)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)

    jp = JSimParams.from_config(jc)
    want = jax.vmap(lambda s, e: jobserve(jp, s, e).flatten())(
        JClusterState(**state), JExoStep(**exo))
    got = observe(bridge.sim_params(_np(jp), device="cpu"),
                  ClusterState(**{k: torch.tensor(v)
                                  for k, v in state.items()}),
                  ExoStep(**{k: torch.tensor(v) for k, v in exo.items()}))
    np.testing.assert_allclose(got.flatten().numpy(), np.asarray(want),
                               rtol=1e-6)
