"""The port's differentiable MPC against the JAX package on the same inputs.

- The gradient of the 8-tick plan objective through the port's simulator
  against ``jax.value_and_grad`` of JAX's, at the zero latent (every
  fresh-cluster tie of the simulator's max/min/clip is live there) and at
  a random latent, both presets.
- Adam against ``optax.adam`` on the same gradients.
- The planners (`optimize_plan_batch`, `receding_horizon_plan_batch`,
  `receding_horizon_rollout`) and `compare_backends` with an
  `MPCBackend` against JAX's lax planner.

Plans are held to a latent tolerance of ``iters * 0.25 * lr``: at the
zero latent most coordinates have a gradient of float noise (|g| < 1e-6),
and Adam's first step turns a noise gradient g into a move of
``lr * g / (|g| + eps)``, about 0.25 lr for |g| ~ 3e-9, in a direction
the two frameworks' rounding decides. Those coordinates barely move the
objective, so the objectives and KPIs are held to 1e-5 to 1e-3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.models import latent_to_action as jlatent_to_action
from ccka_tpu.policy.rule import RulePolicy as JRulePolicy
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim.rollout import rollout_actions as jrollout_actions
from ccka_tpu.train import evaluate as jevaluate
from ccka_tpu.train import mpc as jmpc
from ccka_tpu.train.objective import episode_objective as jobjective
from ccka_tpu_torch import bridge
from ccka_tpu_torch.models.nets import latent_dim, latent_to_action
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim.rollout import initial_state, rollout_actions
from ccka_tpu_torch.train import evaluate, mpc, optim
from ccka_tpu_torch.train.objective import episode_objective

PRESET_NAMES = ("default", "multiregion")
H = 8
# Gradient standard: absolute, against largest gradients of 0.018-0.026.
GRAD_TOL = 1e-6


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def _lr(tc) -> float:
    return tc.train.learning_rate * 10.0


def _fleet(preset: str, n: int, steps: int, seed0: int = 11):
    """Both packages' configs and params, and n traces of ``steps`` ticks
    (numpy noise, equal in both)."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    jparams = JSimParams.from_config(jc)
    jtr = JSource(jc.cluster, jc.workload, jc.sim, jc.signals).batch_trace(
        steps, list(range(seed0, seed0 + n)))
    return (jc, tc, jparams, bridge.sim_params(_np(jparams), "cpu"), jtr,
            bridge.trace(_np(jtr), "cpu"))


def _jstates(jc, n):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape),
                        jinitial_state(jc))


@pytest.mark.parametrize("latent", ["zero", "random"])
@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_objective_gradient_matches_jax(preset, latent):
    """``value_and_grad`` of the episode objective of an 8-tick plan from
    fresh clusters, JAX against the port's autograd: values within 1e-6
    relative, every gradient coordinate within 1e-6.

    One pair of coordinates is a kink, not a fault: at the zero latent the
    tick-0 order covers the pending pods exactly, so at ticks 1 and 2 the
    provisioning need ``max(shortage / ppn - incoming, 0)`` sits at 0 in
    exact arithmetic, and which side of the kink the float lands on
    depends on the order in which the pipeline's (pool, zone) shares are
    summed (XLA's in JAX, left to right in the port, for its kernels'
    sake). hpa_scale[0] at ticks 1 and 2 therefore splits its gradient
    between the two ticks differently; the sum over the two agrees."""
    jc, tc, jparams, tparams, jtr, ttr = _fleet(preset, 1, H)
    jtr1 = jax.tree.map(lambda x: x[0], jtr)
    A = latent_dim(tc.cluster)
    lat = (np.zeros((H, A), np.float32) if latent == "zero" else
           (0.3 * np.random.default_rng(1).standard_normal((H, A)))
           .astype(np.float32))

    def jobj(u):
        acts = jax.vmap(lambda x: jlatent_to_action(x, jc.cluster))(u)
        _, m = jrollout_actions(jparams, jinitial_state(jc), acts, jtr1,
                                jax.random.key(0), stochastic=False)
        return jobjective(m, jc.train)

    jv, jg = jax.value_and_grad(jobj)(jnp.asarray(lat))
    u = torch.tensor(lat[None], requires_grad=True)
    _, m = rollout_actions(tparams, initial_state(tc, 1, "cpu"),
                           latent_to_action(u, tc.cluster), ttr)
    v = episode_objective(m, tc.train)[0]
    g = torch.autograd.grad(v, u)[0][0].numpy()
    jg = np.asarray(jg)
    assert abs(float(v.detach()) - float(jv)) <= 1e-6 * abs(float(jv))
    assert np.abs(jg).max() > 0.01
    d = np.abs(g - jg)
    if latent == "zero":
        kink = (slice(1, 3), A - 2)            # hpa_scale[0], ticks 1-2
        assert abs(g[kink].sum() - jg[kink].sum()) <= GRAD_TOL
        d[kink] = 0.0
    bad = np.argwhere(d > GRAD_TOL)
    assert bad.size == 0, [(int(t), int(a), float(jg[t, a]), float(g[t, a]))
                           for t, a in bad]


def test_adam_matches_optax():
    """Five steps on the same gradients, float-noise ones included: the
    moments bit for bit, every update within 2e-5 relative of optax's and
    within 1e-6 relative of optax's formula evaluated in float64 on those
    moments and its float32 bias corrections. (XLA's CPU code for the
    update lands up to 1e-5 away from the float32-rounded quotient, as if
    it divided through an approximate reciprocal; the port's update is the
    rounded one.)"""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, H, 16)).astype(np.float32)
    lr = 3e-3
    opt = optax.adam(lr)
    jstate = opt.init(jnp.asarray(x))
    port = mpc.Adam(lr)
    tstate = port.init(torch.from_numpy(x))
    for i in range(5):
        g = rng.standard_normal(x.shape).astype(np.float32)
        g[0] *= 1e-8                           # float-noise gradients
        ju, jstate = opt.update(jnp.asarray(g), jstate, jnp.asarray(x))
        tu, tstate = port.update(torch.from_numpy(g), tstate)
        mu, nu = np.asarray(jstate[0].mu), np.asarray(jstate[0].nu)
        np.testing.assert_array_equal(tstate[0].numpy(), mu)
        np.testing.assert_array_equal(tstate[1].numpy(), nu)
        bc1, bc2 = (optim._bias_correction(d, i + 1) for d in (0.9, 0.999))
        exact = -lr * (mu / bc1) / (
            np.sqrt(nu.astype(np.float64) / bc2) + 1e-8)
        np.testing.assert_allclose(tu.numpy(), exact, rtol=1e-6, atol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=2e-5,
                                   atol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_optimize_plan_batch_matches_jax(preset):
    """Four clusters, one 8-tick window each, three iterations from the
    zero latent: plans within ``iters * 0.25 * lr``, each iteration's
    objective within 1e-5 relative."""
    iters, n = 3, 4
    jc, tc, jparams, tparams, jtr, ttr = _fleet(preset, n, H)
    A = latent_dim(tc.cluster)
    want = jmpc.optimize_plan_batch(jparams, jc.cluster, jc.train,
                                    _jstates(jc, n), jtr,
                                    jnp.zeros((n, H, A)), iters=iters)
    got = mpc.optimize_plan_batch(tparams, tc.cluster, tc.train,
                                  initial_state(tc, n, "cpu"), ttr,
                                  torch.zeros((n, H, A)), iters=iters)
    assert tuple(got.losses.shape) == (n, iters)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-5)
    np.testing.assert_allclose(got.plan_latent.numpy(),
                               np.asarray(want.plan_latent), rtol=0,
                               atol=iters * 0.25 * _lr(tc))
    # The planner descends: the last iteration's objective is lower.
    assert (got.losses[:, -1] < got.losses[:, 0]).all()
    one = mpc.optimize_plan(tparams, tc.cluster, tc.train,
                            initial_state(tc, 1, "cpu"),
                            type(ttr)(*(x[0] for x in ttr)),
                            torch.zeros((H, A)), iters=iters)
    # One cluster alone: the same plan (CPU kernels may round a batch of
    # one and of four differently in the last bit).
    torch.testing.assert_close(one.plan_latent, got.plan_latent[0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_receding_horizon_plan_batch_matches_jax(preset):
    """The boards' quick planner (horizon 8, replan_every 8, iters 2) over
    4 clusters x 32 ticks (four segments): executed latents within
    ``iters * 0.25 * lr``."""
    quick = dict(horizon=8, replan_every=8, iters=2)
    n, T = 4, 32
    jc, tc, jparams, tparams, jtr, ttr = _fleet(preset, n, T)
    A = latent_dim(tc.cluster)
    want = np.asarray(jmpc.receding_horizon_plan_batch(
        jparams, jc.cluster, jc.train, _jstates(jc, n), jtr,
        jnp.zeros((n, H, A)), **quick))
    got = mpc.receding_horizon_plan_batch(
        tparams, tc.cluster, tc.train, initial_state(tc, n, "cpu"), ttr,
        mpc.zero_latent(tc.cluster, "cpu").expand(n, H, A), **quick)
    assert tuple(got.shape) == (n, T, A)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=quick["iters"] * 0.25 * _lr(tc))
    single = mpc.receding_horizon_plan(
        tparams, tc.cluster, tc.train, initial_state(tc, 1, "cpu"),
        type(ttr)(*(x[0] for x in ttr)), torch.zeros((H, A)), **quick)
    torch.testing.assert_close(single, got[0], rtol=0, atol=1e-6)


def test_receding_horizon_rollout_deterministic_matches_jax():
    """Closed-loop MPC, deterministic, multiregion, 2 clusters x 16 ticks:
    the episode objective and every per-tick cost within 1e-3 relative."""
    quick = dict(horizon=8, replan_every=8, iters=2)
    n, T = 2, 16
    jc, tc, jparams, tparams, jtr, ttr = _fleet("multiregion", n, T)
    A = latent_dim(tc.cluster)

    def one(tr):
        return jmpc.receding_horizon_rollout(
            jparams, jc.cluster, jc.train, jinitial_state(jc), tr,
            jnp.zeros((H, A)), jax.random.key(0), stochastic=False,
            **quick)[1]

    want = jax.vmap(one)(jtr)
    _, got = mpc.receding_horizon_rollout(
        tparams, tc.cluster, tc.train, initial_state(tc, n, "cpu"), ttr,
        torch.zeros((n, H, A)), stochastic=False, **quick)
    assert tuple(got.cost_usd.shape) == (n, T)
    np.testing.assert_allclose(
        episode_objective(got, tc.train).numpy(),
        np.asarray(jobjective(want, jc.train)), rtol=1e-3)
    for f in ("cost_usd", "carbon_g", "served_pods", "nodes_by_zone"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-3,
                                   atol=1e-4, err_msg=f)


def test_compare_backends_with_mpc_matches_jax():
    """`compare_backends` over 2 held-out traces of 20 ticks (not a
    multiple of replan_every: the MPC run pads with persistence and cuts
    back), deterministic, rule and MPC (horizon 8, iters 2): every KPI
    and ratio within 1e-3 relative (1e-4 absolute)."""
    jc, tc = jcfg.PRESETS["default"](), tcfg.PRESETS["default"]()
    n, T = 2, 20
    jtraces = jevaluate.heldout_traces(
        JSource(jc.cluster, jc.workload, jc.sim, jc.signals), steps=T, n=n)
    ttraces = evaluate.heldout_traces(
        SyntheticSignalSource(tc.cluster, tc.workload, tc.sim, tc.signals),
        steps=T, n=n, device="cpu")
    for f in ttraces._fields:
        np.testing.assert_allclose(
            getattr(ttraces, f).numpy(),
            np.stack([np.asarray(getattr(t, f)) for t in jtraces]),
            rtol=1e-5, atol=1e-6)
    want = jevaluate.compare_backends(
        jc, {"rule": JRulePolicy(jc.cluster),
             "mpc": jmpc.MPCBackend(jc, horizon=H, iters=2)},
        jtraces, stochastic=False)
    got = evaluate.compare_backends(
        tc, {"rule": RulePolicy(tc.cluster, "cpu"),
             "mpc": mpc.MPCBackend(tc, horizon=H, iters=2, device="cpu")},
        ttraces, stochastic=False)
    for name in ("rule", "mpc"):
        w, g = want[name], got[name]
        assert g["backend"] == w["backend"]
        for k, v in w.items():
            if k in ("backend", "per_trace"):
                continue
            assert abs(g[k] - v) <= 1e-4 + 1e-3 * abs(v), (name, k, g[k], v)
        for k, v in w["per_trace"].items():
            np.testing.assert_allclose(g["per_trace"][k], v, rtol=1e-3,
                                       atol=1e-4)
    assert "vs_rule_usd_per_slo_hour" in got["mpc"]


def test_mpc_backend_surface():
    """The backend refuses ``action_fn``, replans a batch against a window,
    and ``decide`` reads the plan at the tick's position."""
    tc = tcfg.PRESETS["default"]()
    b = mpc.MPCBackend(tc, horizon=4, iters=1, replan_every=2,
                       device="cpu")
    assert b.requires_receding_horizon
    with pytest.raises(RuntimeError, match="evaluate"):
        b.action_fn()
    traces = SyntheticSignalSource(
        tc.cluster, tc.workload, tc.sim, tc.signals).batch_trace(
        6, [1, 2, 3], device="cpu")
    result = b.replan(initial_state(tc, 3, "cpu"), traces)
    A = latent_dim(tc.cluster)
    assert tuple(result.plan_latent.shape) == (3, 4, A)
    assert tuple(result.losses.shape) == (3, 1)
    a = b.decide(None, None, 5)
    want = latent_to_action(result.plan_latent[:, 1], tc.cluster)
    for x, y in zip(a, want):
        assert torch.equal(x, y)
