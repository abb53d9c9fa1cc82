"""The port's forecasters against the JAX package's on the same histories:
persistence, seasonal-naive and ridge AR-k predictions, the planning
window, the closed-form AR fit, the error metrics and the window sweep,
within 1e-5 (the ridge fit's float32 normal equations within 1e-4); and
the receding-horizon planner with a forecaster against JAX's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.forecast as jfc
import ccka_tpu_torch.config as tcfg
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.train import mpc as jmpc
from ccka_tpu_torch import bridge
from ccka_tpu_torch.forecast import backends, base, metrics
from ccka_tpu_torch.models.nets import latent_dim
from ccka_tpu_torch.sim.rollout import initial_state
from ccka_tpu_torch.train import mpc

TOL = 1e-5


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def _traces(n: int, steps: int, preset: str = "multiregion"):
    jc = jcfg.PRESETS[preset]()
    jtr = JSource(jc.cluster, jc.workload, jc.sim, jc.signals).batch_trace(
        steps, list(range(40, 40 + n)))
    return jtr, bridge.trace(_np(jtr), "cpu")


def _close(got, want, rtol=TOL, atol=TOL):
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


PAIRS = {
    "persistence": (jfc.PersistenceForecaster(),
                    backends.PersistenceForecaster()),
    "seasonal": (jfc.SeasonalNaiveForecaster(period_steps=24),
                 backends.SeasonalNaiveForecaster(period_steps=24)),
    "seasonal-short": (jfc.SeasonalNaiveForecaster(period_steps=200),
                       backends.SeasonalNaiveForecaster(period_steps=200)),
    "ridge": (jfc.RidgeARForecaster(lags=8), backends.RidgeARForecaster(
        lags=8)),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_predict_matches_jax(name):
    """Six histories of 96 ticks, 12-tick forecasts: ``predict_batch``
    against JAX's, and one history's ``predict`` against JAX's."""
    jf, tf = PAIRS[name]
    jtr, ttr = _traces(6, 96)
    rtol = 1e-4 if name == "ridge" else TOL
    _close(tf.predict_batch(ttr, 12), jf.predict_batch(jtr, 12), rtol,
           rtol)
    one = jax.tree.map(lambda x: x[2], jtr)
    _close(tf.predict(type(ttr)(*(x[2] for x in ttr)), 12),
           jf.predict(one, 12), rtol, rtol)
    assert tf.wanted_history(12) == jf.wanted_history(12)


@pytest.mark.parametrize("name", ["persistence", "ridge"])
def test_planning_window_matches_jax(name):
    jf, tf = PAIRS[name]
    jtr, ttr = _traces(3, 80)
    want = jax.vmap(lambda h: jfc.planning_window(jf, h, 8))(jtr)
    got = base.planning_window(tf, ttr, 8)
    _close(got, want, 1e-4, 1e-4)
    # Tick 0 is the observed last tick of the history, exactly.
    for f in ttr._fields:
        assert torch.equal(getattr(got, f)[:, 0], getattr(ttr, f)[:, -1])


def test_fit_ar_coeffs_matches_jax():
    y = np.random.default_rng(3).standard_normal((5, 128)).astype(
        np.float32).cumsum(axis=1)
    want = jax.vmap(lambda c: jfc.fit_ar_coeffs(c, 6, 1e-3))(jnp.asarray(y))
    got = backends.fit_ar_coeffs(torch.from_numpy(y), 6, 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="needs more than"):
        backends.fit_ar_coeffs(torch.zeros(4), 6, 1e-3)


def test_make_forecaster_and_identity():
    """The factory's spellings, and equality/hash by (type, config)."""
    assert base.make_forecaster("oracle") is None
    assert base.make_forecaster("") is None
    for name, cls in (("persistence", backends.PersistenceForecaster),
                      ("seasonal-naive", backends.SeasonalNaiveForecaster),
                      ("ridge", backends.RidgeARForecaster)):
        f = base.make_forecaster(name)
        assert isinstance(f, cls)
        assert f == base.make_forecaster(name)
        assert hash(f) == hash(base.make_forecaster(name))
    assert base.make_forecaster("seasonal").period_steps == 2880
    assert backends.RidgeARForecaster(lags=4) != backends.RidgeARForecaster()
    with pytest.raises(ValueError, match="unknown forecaster"):
        base.make_forecaster("crystal-ball")


def test_errors_windows_and_sweep_match_jax():
    jtr, ttr = _traces(1, 300)
    jt = jax.tree.map(lambda x: x[0], jtr)
    tt = type(ttr)(*(x[0] for x in ttr))
    anchors = [40, 100, 250]
    jh, jfu = jfc.gather_windows(jt, anchors, 32, 16)
    th, tfu = metrics.gather_windows(tt, anchors, 32, 16)
    _close(th, jh, 0, 0)
    _close(tfu, jfu, 0, 0)
    with pytest.raises(ValueError, match="anchors must lie"):
        metrics.gather_windows(tt, [290], 32, 16)
    jf, tf = PAIRS["ridge"]
    want = jfc.evaluate_forecaster(jf, jt, horizon=16, stride=48)
    got = metrics.evaluate_forecaster(tf, tt, horizon=16, stride=48)
    for k in ("forecaster", "horizon", "history_steps", "n_windows",
              "stride"):
        assert got[k] == want[k], k
    for f in list(jtr._fields) + ["overall"]:
        for k, v in want[f].items():
            np.testing.assert_allclose(got[f][k], v, rtol=1e-3, atol=1e-5,
                                       err_msg=f"{f} {k}")


def test_planner_with_a_forecaster_matches_jax():
    """`receding_horizon_plan_batch` planning against persistence forecasts
    (2 clusters x 16 ticks, two segments, quick planner) against JAX's.

    A persistence window holds demand constant, so after the first order
    the provisioning need ``max(shortage / ppn - incoming, 0)`` sits on
    its kink at every tick, and the side the float lands on follows each
    framework's summation order (`tests/test_torch_mpc.py`). Adam's first
    steps move by about lr whatever the gradient's size, so a kink
    coordinate may step the other way in each of the 2 x 2 Adam steps:
    latents within ``segments * iters * lr``. What the plans do agrees
    far closer: their objectives over the true trace within 1e-3
    (2.9e-4 measured)."""
    from ccka_tpu_torch.models.nets import latent_to_action
    from ccka_tpu_torch.sim.rollout import rollout_actions
    from ccka_tpu_torch.train.objective import episode_objective

    quick = dict(horizon=8, replan_every=8, iters=2)
    jc, tc = jcfg.PRESETS["default"](), tcfg.PRESETS["default"]()
    jtr = JSource(jc.cluster, jc.workload, jc.sim, jc.signals).batch_trace(
        16, [3, 4])
    ttr = bridge.trace(_np(jtr), "cpu")
    jparams = JSimParams.from_config(jc)
    tparams = bridge.sim_params(_np(jparams), "cpu")
    A = latent_dim(tc.cluster)
    states = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape),
                          jinitial_state(jc))
    want = np.asarray(jmpc.receding_horizon_plan_batch(
        jparams, jc.cluster, jc.train, states, jtr, jnp.zeros((2, 8, A)),
        forecaster=jfc.PersistenceForecaster(), **quick))
    got = mpc.receding_horizon_plan_batch(
        tparams, tc.cluster, tc.train, initial_state(tc, 2, "cpu"), ttr,
        torch.zeros((2, 8, A)), forecaster=backends.PersistenceForecaster(),
        **quick)
    lr = tc.train.learning_rate * 10
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * 2 * lr)

    def objective(lat):
        _, m = rollout_actions(tparams, initial_state(tc, 2, "cpu"),
                               latent_to_action(lat, tc.cluster), ttr)
        return episode_objective(m, tc.train).numpy()

    np.testing.assert_allclose(objective(got),
                               objective(torch.from_numpy(want.copy())),
                               rtol=1e-3)
    oracle = mpc.receding_horizon_plan_batch(
        tparams, tc.cluster, tc.train, initial_state(tc, 2, "cpu"), ttr,
        torch.zeros((2, 8, A)), **quick)
    assert not torch.equal(oracle, got)
