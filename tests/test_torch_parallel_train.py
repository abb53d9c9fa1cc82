"""The port's sharded plain rollouts and sharded PPO against the JAX
package's on its 8 virtual devices, and against the port's unsharded
runs.

Every case sets ``sim.spot_interruption_rate_hr = 0`` (Threefry is not
Philox: the interruption draws cannot cross the frameworks), so the
stochastic step is the deterministic one in both packages, as in
`tests/test_torch_train.py`.

- `sharded_batched_rollout` and `sharded_batched_rollout_summary` on the
  same traces: every leaf of the final states, the per-tick metrics and
  the summaries within `tests/test_parallel.py`'s rtol 2e-4, atol 1e-5.
- One sharded PPO iteration from the same params, window and action noise
  (JAX's key schedule): the port's on an 8-shard and on a [2, 2] (data x
  model) mesh against its own unsharded iteration at `tests/
  test_parallel.py`'s rtol 2e-4, atol 2e-5; against JAX's sharded
  iteration the collected quantities (reward, attainment) at rtol 2e-4
  and the parameters at `tests/test_torch_train.py`'s cross-framework
  standard (the bf16 torso differentiates differently in XLA and torch,
  so Adam's first steps move the parameters apart by up to 2 lr a step,
  sharded or not).
- The port alone at a spot-interruption rate that reclaims nodes every
  tick and with an attainment target (the shadow rollout runs), 8
  clusters over 16 ticks: the
  sharded iteration's worlds bitwise the unsharded one's (a shard that
  drew another cluster's interruptions would differ), the collected
  quantities and the shadow's attainment at rtol 1e-6, the losses, the
  KL and the parameters at rtol 2e-4, atol 2e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu import parallel as jpar
from ccka_tpu.policy import RulePolicy as JRulePolicy
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.train.ppo import PPOTrainer as JTrainer
from ccka_tpu_torch import bridge
from ccka_tpu_torch.config import MeshConfig
from ccka_tpu_torch.parallel import (gather, make_mesh, shard_params,
                                     shard_ppo_state,
                                     sharded_batched_rollout,
                                     sharded_batched_rollout_summary)
from ccka_tpu_torch.parallel.mesh import ColumnSharded, Sharded
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource as TSource
from ccka_tpu_torch.sim.rollout import initial_state
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train.ppo import PPOTrainer

B, T = 8, 4
_RATE0 = {"sim.spot_interruption_rate_hr": 0.0, "train.batch_clusters": B,
          "train.unroll_steps": T}
ROLLOUT_TOL = dict(rtol=2e-4, atol=1e-5)   # tests/test_parallel.py
PPO_TOL = dict(rtol=2e-4, atol=2e-5)       # tests/test_parallel.py


def _configs():
    return (jcfg.PRESETS["default"]().with_overrides(**_RATE0),
            tcfg.PRESETS["default"]().with_overrides(**_RATE0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what):
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f"{what}.{f}", **tol)


def test_sharded_rollouts_match_jax_on_eight_devices():
    jc, tc = _configs()
    jsrc = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    steps = 16
    jtr = jsrc.batch_trace(steps, range(0, B))
    jstates = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                           jinitial_state(jc))
    keys = jax.random.split(jax.random.key(0), B)
    jmesh = jpar.make_mesh(devices=jax.devices()[:8])
    jp = JSimParams.from_config(jc)
    jfn = JRulePolicy(jc.cluster).action_fn()
    jfinal, jmetrics = jpar.sharded_batched_rollout(
        jmesh, jp, jstates, jfn, jtr, keys, stochastic=True)
    _, jsummary = jpar.sharded_batched_rollout_summary(
        jmesh, jp, jstates, jfn, jtr, keys, stochastic=True)

    mesh = make_mesh(devices=["cpu"] * 8)
    params = SimParams.from_config(tc, device="cpu")
    traces = bridge.trace(_np(jtr)._asdict(), "cpu")
    fn = RulePolicy(tc.cluster, "cpu").action_fn()
    final, metrics = sharded_batched_rollout(
        mesh, params, initial_state(tc, B, "cpu"), fn, traces, 0,
        stochastic=True)
    assert isinstance(final, Sharded) and len(final.parts) == 8
    assert [p.nodes.shape[0] for p in final.parts] == [1] * 8
    _close(gather(final), jfinal, ROLLOUT_TOL, "final")
    _close(gather(metrics), jmetrics, ROLLOUT_TOL, "metrics")
    _, summary = sharded_batched_rollout_summary(
        mesh, params, initial_state(tc, B, "cpu"), fn, traces, 0,
        stochastic=True)
    _close(gather(summary), jsummary, ROLLOUT_TOL, "summary")


def _jax_noise(key, n_ticks: int, shape) -> np.ndarray:
    """The action noise of JAX's collect scan (``key, k_act, k_step =
    split(key, 3)`` a tick; `tests/test_torch_train.py::_jax_noise`)."""
    out = []
    for _ in range(n_ticks):
        key, k_act, _ = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.normal(k_act, shape)))
    return np.stack(out, axis=1)


@pytest.fixture(scope="module")
def ppo_runs():
    """One iteration from JAX's init on one window and one noise draw:
    JAX's on its 8-device mesh, the port's unsharded, on 8 shards and on
    a [2, 2] mesh."""
    jc, tc = _configs()
    jt = JTrainer(jc)
    j0 = jt.init_state(0)
    src = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    win = src.batch_trace(T + 1, range(5, 5 + B))
    tt = PPOTrainer(tc, device="cpu")
    noise = torch.from_numpy(_jax_noise(j0.key, T, (B, tt.act_dim)))
    jmesh = jpar.make_mesh(devices=jax.devices()[:8])
    jts, jdiag = jt._iteration_fn(jpar.shard_ppo_state(jmesh, j0),
                                  jpar.shard_batch(jmesh, win))
    window = bridge.trace(_np(win)._asdict(), "cpu")
    ts0 = tt.fresh_state(_np(j0.params))
    runs = {"one": tt.iteration(ts0, window, noise)}
    for name, mcfg in (("data", MeshConfig()),
                       ("data_model", MeshConfig(data_parallel=2,
                                                 model_parallel=2))):
        mesh = make_mesh(mcfg, devices=["cpu"] * 4 if mcfg.model_parallel
                         > 1 else ["cpu"] * 8)
        ts = shard_ppo_state(mesh, tt.fresh_state(_np(j0.params)))
        if mcfg.model_parallel > 1:
            ts = ts._replace(params=shard_params(mesh, ts.params))
        runs[name] = tt.iteration(ts, window, noise)
    jp = bridge.actor_critic_from_flax(_np(jts.params))
    return jdiag, jp, runs, tc


@pytest.mark.parametrize("name", ("data", "data_model"))
def test_sharded_ppo_matches_the_unsharded_iteration(ppo_runs, name):
    _, _, runs, _ = ppo_runs
    ts1, d1 = runs["one"]
    tsn, dn = runs[name]
    assert tsn.iteration == 1 and isinstance(tsn.env_states, Sharded)
    if name == "data_model":
        assert isinstance(tsn.params["Dense_0.weight"], ColumnSharded)
    for k, v in ts1.params.items():
        np.testing.assert_allclose(gather(tsn.params[k]).numpy(), v.numpy(),
                                   err_msg=k, **PPO_TOL)
    for f in ("mean_reward", "attainment"):
        np.testing.assert_allclose(float(getattr(dn, f)),
                                   float(getattr(d1, f)), rtol=1e-6)
    np.testing.assert_allclose(float(dn.policy_loss), float(d1.policy_loss),
                               rtol=2e-4)
    for f in ts1.env_states._fields:
        assert torch.equal(getattr(gather(tsn.env_states), f),
                           getattr(ts1.env_states, f)), f


@pytest.mark.parametrize("name", ("data", "data_model"))
def test_sharded_ppo_matches_jax_sharded_iteration(ppo_runs, name):
    jdiag, jp, runs, tc = ppo_runs
    ts, diag = runs[name]
    for f in ("mean_reward", "attainment"):
        np.testing.assert_allclose(float(getattr(diag, f)),
                                   float(getattr(jdiag, f)), rtol=2e-4)
    k = tc.train.ppo_epochs
    lr = tc.train.learning_rate
    for name_, want in jp.items():
        got = gather(ts.params[name_])
        d = (got - want).abs()
        assert float(d.max()) <= 2.0 * lr * k, name_
        assert float(d.median()) <= 0.2 * lr * k, name_


BI, TI = 8, 16
_RATE_HIGH = {"sim.spot_interruption_rate_hr": 60.0,
              "train.attain_target": 0.95, "train.batch_clusters": BI,
              "train.unroll_steps": TI}


@pytest.fixture(scope="module")
def ppo_interrupt_runs():
    """One port iteration from the same params, window and noise with
    interruptions on: unsharded, on 8 shards and on a [2, 2] mesh."""
    tc = tcfg.PRESETS["default"]().with_overrides(**_RATE_HIGH)
    tt = PPOTrainer(tc, device="cpu")
    src = TSource(tc.cluster, tc.workload, tc.sim, tc.signals)
    window = src.batch_trace(TI + 1, range(3, 3 + BI), device="cpu")
    noise = torch.randn((BI, TI, tt.act_dim),
                        generator=torch.Generator().manual_seed(4))
    runs = {"one": tt.iteration(tt.init_state(1), window, noise)}
    for name, mcfg in (("data", MeshConfig()),
                       ("data_model", MeshConfig(data_parallel=2,
                                                 model_parallel=2))):
        mesh = make_mesh(mcfg, devices=["cpu"] * 4 if mcfg.model_parallel
                         > 1 else ["cpu"] * 8)
        ts = shard_ppo_state(mesh, tt.init_state(1))
        if mcfg.model_parallel > 1:
            ts = ts._replace(params=shard_params(mesh, ts.params))
        runs[name] = tt.iteration(ts, window, noise)
    return runs


@pytest.mark.parametrize("name", ("data", "data_model"))
def test_sharded_ppo_draws_the_fleets_interruptions(ppo_interrupt_runs,
                                                    name):
    ts1, d1 = ppo_interrupt_runs["one"]
    tsn, dn = ppo_interrupt_runs[name]
    for f in ts1.env_states._fields:
        assert torch.equal(getattr(gather(tsn.env_states), f),
                           getattr(ts1.env_states, f)), f
    for f in ("mean_reward", "attainment"):
        np.testing.assert_allclose(float(getattr(dn, f)),
                                   float(getattr(d1, f)), rtol=1e-6,
                                   err_msg=f)
    for f in ("policy_loss", "value_loss", "approx_kl", "entropy"):
        np.testing.assert_allclose(float(getattr(dn, f)),
                                   float(getattr(d1, f)), err_msg=f,
                                   **PPO_TOL)
    np.testing.assert_allclose(tsn.violation_weight, ts1.violation_weight,
                               rtol=1e-6)
    for k, v in ts1.params.items():
        np.testing.assert_allclose(gather(tsn.params[k]).numpy(), v.numpy(),
                                   err_msg=k, **PPO_TOL)
