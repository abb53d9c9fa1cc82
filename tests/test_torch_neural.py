"""The port's learned-policy path against the JAX package on the same
inputs: the latent codec, the ActorCritic forward with bridged weights,
the MLP kernel's plain version against JAX's and against the interpret-mode
Pallas kernel, the population axis, the npz checkpoints and the shipped
flagship loaders."""

from __future__ import annotations

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu.train.checkpoint as jckpt
import ccka_tpu_torch.config as tcfg
from ccka_tpu.models import ActorCritic as JActorCritic
from ccka_tpu.models import action_to_latent as jaction_to_latent
from ccka_tpu.models import latent_dim as jlatent_dim
from ccka_tpu.models import latent_to_action as jlatent_to_action
from ccka_tpu.models import nets as jnets
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim.dynamics import ExoStep as JExoStep
from ccka_tpu.sim.rollout import batched_rollout_summary as jbatched_rollout
from ccka_tpu.sim.rollout import initial_state as jinitial_state
from ccka_tpu.sim.types import ClusterState as JClusterState
from ccka_tpu.train.flagship import flagship_checkpoint_path as jflagship_path
from ccka_tpu_torch import bridge
from ccka_tpu_torch.models import (ActorCritic, PolicyMLP, action_to_latent,
                                   latent_dim, latent_to_action)
from ccka_tpu_torch.models import nets
from ccka_tpu_torch.policy.base import observe
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.rollout import batched_rollout_summary, initial_state
from ccka_tpu_torch.sim.types import ClusterState
from ccka_tpu_torch.train import checkpoint as ckpt
from ccka_tpu_torch.train.flagship import (flagship_checkpoint_path,
                                           load_flagship_backend)
from ccka_tpu_torch.train.ppo import PPOBackend

# (preset, shipped checkpoint variant) for each template topology.
SHIPPED = (("default", "replay"), ("multiregion", ""))
# tests/test_megakernel.py::test_short_horizon_exact's standard.
LOOSE = {"evictions": 2e-2, "queue_depth_mean": 2e-2, "interruptions": 2e-2,
         "spot_exposure": 2e-2, "waste_frac": 2e-2}


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def _shipped_params(preset: str, variant: str):
    tree, _ = ckpt.load_params_npz(flagship_checkpoint_path(
        tcfg.PRESETS[preset](), variant=variant))
    return tree


def _random_state_and_signals(rng, B, P, Z, K):
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    state = dict(
        nodes=5.0 * f(B, P, Z, 2), pipeline=2.0 * f(B, K, P, Z, 2),
        running=30.0 * f(B, 2), consol_timer_s=120.0 * f(B, P),
        time_s=30.0 * np.round(2000.0 * f(B)), acc_cost_usd=f(B),
        acc_carbon_g=100 * f(B), acc_requests=1e3 * f(B),
        acc_slo_ok_s=600 * f(B), acc_evictions=f(B))
    exo = dict(
        spot_price_hr=0.02 + 0.06 * f(B, Z),
        od_price_hr=np.full((B, Z), 0.096, np.float32),
        carbon_g_kwh=200 + 300 * f(B, Z),
        demand_pods=np.round(40.0 * f(B, 2)),
        is_peak=np.round(f(B)))
    return state, exo


# ---- the latent codec


@pytest.mark.parametrize("preset", ("default", "multiregion"))
def test_latent_codec_matches_jax_and_round_trips(preset):
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    A = latent_dim(tc.cluster)
    assert A == jlatent_dim(jc.cluster)
    u = np.random.default_rng(8).normal(0, 2.5, (48, A)).astype(np.float32)
    u[:4, :jc.cluster.n_pools * jc.cluster.n_zones] = -12.0  # zone collapse
    want = jax.vmap(lambda x: jlatent_to_action(x, jc.cluster))(u)
    got = latent_to_action(torch.tensor(u), tc.cluster)
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert torch.all(got.zone_weight[:4] == 1.0)
    back = action_to_latent(got, tc.cluster)
    jback = jax.vmap(lambda a: jaction_to_latent(a, jc.cluster))(want)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-5,
                               atol=1e-5)
    # Round trip: decoding the re-encoded action gives the action again.
    again = latent_to_action(back, tc.cluster)
    for f in got._fields:
        np.testing.assert_allclose(getattr(again, f).numpy(),
                                   getattr(got, f).numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=f)
    assert (nets.HPA_LO, nets.HPA_HI, nets.HPA_BIAS, nets.AFTER_MAX_S) == (
        jnets.HPA_LO, jnets.HPA_HI, jnets.HPA_BIAS, jnets.AFTER_MAX_S)
    x = np.random.default_rng(1).normal(0, 50, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(nets._normalize_obs(torch.tensor(x)).numpy(),
                               np.asarray(jnets._normalize_obs(x)),
                               rtol=1e-6)


# ---- the nets


def test_gelu_tanh_is_jax_gelu_on_bf16():
    """On bf16 values `gelu_tanh` equals `jax.nn.gelu` bit for bit: both
    round after every operation. PyTorch's own tanh-form GELU computes in
    float32 and rounds once, which is one bf16 step away on more than a
    quarter of these inputs: the reason the port does not use it. On
    float32 the two forms agree."""
    v = np.random.default_rng(0).normal(0, 3, 200_000).astype(np.float32)
    x = torch.tensor(v).to(torch.bfloat16)
    want = np.asarray(jax.nn.gelu(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ).astype(jnp.float32))
    got = nets.gelu_tanh(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    once = torch.nn.functional.gelu(x, approximate="tanh").float().numpy()
    assert (once != want).mean() > 0.25
    np.testing.assert_allclose(
        nets.gelu_tanh(torch.tensor(v)).numpy(),
        torch.nn.functional.gelu(torch.tensor(v), approximate="tanh"),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("preset,variant", SHIPPED)
def test_actor_critic_forward_matches_flax(preset, variant):
    """Bridged shipped weights, the same observations: the mean within
    0.05 in latent units (a bf16 torso may round at other places in two
    frameworks; measured 1.0e-5 and 4.8e-6 here, since the port rounds
    where flax does), log_std and the shapes exact; the critic's value
    within 1e-3 + 1e-5 relative (measured 6.1e-5 on values of 23 to 583)."""
    jc = jcfg.PRESETS[preset]()
    tree = _shipped_params(preset, variant)
    P, Z, K = jc.cluster.n_pools, jc.cluster.n_zones, \
        jc.sim.provision_delay_steps
    A = jlatent_dim(jc.cluster)
    state, exo = _random_state_and_signals(np.random.default_rng(3), 256,
                                           P, Z, K)
    jp = JSimParams.from_config(jc)
    tp = bridge.sim_params(_np(jp), device="cpu")
    obs = observe(tp, ClusterState(**{k: torch.tensor(v)
                                      for k, v in state.items()}),
                  ExoStep(**{k: torch.tensor(v) for k, v in exo.items()})
                  ).flatten()
    assert obs.shape == (256, mk._obs_dim(P, Z))
    jmean, jlog_std, jvalue = JActorCritic(act_dim=A).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(obs.numpy()))
    net = ActorCritic(obs.shape[1], A)
    net.load_state_dict(bridge.actor_critic_from_flax(tree))
    with torch.no_grad():
        mean, log_std, value = net(obs)
    assert mean.dtype == torch.float32 and tuple(mean.shape) == jmean.shape
    assert tuple(value.shape) == jvalue.shape == (256,)
    diff = float(np.max(np.abs(mean.numpy() - np.asarray(jmean))))
    assert diff < 0.05, diff
    np.testing.assert_array_equal(log_std.detach().numpy(),
                                  np.asarray(jlog_std))
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-3,
                               rtol=1e-5)


def test_bridge_round_trips_and_keeps_a_population_axis():
    tree = _shipped_params("multiregion", "")
    state = bridge.actor_critic_from_flax(tree)
    assert tuple(state["Dense_0.weight"].shape) == (128, 36)
    assert tuple(state["actor_mean.weight"].shape) == (18, 128)
    back = bridge.actor_critic_to_flax(state)
    assert ckpt.params_digest(back) == ckpt.params_digest(tree)
    stacked = mk._tree_map(lambda x: np.stack([x, 0.5 * x]), tree)
    pop = bridge.actor_critic_from_flax(stacked)
    assert tuple(pop["Dense_1.weight"].shape) == (2, 128, 128)
    assert tuple(pop["log_std"].shape) == (2, 18)
    assert torch.equal(pop["Dense_0.weight"][0], state["Dense_0.weight"])
    assert ckpt.params_digest(bridge.actor_critic_to_flax(pop)) == \
        ckpt.params_digest(stacked)
    with pytest.raises(ValueError, match="unknown ActorCritic"):
        bridge.actor_critic_from_flax({"params": {"gru": {}}})


def test_policy_mlp_starts_at_the_codec_zero_point():
    net = PolicyMLP(29, 16)
    with torch.no_grad():
        u = net(torch.rand(7, 29) * 100.0)
    assert u.dtype == torch.float32 and tuple(u.shape) == (7, 16)
    assert torch.all(u == 0.0)
    act = latent_to_action(u, tcfg.default_config().cluster)
    np.testing.assert_allclose(act.hpa_scale.numpy(), 1.0, rtol=1e-6)


# ---- the MLP kernel's plain version


@pytest.mark.parametrize("preset,variant", SHIPPED)
def test_kernel_numerics_action_fn_matches_jax(preset, variant):
    """The same states and signals through both packages' kernel-numerics
    helpers: every action coordinate within 2e-2 relative (a bf16 rounding
    boundary may flip a hidden unit by one step; measured 5.9e-3 at worst
    with the replay net and 3.8e-6 with the multiregion one on these
    inputs)."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    tree = _shipped_params(preset, variant)
    P, Z, K = jc.cluster.n_pools, jc.cluster.n_zones, \
        jc.sim.provision_delay_steps
    state, exo = _random_state_and_signals(np.random.default_rng(6), 256,
                                           P, Z, K)
    jp = JSimParams.from_config(jc)
    jfn = jmk.kernel_numerics_action_fn(jax.tree.map(jnp.asarray, tree),
                                        jc.cluster, jp)
    want = jax.vmap(lambda s, e: jfn(s, e, jnp.int32(0)))(
        JClusterState(**state), JExoStep(**exo))
    tp = bridge.sim_params(_np(jp), device="cpu")
    got = mk.kernel_numerics_action_fn(tree, tc.cluster, tp)(
        ClusterState(**{k: torch.tensor(v) for k, v in state.items()}),
        ExoStep(**{k: torch.tensor(v) for k, v in exo.items()}), 0)
    worst = 0.0
    for f in want._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        worst = max(worst, float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6))))
    assert worst < 2e-2, worst


class _World:
    def __init__(self, preset: str, variant: str, B: int, T: int):
        self.jc = jcfg.PRESETS[preset]()
        self.tc = tcfg.PRESETS[preset]()
        self.jp = JSimParams.from_config(self.jc)
        self.tp = bridge.sim_params(_np(self.jp), device="cpu")
        src = JSource(self.jc.cluster, self.jc.workload, self.jc.sim,
                      self.jc.signals)
        self.jtr = src.batch_trace(T, range(300, 300 + B))
        self.ttr = bridge.trace(_np(self.jtr), device="cpu")
        self.tree = _shipped_params(preset, variant)
        self.B, self.T = B, T

    def jax_kernel(self, jtree=None):
        """The Pallas mlp kernel in interpret mode, deterministic."""
        return jmk.neural_megakernel_rollout_summary(
            self.jp, self.jc.cluster,
            jax.tree.map(jnp.asarray, self.tree) if jtree is None else jtree,
            self.jtr, stochastic=False, b_block=128,
            t_chunk=min(16, self.T), interpret=True)

    def jax_lax(self):
        """The JAX lax rollout under JAX's `kernel_numerics_action_fn`."""
        states = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (self.B,) + x.shape),
            jinitial_state(self.jc))
        return jbatched_rollout(
            self.jp, states,
            jmk.kernel_numerics_action_fn(
                jax.tree.map(jnp.asarray, self.tree), self.jc.cluster,
                self.jp),
            self.jtr, jax.random.split(jax.random.key(0), self.B),
            stochastic=False)[1]

    def port(self, tree=None, **kw):
        return mk.neural_megakernel_rollout_summary(
            self.tp, self.tc.cluster, self.tree if tree is None else tree,
            self.ttr, device="cpu", **kw)


@pytest.fixture(scope="module", params=SHIPPED, ids=lambda p: p[0])
def world(request):
    return _World(*request.param, 128, 32)


def test_short_horizon_rollout_matches_interpret_kernel(world):
    """B = 128 x T = 32, deterministic, the shipped nets: the port's plain
    version against the Pallas mlp kernel in interpret mode, at the
    standard of tests/test_megakernel.py::test_short_horizon_exact (1e-3
    per cluster and field, five near-zero-denominator fields 2e-2).

    With the shipped nets no two implementations hold that for every
    cluster, the JAX package's own two included (its kernel against its
    lax path under `kernel_numerics_action_fn` leaves 18 and 5 of these
    128 clusters outside): a sum in another order flips a hidden unit by
    one bf16 step, which moves an action by a part in a thousand, and the
    trained policies ride the SLO threshold, where such a nudge flips one
    tick of 32. So here: at least 97 % of clusters within the standard on
    every field (measured 127 and 126 of 128), every batch mean within it,
    and ``evictions``, whose totals here are about 0.005 pods, within 5e-3
    pods instead of relatively. The standard itself, on every cluster, is
    held by `test_short_horizon_exact_with_the_jax_tests_net` on the net
    it was set for, and by `test_two_ticks_match_the_jax_lax_path` on the
    shipped nets before feedback amplifies a flip. The port's plain
    version is also held to be no further from JAX's lax path than JAX's
    kernel is (4 and 1 clusters outside). ``PYTHONPATH=. python
    tests/test_torch_neural.py`` prints these counts and the tick at
    which each outlier leaves the standard."""
    w = world
    before = mk.neural_megakernel_summary_from_packed.launches
    port = w.port(stochastic=False)
    kern = w.jax_kernel()
    lax_path = w.jax_lax()
    assert _outside(_numpy(port), lax_path).sum() <= \
        _outside(kern, lax_path).sum()
    ok = np.ones(w.B, bool)
    for f in kern._fields:
        a = getattr(port, f).numpy().astype(np.float64)
        b = np.asarray(getattr(kern, f), np.float64)
        assert a.shape == b.shape == (w.B,), f
        tol = LOOSE.get(f, 1e-3)
        if f == "evictions":
            assert np.abs(a - b).max() < 5e-3
        else:
            ok &= np.abs(a - b) / (np.abs(b) + 1e-6) <= tol
        assert abs(a.mean() - b.mean()) <= tol * (abs(b.mean()) + 1e-6), f
    assert ok.mean() >= 0.97, ok.mean()
    assert mk.neural_megakernel_summary_from_packed.launches == before


def _numpy(summary):
    return type(summary)(*(x.numpy() for x in summary))


def _outside(got, want, skip=()) -> np.ndarray:
    """[B] bool: clusters with a field (not in ``skip``) outside the
    short-horizon standard, 1e-3 relative, LOOSE fields 2e-2."""
    bad = None
    for f in want._fields:
        if f in skip:
            continue
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        out = np.abs(a - b) / (np.abs(b) + 1e-6) > LOOSE.get(f, 1e-3)
        bad = out if bad is None else bad | out
    return bad


def _assert_short_horizon_standard(got, want, B: int) -> float:
    """Every field of every cluster within 1e-3 relative (LOOSE fields
    2e-2); returns the largest difference as a share of its tolerance."""
    worst = 0.0
    for f in want._fields:
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(want, f), np.float64)
        assert a.shape == b.shape == (B,), f
        rel = np.abs(a - b) / (np.abs(b) + 1e-6)
        tol = LOOSE.get(f, 1e-3)
        assert rel.max() <= tol, (f, int(rel.argmax()), rel.max())
        worst = max(worst, float(rel.max() / tol))
    return worst


def _perturbed_net_params(jc, seed: int = 3, scale: float = 0.3):
    """The net tests/test_megakernel.py sets its short-horizon standard
    on: a fresh ActorCritic with every leaf perturbed by 0.3 * normal."""
    import zlib

    net = JActorCritic(act_dim=jlatent_dim(jc.cluster))
    key = jax.random.key(seed)
    p0 = net.init(key, jnp.zeros(
        (jmk._obs_dim(jc.cluster.n_pools, jc.cluster.n_zones),)))
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + scale * jax.random.normal(
            jax.random.fold_in(key, zlib.crc32(str(path).encode())
                               % (2 ** 31)), x.shape),
        p0)


def test_short_horizon_exact_with_the_jax_tests_net(world):
    """tests/test_megakernel.py::test_short_horizon_exact's standard, on
    its net and size (B = 128 x T = 32, deterministic), for every cluster
    and field: the port's plain version against the Pallas mlp kernel in
    interpret mode. Measured largest difference 3.9e-7 (default) and
    1.2e-4 (multiregion) relative."""
    w = world
    jtree = _perturbed_net_params(w.jc)
    port = w.port(jax.tree.map(np.array, jtree), stochastic=False)
    _assert_short_horizon_standard(_numpy(port), w.jax_kernel(jtree), w.B)


@pytest.mark.parametrize("preset,variant", SHIPPED)
def test_two_ticks_match_the_jax_lax_path(preset, variant):
    """The shipped nets over two ticks, before feedback amplifies a
    rounding flip: the port's plain version against the JAX lax rollout
    under JAX's `kernel_numerics_action_fn`, every cluster and field at the
    short-horizon standard (measured 3.0e-5 and 1.6e-4 relative at worst;
    JAX's interpret-mode kernel sits 4.9e-4 and 7.9e-4 from the same lax
    path)."""
    w = _World(preset, variant, 128, 2)
    worst = _assert_short_horizon_standard(
        _numpy(w.port(stochastic=False)), w.jax_lax(), w.B)
    assert worst < 0.5, worst


def test_population_axis(world):
    """Stacked members give [NP, B] fields: member 0 is the single run,
    member 1 (weights halved) another policy; a single tree gives [B]."""
    w = world
    stacked = mk._tree_map(lambda x: np.stack([x, 0.5 * x]), w.tree)
    single = w.port(seed=4, stochastic=True)
    pop = w.port(stacked, seed=4, stochastic=True)
    assert tuple(single.cost_usd.shape) == (w.B,)
    assert tuple(pop.cost_usd.shape) == (2, w.B)
    for f in single._fields:
        np.testing.assert_allclose(getattr(pop, f)[0].numpy(),
                                   getattr(single, f).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert float((pop.cost_usd[1] - pop.cost_usd[0]).abs().max()) > 0
    # Paired worlds: the policy never enters the Philox coordinates, so
    # both members see the same interruption draws as long as their spot
    # fleets agree, which they do on the first tick.
    one = [mk.neural_megakernel_summary_from_packed(
        w.tp, w.tc.cluster, stacked, mk._pack_exo(w.ttr, w.T), 1, seed=4)
        .interruptions for _ in range(2)]
    assert torch.equal(one[0], one[1])


def test_wrong_nets_are_refused():
    w = _World("default", "replay", 4, 4)
    wrong = _shipped_params("multiregion", "")
    with pytest.raises(ValueError, match="obs dim"):
        w.port(wrong)
    with pytest.raises(ValueError, match="obs dim"):
        mk.kernel_numerics_action_fn(wrong, w.tc.cluster, w.tp)
    deeper = {"params": dict(w.tree["params"],
                             Dense_2=w.tree["params"]["Dense_1"])}
    with pytest.raises(ValueError, match="two torso layers"):
        w.port(deeper)
    narrow = {"params": dict(
        w.tree["params"],
        actor_mean={"kernel": np.zeros((128, 5), np.float32),
                    "bias": np.zeros((5,), np.float32)})}
    with pytest.raises(ValueError, match="latent dim"):
        w.port(narrow)
    assert mk._obs_dim(2, 3) == jmk._obs_dim(2, 3) == 29
    assert mk._obs_dim(2, 4) == jmk._obs_dim(2, 4) == 36
    assert mk.NEURAL_MEAN_PARITY_TOLERANCES == \
        jmk.NEURAL_MEAN_PARITY_TOLERANCES
    weights = mk._pack_mlp_tensors(w.tree, "cpu")
    assert [tuple(x.shape) for x in weights] == [
        (1, 29, 128), (1, 128), (1, 128, 128), (1, 128), (1, 128, 16),
        (1, 16)]
    assert [x.dtype for x in weights] == [torch.bfloat16] * 4 + \
        [torch.float32] * 2


def test_ppo_backend_agrees_with_kernel_numerics_at_distribution_level():
    """The nn.Module forward is a third implementation: over a fleet and
    a short day its rollout means sit within the learned policy's parity
    table of the kernel-numerics rollout."""
    w = _World("multiregion", "", 128, 96)
    backend = PPOBackend(w.tc, w.tree, device="cpu")
    via_module = batched_rollout_summary(
        w.tp, initial_state(w.tc, w.B, device="cpu"), backend.action_fn(),
        w.ttr, 0, stochastic=False)[1]
    via_numerics = w.port(stochastic=False)
    assert mk.mean_parity_violations(
        via_numerics, via_module, mk.NEURAL_MEAN_PARITY_TOLERANCES) == {}


# ---- checkpoints


def test_params_digest_and_npz_round_trip_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"Dense_0": {"kernel": rng.normal(size=(5, 3)).astype(
        np.float32), "bias": np.zeros(3, np.float32)},
        "log_std": np.full(2, -0.5, np.float32)},
        "stack": [np.arange(4, dtype=np.int32), np.float32(2.5)]}
    assert ckpt.params_digest(tree) == jckpt.params_digest(tree)
    as_tensors = dict(tree, params=mk._tree_map(torch.as_tensor,
                                                tree["params"]))
    assert ckpt.params_digest(as_tensors) == ckpt.params_digest(tree)
    assert ckpt.PARAMS_DIGEST_KEY == jckpt.PARAMS_DIGEST_KEY

    path = ckpt.save_params_npz(str(tmp_path / "a" / "p.npz"),
                                tree["params"], meta={"note": "x"})
    loaded, meta = ckpt.load_params_npz(path)
    assert meta["note"] == "x"
    assert meta[ckpt.PARAMS_DIGEST_KEY] == ckpt.params_digest(tree["params"])
    assert ckpt.params_digest(loaded) == ckpt.params_digest(tree["params"])
    # Either package reads the other's file and verifies its digest.
    jloaded, jmeta = jckpt.load_params_npz(path)
    assert jmeta == meta
    assert jckpt.params_digest(jloaded) == ckpt.params_digest(loaded)
    jpath = jckpt.save_params_npz(str(tmp_path / "j.npz"), tree["params"])
    assert ckpt.params_digest(ckpt.load_params_npz(jpath)[0]) == \
        ckpt.params_digest(tree["params"])


def test_tampered_checkpoint_is_refused(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    path = ckpt.save_params_npz(str(tmp_path / "p.npz"), tree)
    with np.load(path) as z:
        entries = {k: z[k] for k in z.files}
    entries["w"] = entries["w"] + 1.0
    np.savez(path, **entries)
    with pytest.raises(ValueError, match="digest mismatch"):
        ckpt.load_params_npz(path)
    # A file without a digest (saved before the key existed) loads.
    del entries["__meta__"]
    np.savez(path, **entries)
    loaded, meta = ckpt.load_params_npz(path)
    assert meta == {} and loaded["w"][0, 0] == 1.0


@pytest.mark.parametrize("preset,variant", SHIPPED)
def test_shipped_checkpoints_are_byte_copies_and_load(preset, variant):
    ours = flagship_checkpoint_path(tcfg.PRESETS[preset](), variant=variant)
    theirs = jflagship_path(jcfg.PRESETS[preset](), variant=variant)
    assert os.path.dirname(ours).endswith(
        os.path.join("ccka_tpu_torch", "checkpoints"))

    def sha(path):
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    assert sha(ours) == sha(theirs)
    tree, meta = ckpt.load_params_npz(ours)       # digest-less, legacy
    assert ckpt.PARAMS_DIGEST_KEY not in meta
    jtree, jmeta = jckpt.load_params_npz(theirs)
    assert meta == jmeta
    assert ckpt.params_digest(tree) == jckpt.params_digest(jtree)


def test_load_flagship_backend_picks_the_topologys_file(capsys):
    cfg = tcfg.PRESETS["multiregion"]()
    assert os.path.basename(flagship_checkpoint_path(cfg)) == \
        "ppo_flagship_multiregion.npz"
    backend, meta = load_flagship_backend(cfg, device="cpu")
    assert "ppo_flagship_multiregion.npz" in capsys.readouterr().err
    assert isinstance(backend, PPOBackend) and "selected_iteration" in meta
    assert backend.params["params"]["Dense_0"]["kernel"].shape == (36, 128)
    state = initial_state(cfg, 3, device="cpu")
    exo = ExoStep(torch.full((3, 4), 0.03), torch.full((3, 4), 0.096),
                  torch.full((3, 4), 400.0), torch.full((3, 2), 20.0),
                  torch.ones(3))
    act = backend.decide(state, exo, 0)
    assert tuple(act.zone_weight.shape) == (3, 2, 4)
    assert torch.isfinite(act.hpa_scale).all()
    replay, _ = load_flagship_backend(tcfg.default_config(),
                                      variant="replay", device="cpu")
    assert replay.params["params"]["Dense_0"]["kernel"].shape == (29, 128)
    # No flagship ships for the plain default topology.
    assert load_flagship_backend(tcfg.default_config(),
                                 device="cpu") == (None, None)


def _report() -> None:
    """Print, for each shipped net at B = 128, deterministic: how many
    clusters each pair of implementations leaves outside the short-horizon
    standard at T = 32 (all fields relative; port against kernel also with
    ``evictions`` left out, as the test holds it absolutely), and for each
    cluster outside port-against-kernel the first horizon T at which it is
    outside, with its worst field there."""
    for preset, variant in SHIPPED:
        w = _World(preset, variant, 128, 32)
        port, kern, lax_path = _numpy(w.port(stochastic=False)), \
            w.jax_kernel(), w.jax_lax()
        watch = np.nonzero(_outside(port, kern, skip=("evictions",)))[0]
        print(f"{preset} T=32 clusters outside: jax kernel vs jax lax "
              f"{_outside(kern, lax_path).sum()}, port vs jax lax "
              f"{_outside(port, lax_path).sum()}, port vs jax kernel "
              f"{_outside(port, kern).sum()} (without evictions "
              f"{watch.tolist()})")
        first = {}
        for T in range(2, 33):
            w = _World(preset, variant, 128, T)
            port, kern = _numpy(w.port(stochastic=False)), w.jax_kernel()
            for c in watch:
                if c in first:
                    continue
                rel = {f: abs(getattr(port, f)[c] - np.asarray(
                    getattr(kern, f))[c]) / (abs(np.asarray(
                        getattr(kern, f))[c]) + 1e-6) / LOOSE.get(f, 1e-3)
                    for f in kern._fields if f != "evictions"}
                f = max(rel, key=rel.get)
                if rel[f] > 1.0:
                    first[c] = T
                    print(f"  cluster {c}: outside from T={T} on {f}: "
                          f"{getattr(port, f)[c]} against "
                          f"{np.asarray(getattr(kern, f))[c]}")


if __name__ == "__main__":
    _report()
