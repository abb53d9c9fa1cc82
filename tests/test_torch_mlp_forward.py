"""The MLP rollout kernel's forward, layer by layer, on the CPU: the plain
stage function (`sim/megakernel.py::mlp_stages`) against the MLP kernel's
plain action function and against the JAX package's packed-weights
helper, the forward wrapper's CPU route, and the comparator that holds the
kernel's forward on the card (`check_mlp_forward`, chip_smoke.py phase
5e)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu_torch.config as tcfg
from ccka_tpu_torch import bridge
from ccka_tpu_torch.models import latent_to_action
from ccka_tpu_torch.policy.base import observe
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.types import ClusterState, SimParams
from ccka_tpu_torch.train import checkpoint as ckpt
from ccka_tpu_torch.train.flagship import flagship_checkpoint_path

SHIPPED = (("default", "replay"), ("multiregion", ""))


def _shipped(preset: str, variant: str) -> dict:
    tree, _ = ckpt.load_params_npz(flagship_checkpoint_path(
        tcfg.PRESETS[preset](), variant=variant))
    return tree


def _random_net(rng, F: int, H: int, A: int) -> dict:
    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(
                    np.float32),
                "bias": (0.1 * rng.normal(size=(o,))).astype(np.float32)}

    return {"params": {"Dense_0": dense(F, H), "Dense_1": dense(H, H),
                       "actor_mean": dense(H, A)}}


def _observations(rng, preset: str, N: int):
    """(params, state, exo, obs [N, F]) of random fleets and signals at
    the simulator's scales (nodes O(10), pods O(60), $/hr O(0.1),
    gCO2/kWh O(500))."""
    cfg = tcfg.PRESETS[preset]()
    P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
    K = cfg.sim.provision_delay_steps
    params = SimParams.from_config(cfg, device="cpu")

    def f(*shape):
        return torch.tensor(rng.uniform(size=shape).astype(np.float32))

    state = ClusterState(
        nodes=torch.round(12.0 * f(N, P, Z, 2)),
        pipeline=torch.round(3.0 * f(N, K, P, Z, 2)),
        running=60.0 * f(N, 2), consol_timer_s=120.0 * f(N, P),
        time_s=30.0 * torch.round(2880.0 * f(N)), acc_cost_usd=f(N),
        acc_carbon_g=f(N), acc_requests=f(N), acc_slo_ok_s=f(N),
        acc_evictions=f(N))
    exo = ExoStep(spot_price_hr=0.02 + 0.07 * f(N, Z),
                  od_price_hr=torch.full((N, Z), 0.096),
                  carbon_g_kwh=200.0 + 350.0 * f(N, Z),
                  demand_pods=torch.round(70.0 * f(N, 2)),
                  is_peak=torch.round(f(N)))
    return cfg, params, state, exo, observe(params, state, exo).flatten()


def _pack(tree: dict) -> tuple:
    return mk._pack_mlp_tensors(tree, "cpu")


@pytest.mark.parametrize("preset,variant", SHIPPED)
def test_stage_latent_is_the_plain_action_fns(preset, variant):
    """mlp_stages' u, decoded, is bitwise the action
    kernel_numerics_action_fn returns on the same state and signals."""
    tree = _shipped(preset, variant)
    cfg, params, state, exo, obs = _observations(
        np.random.default_rng(11), preset, 96)
    stages = mk.mlp_stages(obs, tuple(w[0] for w in _pack(tree)))
    want = mk.kernel_numerics_action_fn(tree, cfg.cluster, params)(
        state, exo, 0)
    got = latent_to_action(stages.u, cfg.cluster)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    F = mk._obs_dim(cfg.cluster.n_pools, cfg.cluster.n_zones)
    assert [tuple(x.shape) for x in stages] == [
        (96, F), (96, 128), (96, 128), (96, 128), (96, 128),
        (96, mk._act_rows(cfg.cluster.n_pools, cfg.cluster.n_zones))]
    assert [x.dtype for x in stages] == [torch.bfloat16, torch.float32,
                                         torch.bfloat16, torch.float32,
                                         torch.bfloat16, torch.float32]


def _jax_forward(tree: dict, obs: np.ndarray, P: int, Z: int) -> dict:
    """The Pallas MLP kernel's forward on [N, F] observations, written with
    the JAX package's packed weights (`_pack_mlp_tensors`: w1 padded to
    F_pad rows, biases replicated over the lanes) as the kernel body
    computes it (`ccka_tpu/sim/megakernel.py:509-522`)."""
    stacked = jax.tree.map(lambda x: jnp.asarray(x)[None], tree)
    dims, _ = jmk._mlp_dims(stacked, P=P, Z=Z)
    F, F_pad, H, A = dims
    N = obs.shape[0]
    w1, b1, w2, b2, w3, b3 = (x[0] for x in jmk._pack_mlp_tensors(
        stacked, dims, N))
    o = jnp.concatenate([jnp.asarray(obs).T,
                         jnp.zeros((F_pad - F, N), jnp.float32)])
    x = (jnp.sign(o) * jnp.log1p(jnp.abs(o))).astype(jnp.bfloat16)
    dn = (((0,), (0,)), ((), ()))
    h1 = jax.nn.gelu(jax.lax.dot_general(
        w1, x, dn, preferred_element_type=jnp.float32
    ).astype(jnp.bfloat16) + b1)
    h2 = jax.nn.gelu(jax.lax.dot_general(
        w2, h1, dn, preferred_element_type=jnp.float32
    ).astype(jnp.bfloat16) + b2)
    u = jax.lax.dot_general(w3, h2.astype(jnp.float32), dn,
                            preferred_element_type=jnp.float32) + b3
    return {"h1": np.asarray(h1.astype(jnp.float32)).T,
            "h2": np.asarray(h2.astype(jnp.float32)).T,
            "u": np.asarray(u[:A]).T}


@pytest.mark.parametrize("preset,variant", SHIPPED)
def test_stages_match_the_jax_packed_weights_forward(preset, variant):
    """Seeded observations through mlp_stages and through the JAX
    package's packed weights: the latent decodes to actions within
    tests/test_torch_neural.py's 2e-2 relative per coordinate (a hidden
    unit may round one bf16 step apart where the two sums' orders differ),
    and at least 99 % of the hidden units are bitwise equal."""
    tree = _shipped(preset, variant)
    cfg, _, _, _, obs = _observations(np.random.default_rng(12), preset, 256)
    P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
    got = mk.mlp_stages(obs, tuple(w[0] for w in _pack(tree)))
    want = _jax_forward(tree, obs.numpy(), P, Z)
    for f in ("h1", "h2"):
        same = getattr(got, f).to(torch.float32).numpy() == want[f]
        assert same.mean() >= 0.99, (f, same.mean())
    a = latent_to_action(got.u, cfg.cluster)
    b = latent_to_action(torch.tensor(want["u"]), cfg.cluster)
    for f in a._fields:
        x, y = getattr(a, f).numpy(), getattr(b, f).numpy()
        assert np.max(np.abs(x - y) / (np.abs(y) + 1e-6)) < 2e-2, f


def test_forward_wrapper_runs_the_plain_stages_on_the_cpu():
    """On a CPU tensor mlp_forward is mlp_stages on member 0 and launches
    nothing."""
    from ccka_tpu_torch.kernels import build

    rng = np.random.default_rng(13)
    tree = _random_net(rng, 36, 128, 18)
    stacked = mk._tree_map(lambda x: np.stack([x, 0.5 * x]), tree)
    _, _, _, _, obs = _observations(rng, "multiregion", 40)
    before = build.launch_mlp_forward.launches
    got = mk.mlp_forward(obs, _pack(stacked))
    want = mk.mlp_stages(obs, tuple(w[0] for w in _pack(tree)))
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert build.launch_mlp_forward.launches == before


def _nudge(t: torch.Tensor, index, steps: int = 1) -> torch.Tensor:
    """``t`` with one element moved ``steps`` units in its last place."""
    out = t.clone()
    bits = out.view(torch.int16 if t.element_size() == 2 else torch.int32)
    bits[index] += steps
    return out


def _perturbed_forward(obs, weights, scale: float, rng) -> mk.MlpStages:
    """A forward that sums each layer in another order: each
    pre-activation moved by ``scale`` times the sum bound (random sign),
    every later stage computed from the moved one as the kernel computes
    its own."""
    w1, b1, w2, b2, w3, b3 = (w[0] for w in weights)
    x = mk.mlp_stages(obs, (w1, b1, w2, b2, w3, b3)).x

    def layer(inp, w):
        ref = mk._chained_product(inp.float(), w.float())
        bound = mk.MLP_SUM_BOUND * (inp.double().abs() @ w.double().abs())
        sign = torch.tensor(rng.choice([-1.0, 1.0], size=tuple(ref.shape)))
        return (ref.double() + scale * sign * bound).to(torch.float32)

    pre1 = layer(x, w1)
    h1 = mk._gelu_layer(pre1, b1)
    pre2 = layer(h1, w2)
    h2 = mk._gelu_layer(pre2, b2)
    u = mk._chained_product(h2.float(), w3) + b3
    return mk.MlpStages(x, pre1, h1, pre2, h2, u)


def test_forward_comparator_accepts_another_sum_order_only():
    """check_mlp_forward accepts pre-activations moved within the sum bound
    (and reports the bitwise shares against the plain forward), and
    refuses a pre-activation beyond it, a one-ulp change to either
    epilogue's output and a one-ulp change to the head's."""
    rng = np.random.default_rng(14)
    weights = _pack(_random_net(rng, 36, 128, 18))
    _, _, _, _, obs = _observations(rng, "multiregion", 64)
    plain = mk.mlp_stages(obs, tuple(w[0] for w in weights))
    exact = mk.check_mlp_forward(plain, obs, weights)
    assert set(exact["violations"].values()) == {0}
    assert exact["bitwise_share"] == {"h1": 1.0, "h2": 1.0, "u": 1.0}
    assert exact["u_max_abs_diff"] == 0.0

    moved = _perturbed_forward(obs, weights, 0.9, rng)
    rep = mk.check_mlp_forward(moved, obs, weights)
    assert set(rep["violations"].values()) == {0}, rep["violations"]
    assert 0.5 < rep["sum_bound_use"]["pre1"] <= 1.0
    assert rep["bitwise_share"]["h1"] < 1.0

    beyond = _perturbed_forward(obs, weights, 4.0, rng)
    assert mk.check_mlp_forward(beyond, obs, weights)["violations"]["pre1"]
    for field, want in (("h1", "h1"), ("h2", "h2"), ("u", "u"),
                        ("x", "x")):
        bad = moved._replace(**{field: _nudge(getattr(moved, field),
                                              (5, 3))})
        v = mk.check_mlp_forward(bad, obs, weights)["violations"]
        assert v[want] == 1, (field, v)


def test_forward_departures_name_what_breaks_bitwise_rounding():
    """mlp_forward_departures is empty on the plain forward; a forward
    whose sums sit inside the near-tie window (1/32 of the sum bound)
    leaves the premise standing, and one at 0.9 of the bound names the
    layers past the window and the fields no longer bitwise the plain
    forward."""
    rng = np.random.default_rng(15)
    weights = _pack(_random_net(rng, 36, 128, 18))
    _, _, _, _, obs = _observations(rng, "multiregion", 64)
    plain = mk.mlp_stages(obs, tuple(w[0] for w in weights))
    assert mk.mlp_forward_departures(
        mk.check_mlp_forward(plain, obs, weights)) == {}

    inside = mk.check_mlp_forward(
        _perturbed_forward(obs, weights, 1 / 32, rng), obs, weights)
    assert set(inside["violations"].values()) == {0}
    assert not any(k.startswith("sum_bound_use_")
                   for k in mk.mlp_forward_departures(inside))

    far = mk.check_mlp_forward(
        _perturbed_forward(obs, weights, 0.9, rng), obs, weights)
    assert set(far["violations"].values()) == {0}
    got = mk.mlp_forward_departures(far)
    assert {"sum_bound_use_pre1", "sum_bound_use_pre2",
            "bitwise_share_h1"} <= set(got), got
