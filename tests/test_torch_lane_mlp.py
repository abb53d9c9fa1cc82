"""The port's learned-policy rollout on JAX's own widened streams: the
MLP kernel's plain version (`kernel_numerics_action_fn` under the plain
rollout, held signals fed to the net during outages) against the JAX lax
path and the interpret-mode mlp kernel, on the severe fault stream and on
the mixed scenario (faults and workloads), multiregion."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import ccka_tpu.sim.megakernel as jmk
from ccka_tpu.faults.process import unpack_fault_lanes as junpack_faults
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim.rollout import batched_rollout_summary as jrollout
from ccka_tpu_torch.sim import megakernel as mk
from test_torch_faults import B, KERNEL_KW
from test_torch_faults import _Streams as _FaultStreams
from test_torch_workloads import _Streams as _WorkloadStreams


def _perturbed_net_params(jc, seed: int = 3, scale: float = 0.3):
    """tests/test_megakernel.py's short-horizon net: a fresh ActorCritic
    with every leaf perturbed by 0.3 * normal."""
    import zlib

    from ccka_tpu.models import ActorCritic, latent_dim

    net = ActorCritic(act_dim=latent_dim(jc.cluster))
    key = jax.random.key(seed)
    p0 = net.init(key, jnp.zeros(
        (jmk._obs_dim(jc.cluster.n_pools, jc.cluster.n_zones),)))
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + scale * jax.random.normal(
            jax.random.fold_in(key, zlib.crc32(str(path).encode())
                               % (2 ** 31)), x.shape), p0)


# tests/test_megakernel.py::test_short_horizon_exact's standard.
SHORT_LOOSE = {"evictions": 2e-2, "queue_depth_mean": 2e-2,
               "interruptions": 2e-2, "spot_exposure": 2e-2,
               "waste_frac": 2e-2}


def assert_short_horizon_standard(port, ref, absolute=None) -> float:
    """Every field of every cluster within 1e-3 relative (five fields
    2e-2), or within ``absolute[field]`` for the fields named there;
    returns the worst relative difference of the others."""
    worst = 0.0
    for f in ref._fields:
        a = getattr(port, f).detach().numpy().astype(np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        if f in (absolute or {}):
            assert np.abs(a - b).max() <= absolute[f], f
            continue
        rel = float((np.abs(a - b) / (np.abs(b) + 1e-6)).max())
        assert rel <= SHORT_LOOSE.get(f, 1e-3), (f, rel)
        worst = max(worst, rel)
    return worst


def _jax_mlp_lax(s, tree, T):
    """JAX's lax rollout under its `kernel_numerics_action_fn` on the
    severe stream of ``s`` (fault streams), held signals fed to the
    net."""
    states = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                          jinitial_state(s.jc))
    return jrollout(
        s.jp, states, jmk.kernel_numerics_action_fn(tree, s.jc.cluster,
                                                    s.jp),
        jmk.unpack_exo(s.j["severe"], T, s.Z),
        jax.random.split(jax.random.key(0), B), stochastic=False,
        faults=junpack_faults(s.j["severe"], T, s.Z))[1]


def test_mlp_on_a_severe_stream_matches_jax():
    """The learned policy on JAX's severe multiregion stream. With the
    net the JAX tests set their short-horizon standard on, at T = 32:
    every cluster within it against the JAX lax path under JAX's
    `kernel_numerics_action_fn` (held signals fed to the net) and against
    the interpret-mode mlp kernel, with ``denials`` held within 1e-5 nodes
    absolutely on both (totals ~2.5e-4 nodes, on which JAX's own kernel
    and lax path differ by 2.1 % relative). With the shipped flagship,
    every cluster at T = 2 against the lax path."""
    s = _FaultStreams("multiregion")
    jtree = _perturbed_net_params(s.jc)
    port = mk.neural_megakernel_summary_from_packed(
        s.tp, s.tc.cluster, jax.tree.map(np.array, jtree), s.t("severe"),
        32, seed=3, stochastic=False)
    kern = jmk.neural_megakernel_summary_from_packed(
        s.jp, s.jc.cluster, jtree, s.j["severe"], 32, seed=3,
        **dict(KERNEL_KW, b_block=16))
    worst = (assert_short_horizon_standard(port, _jax_mlp_lax(s, jtree, 32),
                                           {"denials": 1e-5}),
             assert_short_horizon_standard(port, kern, {"denials": 1e-5}))

    from ccka_tpu.train.flagship import load_flagship_backend as jload
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    port2 = mk.neural_megakernel_summary_from_packed(
        s.tp, s.tc.cluster, load_flagship_backend(s.tc, device="cpu")[0]
        .params, s.t("severe"), 2, seed=3, stochastic=False)
    worst2 = assert_short_horizon_standard(
        port2, _jax_mlp_lax(s, jload(s.jc)[0].params, 2))
    print(f"\n# mlp severe: worst rel {worst[0]:.3g} vs lax and "
          f"{worst[1]:.3g} vs kernel (T=32, test net), {worst2:.3g} "
          f"(T=2, flagship)")


def test_mlp_on_a_mixed_stream_matches_jax():
    """The learned policy on JAX's mixed multiregion stream (faults and
    workloads): the JAX tests' net over T = 32 against the JAX lax path
    and the interpret-mode kernel (every cluster, the short-horizon
    standard, ``denials`` within 1e-5 nodes absolutely); the shipped
    flagship over T = 2 against the lax path."""
    from ccka_tpu.train.flagship import load_flagship_backend as jload
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    s = _WorkloadStreams("multiregion")
    jtree = _perturbed_net_params(s.jc)
    port = mk.neural_megakernel_summary_from_packed(
        s.tp["mixed"], s.tc.cluster, jax.tree.map(np.array, jtree),
        s.t("mixed"), 32, seed=3, stochastic=False)
    lax32 = s.jax_lax("mixed", jmk.kernel_numerics_action_fn(
        jtree, s.jc.cluster, s.jp["mixed"]), 32)
    kern = jmk.neural_megakernel_summary_from_packed(
        s.jp["mixed"], s.jc.cluster, jtree, s.j["mixed"], 32, seed=3,
        **dict(KERNEL_KW, b_block=16))
    worst = (assert_short_horizon_standard(port, lax32, {"denials": 1e-5}),
             assert_short_horizon_standard(port, kern, {"denials": 1e-5}))
    flagship = jload(s.jc)[0].params
    port2 = mk.neural_megakernel_summary_from_packed(
        s.tp["mixed"], s.tc.cluster,
        load_flagship_backend(s.tc, device="cpu")[0].params, s.t("mixed"),
        2, seed=3, stochastic=False)
    worst2 = assert_short_horizon_standard(port2, s.jax_lax(
        "mixed", jmk.kernel_numerics_action_fn(flagship, s.jc.cluster,
                                               s.jp["mixed"]), 2))
    print(f"\n# mlp mixed: worst rel {worst[0]:.3g} vs lax and "
          f"{worst[1]:.3g} vs kernel (T=32, test net), {worst2:.3g} "
          f"(T=2, flagship)")
