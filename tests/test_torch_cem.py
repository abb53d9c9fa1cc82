"""The port's (1+lambda)-ES refinement against the JAX package's.

``cem_refine`` in both packages from the same params, on the same draws:
the JAX key schedule (``key, k_tr, k_world, k_noise = split(key, 4)`` a
generation) is reproduced here, and its traces (lax engine) or packed
stream (mega engine) and its perturbation noise are handed to the port
through ``draws=``. The world seeds cannot cross (Threefry is not
Philox), so the spot interruption rate is 0 and the stochastic rollouts
are the deterministic ones in both. The mega engine runs the JAX
package's interpret-mode kernels against the port's plain versions on
the CPU.

Tolerances: the candidates are the same float32 operations on the same
noise, so the returned params are equal; the fitness of a generation is
a mean of float32 KPI ratios from two simulators that agree to float
rounding, held within 3e-5 relative (measured up to 3e-6), and the
decisions it drives (improved, sigma, the provenance) exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.policy import CarbonAwarePolicy as JCarbon
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.train import cem as jcem
from ccka_tpu.train.checkpoint import load_params_npz as jload
from ccka_tpu_torch import bridge
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.train import cem

_RATE0 = {"sim.spot_interruption_rate_hr": 0.0}
FIT_RTOL = 3e-5


def _setup():
    jc = jcfg.PRESETS["default"]().with_overrides(**_RATE0)
    tc = tcfg.PRESETS["default"]().with_overrides(**_RATE0)
    # The replay-family flagship: a trained default-topology policy, so
    # the fitness sits near 1 and candidates differ measurably.
    params0, _ = jload("ccka_tpu/checkpoints/ppo_flagship_replay.npz")
    return jc, tc, params0, JSource(jc.cluster, jc.workload, jc.sim,
                                    jc.signals)


def _jax_draws(src, cc: jcem.CEMConfig, dim: int, seed: int, engine: str):
    """The JAX engine's draws of every generation, as :class:`cem.CEMDraws`."""
    key = jax.random.key(seed)
    out = []
    for _ in range(cc.generations):
        key, k_tr, k_world, k_noise = jax.random.split(key, 4)
        noise = torch.from_numpy(np.array(jax.random.normal(
            k_noise, (cc.popsize - 1, dim))))
        if engine == "mega":
            worlds = torch.from_numpy(np.array(src.packed_trace_device(
                cc.eval_steps, k_tr, cc.traces_per_gen, t_chunk=64)))
            gseed = int(jax.random.randint(k_world, (), 0, 2 ** 30))
        else:
            worlds = bridge.trace(jax.tree.map(np.asarray, (
                src.batch_trace_device(cc.eval_steps, k_tr,
                                       cc.traces_per_gen)))._asdict(), "cpu")
            gseed = 0
        out.append(cem.CEMDraws(worlds, gseed, noise))
    return out


def _assert_same_run(jout, tout):
    (jbest, jhist, jinfo), (tbest, thist, tinfo) = jout, tout
    assert len(jhist) == len(thist)
    for a, b in zip(jhist, thist):
        assert a["improved"] == b["improved"] and a["sigma"] == b["sigma"]
        for k in ("incumbent_fitness", "best_fitness", "best_usd_ratio",
                  "best_co2_ratio"):
            assert abs(a[k] - b[k]) <= FIT_RTOL * abs(a[k]), (k, a, b)
        assert abs(a["best_attain"] - b["best_attain"]) <= 1e-6
        assert a["frac_broken"] == b["frac_broken"]
    assert jinfo["gen"] == tinfo["gen"]
    assert jinfo["final_sigma"] == tinfo["final_sigma"]
    assert abs(jinfo["fitness"] - tinfo["fitness"]) <= FIT_RTOL * abs(
        jinfo["fitness"])
    for a, b in zip(jax.tree_util.tree_leaves(jbest),
                    jax.tree_util.tree_leaves(tbest)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-7)


def test_flat_layout_and_head_mask_match_jax():
    """The flat vector, its inverse and the head mask (with the hpa
    damping) are the JAX package's, coordinate for coordinate."""
    _, tc, params0, _ = _setup()
    jflat, jspec = jcem._flatten(jax.tree.map(jnp.asarray, params0))
    flat, spec = cem._flatten(params0)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = cem._unflatten(flat, spec)
    for a, b in zip(jax.tree_util.tree_leaves(params0),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b.numpy(), a)
    cs = np.ones(16, np.float32)
    cs[-2:] = 0.25
    np.testing.assert_array_equal(
        cem._head_mask(params0, torch.from_numpy(cs)).numpy(),
        np.asarray(jcem._head_mask(params0, jnp.asarray(cs))))
    np.testing.assert_array_equal(cem._head_mask(params0).numpy(),
                                  np.asarray(jcem._head_mask(params0)))


def test_mega_engine_matches_jax_interpret():
    """The mega engine, G = 128 traces of 48 ticks, 3 candidates, the
    carbon teacher: JAX's interpret-mode kernels on its packed stream
    against the port's plain versions of the rule, carbon and population
    launches on the same stream."""
    jc, tc, params0, src = _setup()
    cc = jcem.CEMConfig(generations=2, popsize=3, traces_per_gen=128,
                        eval_steps=48)
    jout = jcem.cem_refine(jc, jax.tree.map(jnp.asarray, params0), src,
                           cem=cc, engine="mega", mega_interpret=True,
                           teacher_policy=JCarbon(jc.cluster), seed=0)
    dim = cem._flatten(params0)[0].shape[0]
    draws = _jax_draws(src, cc, dim, 0, "mega")
    tout = cem.cem_refine(
        tc, params0, None, cem=cem.CEMConfig(**cc._asdict()), seed=0,
        engine="mega", teacher_policy=CarbonAwarePolicy(tc.cluster,
                                                        device="cpu"),
        draws=lambda g: draws[g], device="cpu")
    _assert_same_run(jout, tout)
    assert tout[1][1]["improved"]          # generation 1 moves the incumbent


def test_own_draws_run_and_misuse_is_refused():
    """The port's own generator draws run both engines (fresh traces and
    a stream written into the same buffer each generation), and every
    misuse the JAX engine refuses is refused."""
    _, tc, params0, _ = _setup()
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    src = SyntheticSignalSource(tc.cluster, tc.workload, tc.sim, tc.signals)
    teacher = CarbonAwarePolicy(tc.cluster, device="cpu")
    best, hist, info = cem.cem_refine(
        tc, params0, src, cem=cem.CEMConfig(generations=2, popsize=2,
                                            traces_per_gen=2, eval_steps=32),
        teacher_policy=teacher, seed=1, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist[0]["incumbent_fitness"])
    assert set(best["params"]) == set(params0["params"])
    _, hist, _ = cem.cem_refine(
        tc, params0, src, cem=cem.CEMConfig(generations=2, popsize=2,
                                            traces_per_gen=128,
                                            eval_steps=8),
        engine="mega", teacher_policy=teacher, seed=1, device="cpu")
    assert hist[0]["incumbent_fitness"] != hist[1]["incumbent_fitness"]
    small = cem.CEMConfig(generations=1, traces_per_gen=4, eval_steps=8)
    with pytest.raises(ValueError, match="multiple of 128"):
        cem.cem_refine(tc, params0, src, cem=small, engine="mega",
                       device="cpu")
    with pytest.raises(ValueError, match="teacher_policy"):
        cem.cem_refine(tc, params0, src, engine="mega",
                       teacher_fn=lambda s, e, t: None, device="cpu")
    with pytest.raises(ValueError, match="bars OR a teacher"):
        cem.cem_refine(tc, params0, src, bars={"usd": 1}, device="cpu",
                       teacher_policy=teacher)
    with pytest.raises(ValueError, match="usd_bar"):
        cem.cem_refine(tc, params0, src, cem=cem.CEMConfig(usd_bar="max"),
                       device="cpu")
    from ccka_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="divisible by the data-axis"):
        cem.cem_refine(tc, params0, src, engine="mega", cem=cem.CEMConfig(
            traces_per_gen=130), mesh=make_mesh(devices=["cpu"] * 4),
            device="cpu")
