"""The port's lax CEM engine against the JAX package's, case by case
(`tests/test_torch_cem.py`'s draws and standards: the JAX key schedule's
traces and noise handed to the port through ``draws=``, spot rate 0).

A file of its own: each case runs three generations through both
packages' plain rollouts (minutes in all on a loaded worker), so the test
scheduler can start it apart from the rest of `tests/test_torch_cem.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from ccka_tpu.policy import CarbonAwarePolicy as JCarbon
from ccka_tpu.train import cem as jcem
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.train import cem
from test_torch_cem import _assert_same_run, _jax_draws, _setup

# The lax engine's cases: (CEMConfig fields, the bars, the seed, whether a
# generation moves the incumbent on that seed). The flagship's tier-2
# bars against the carbon teacher; the carbon-frontier bars with a
# margin; absolute bars; isotropic head noise (no damping of the hpa
# coordinates: every candidate falls off the SLO cliff, none improves);
# the whole net perturbed.
LAX_CASES = {
    "teacher-min": (dict(), "teacher", 0, True),
    "frontier": (dict(usd_bar="rule", co2_bar="teacher",
                      attain_bar="teacher", attain_margin=0.01), "teacher",
                 3, True),
    "bars": (dict(), "bars", 0, True),
    "hpa-isotropic": (dict(hpa_damp=1.0), "teacher", 0, False),
    "whole-net": (dict(head_only=False, sigma0=1e-3), "teacher", 0, True),
}


@pytest.mark.parametrize("case", sorted(LAX_CASES))
def test_lax_engine_matches_jax(case):
    """Three generations of 3 candidates on 2 traces of 96 ticks."""
    jc, tc, params0, src = _setup()
    fields, bar_kind, seed, improves = LAX_CASES[case]
    cc = jcem.CEMConfig(generations=3, popsize=3, traces_per_gen=2,
                        eval_steps=96, **fields)
    jkw, tkw = ({"teacher_fn": JCarbon(jc.cluster).action_fn()},
                {"teacher_policy": CarbonAwarePolicy(tc.cluster,
                                                     device="cpu")})
    if bar_kind == "bars":
        bars = {"usd": 0.45, "co2": 0.2, "attain": 0.9}
        jkw, tkw = {"bars": bars}, {"bars": bars}
    jout = jcem.cem_refine(jc, jax.tree.map(jnp.asarray, params0), src,
                           cem=cc, seed=seed, **jkw)
    dim = cem._flatten(params0)[0].shape[0]
    draws = _jax_draws(src, cc, dim, seed, "lax")
    tout = cem.cem_refine(tc, params0, None, cem=cem.CEMConfig(
        **cc._asdict()), seed=seed, draws=lambda g: draws[g], device="cpu",
        **tkw)
    _assert_same_run(jout, tout)
    assert any(r["improved"] for r in tout[1]) == improves
