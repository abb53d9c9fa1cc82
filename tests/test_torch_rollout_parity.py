"""The port's stochastic rollout against the JAX package's at distribution
level, on the same traces (`tests/test_torch_rollout.py`'s `_World`).

A file of its own: at B = 1024 x a full day it is the slowest single
test of the port (minutes on a loaded worker), so the test scheduler
can start it apart from the rest of `tests/test_torch_rollout.py`.
"""

from __future__ import annotations

from ccka_tpu_torch.sim import megakernel as mk
from test_torch_rollout import _World


def test_stochastic_rollout_mean_parity_with_jax_lax():
    """B = 1024 x a full day: the port's Philox draws against JAX's
    threefry draws on the same traces agree at distribution level."""
    w = _World("default", 1024, 2880)
    port = w.port(stochastic=True, seed=5)
    ref = w.jax_lax(stochastic=True)
    assert mk.mean_parity_violations(port, ref) == {}
    assert float(port.interruptions.mean()) > 0.1   # the sampler ran
