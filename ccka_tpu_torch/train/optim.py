"""The trainers' optimizer: optax's Adam, global-norm clipping and the
cosine schedule, computed as optax computes them.

The PyTorch form of the three optax pieces the JAX package's trainers
chain (`ccka_tpu/train/ppo.py`, `imitate.py`, `mpc.py`). They are
functional, like optax's: ``init`` returns a state, ``update`` returns the
updates and the next state, and the caller adds the updates to its
parameters. A parameter set is one tensor or a sequence of tensors (a
net's parameters in a fixed order); the state mirrors it.

- :class:`Adam`: ``optax.adam(lr)``; ``lr`` a float or a schedule of the
  step count (the count before the step, as optax's ``scale_by_schedule``
  reads it). Bias corrections are rounded as optax rounds them.
- :func:`clip_by_global_norm`: ``optax.clip_by_global_norm(max_norm)``,
  ``g * max_norm / ||g||`` when the global norm reaches ``max_norm``.
- :func:`cosine_decay_schedule`: ``optax.cosine_decay_schedule(init,
  steps, alpha)`` in float32.
- :class:`Chain`: clipping, then Adam (``optax.chain``), the PPO trainer's
  optimizer.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

Params = torch.Tensor | Sequence[torch.Tensor]


def _map(fn, *trees):
    """``fn`` over one tensor or over sequences of tensors, leaf by leaf."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return [fn(*leaves) for leaves in zip(*trees)]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` rounded as optax computes it: the power by
    squaring and multiplying in float32 (XLA's integer power)."""
    power, base = np.float32(1.0), np.float32(decay)
    while count:
        if count & 1:
            power = np.float32(power * base)
        base = np.float32(base * base)
        count >>= 1
    return float(np.float32(1.0) - power)


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: int


class Adam:
    """``optax.adam(lr)``: first and second moments with decay ``b1``,
    ``b2``, bias-corrected, ``eps`` added after the square root; the
    update is ``-lr * mu_hat / (sqrt(nu_hat) + eps)``. ``lr`` is a float
    or a schedule ``count -> float`` evaluated at the step's count before
    the increment."""

    def __init__(self, lr: float | Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, x: Params) -> AdamState:
        """Fresh moments and step count."""
        return AdamState(_map(torch.zeros_like, x), _map(torch.zeros_like, x),
                         0)

    def update(self, g: Params, state: AdamState):
        """``(updates, state)`` for gradient ``g``; apply as ``x + u``."""
        mu, nu, count = state
        mu = _map(lambda g_, m: (1 - self.b1) * g_ + self.b1 * m, g, mu)
        nu = _map(lambda g_, v: (1 - self.b2) * g_ ** 2 + self.b2 * v, g, nu)
        lr = self.lr(count) if callable(self.lr) else self.lr
        count += 1
        c1 = _bias_correction(self.b1, count)
        c2 = _bias_correction(self.b2, count)
        upd = _map(lambda m, v: -lr * ((m / c1) / (torch.sqrt(v / c2)
                                                     + self.eps)), mu, nu)
        return upd, AdamState(mu, nu, count)


def global_norm(g: Params) -> torch.Tensor:
    """``sqrt(sum of every leaf's sum of squares)``, float32, leaves summed
    in order."""
    leaves = [g] if isinstance(g, torch.Tensor) else list(g)
    total = (leaves[0] * leaves[0]).sum()
    for x in leaves[1:]:
        total = total + (x * x).sum()
    return torch.sqrt(total)


def clip_by_global_norm(g: Params, max_norm: float) -> Params:
    """``optax.clip_by_global_norm(max_norm)``'s update: every leaf as it
    is while the global norm is below ``max_norm``, else
    ``(leaf / norm) * max_norm``."""
    norm = global_norm(g)
    keep = norm < max_norm
    return _map(lambda x: torch.where(keep, x, (x / norm) * max_norm), g)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)``:
    ``init * ((1 - alpha) * 0.5 * (1 + cos(pi * min(count, steps) /
    steps)) + alpha)``, each operation rounded to float32."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cos = f32(np.cos(f32(f32(f32(math.pi) * c) / f32(decay_steps))))
        decay = f32(f32(0.5) * f32(f32(1.0) + cos))
        decayed = f32(f32(f32(1.0 - alpha) * decay) + f32(alpha))
        return float(f32(f32(init_value) * decayed))

    return schedule


class Chain:
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``:
    the gradient clipped by its global norm, then Adam's update."""

    def __init__(self, lr: float | Callable[[int], float],
                 max_norm: float = 1.0):
        self.max_norm = max_norm
        self.adam = Adam(lr)

    def init(self, x: Params) -> AdamState:
        return self.adam.init(x)

    def update(self, g: Params, state: AdamState):
        return self.adam.update(clip_by_global_norm(g, self.max_norm), state)
