"""Networks and the latent action codec.

The PyTorch form of `ccka_tpu/models/nets.py`. The observation is tiny
(29 to 36 features), so the policy is a small MLP: a bfloat16 GELU torso
and float32 heads for the distribution parameters. Batched over thousands
of clusters, the torso is one [B, F] x [F, H] product a layer.

The latent action codec keeps the network unconstrained (R^A) and maps
into the feasible Action set with smooth squashings and the Kyverno
projection (`policy/constraints.py`), so gradients and exploration live
in an unbounded space while everything emitted is admission-valid.

GELU is the tanh approximation throughout, as in flax (`nn.gelu`'s
default); PyTorch's own default is the erf form. On a bfloat16 tensor it
is computed as JAX computes it, operation by operation in bfloat16
(:func:`gelu_tanh`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ccka_tpu_torch.config import ClusterConfig
from ccka_tpu_torch.policy.constraints import (CONSOLIDATE_AFTER_MAX_S,
                                               project_feasible)
from ccka_tpu_torch.sim.dynamics import clip
from ccka_tpu_torch.sim.types import N_CT, Action

# Codec squash ceiling == projection clip ceiling (one constant), so the
# latent policy can reach the whole feasible consolidateAfter range.
AFTER_MAX_S = CONSOLIDATE_AFTER_MAX_S
HPA_LO, HPA_HI = 0.1, 4.0
# Zero-latent bias: sigmoid(0 + bias) decodes to hpa_scale = 1.0 (serve
# demand exactly), not the range midpoint 2.05.
HPA_BIAS = math.log((1.0 - HPA_LO) / (HPA_HI - 1.0))


def latent_dim(cluster: ClusterConfig, n_classes: int = 2) -> int:
    p, z = cluster.n_pools, cluster.n_zones
    return p * z + p * N_CT + p + p + n_classes


def latent_to_action(u: torch.Tensor, cluster: ClusterConfig,
                     n_classes: int = 2) -> Action:
    """Unconstrained latent [..., A] -> feasible Action (smooth,
    invertible almost everywhere)."""
    p, z = cluster.n_pools, cluster.n_zones
    parts = torch.split(u, [p * z, p * N_CT, p, p, n_classes], dim=-1)
    lead = u.shape[:-1]
    return project_feasible(
        Action(zone_weight=torch.sigmoid(parts[0]).reshape(*lead, p, z),
               ct_allow=torch.sigmoid(parts[1]).reshape(*lead, p, N_CT),
               consolidation_aggr=torch.sigmoid(parts[2]),
               consolidate_after_s=AFTER_MAX_S * torch.sigmoid(parts[3]),
               hpa_scale=HPA_LO + (HPA_HI - HPA_LO) * torch.sigmoid(
                   parts[4] + HPA_BIAS)),
        cluster)


def action_to_latent(action: Action, cluster: ClusterConfig) -> torch.Tensor:
    """Inverse codec (clipped logit): warm-starts plans and policies at a
    rule profile instead of random actions."""
    def logit(x, lo=0.0, hi=1.0):
        y = clip((x - lo) / (hi - lo), 1e-4, 1.0 - 1e-4)
        return torch.log(y) - torch.log1p(-y)

    return torch.cat([
        logit(action.zone_weight).flatten(-2),
        logit(action.ct_allow).flatten(-2),
        logit(action.consolidation_aggr),
        logit(action.consolidate_after_s, 0.0, AFTER_MAX_S),
        logit(action.hpa_scale, HPA_LO, HPA_HI) - HPA_BIAS,
    ], dim=-1)


_CONSTS: dict = {}


def _const(v: float, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-dim constant tensor, made once per (value, dtype, device): a
    CUDA graph capture may not copy from the host, so the constants of a
    captured body must exist before the capture (its warm-up makes
    them)."""
    key = (v, dtype, torch.device(device))
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.tensor(v, dtype=dtype, device=device)
    return c


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3)))`` written
    as `jax.nn.gelu` writes it, every operation in ``x``'s dtype. On a
    bfloat16 tensor each intermediate therefore rounds to bfloat16, as it
    does in JAX; ``torch.nn.functional.gelu(approximate="tanh")`` computes
    in float32 and rounds once, which lands one bfloat16 step away on
    about four inputs in ten."""
    def const(v):
        return _const(v, x.dtype, x.device)

    inner = const(math.sqrt(2.0 / math.pi)) * (x + const(0.044715)
                                               * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


# The standard deviation of a standard normal truncated to [-2, 2]: flax's
# variance-scaling initialisers divide by it so the truncated draw keeps
# the asked-for variance.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(layer: nn.Linear, generator) -> None:
    """``nn.initializers.lecun_normal()`` on ``layer.weight`` ([out, in]:
    fan_in is ``in``) by inverse-CDF sampling of the truncated normal, and
    a zero bias."""
    w = layer.weight
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2, 2))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float32,
                   device=w.device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    w.copy_(torch.clamp(z, -2.0, 2.0) * std)
    nn.init.zeros_(layer.bias)


def _normalize_obs(obs: torch.Tensor) -> torch.Tensor:
    """Fixed normalization that keeps the net scale-free without running
    statistics (nodes O(10), pods O(60), $/hr O(0.1), gCO2/kWh O(500))."""
    return torch.sign(obs) * torch.log1p(torch.abs(obs))


class _Torso(nn.Module):
    """bfloat16 GELU layers on the normalized observation; returns the
    features as float32. The layers are ``Dense_0``, ``Dense_1``, ... as
    in the flax modules; like theirs, the parameters are kept in float32
    and cast to bfloat16 where they are used."""

    def __init__(self, obs_dim: int, hidden: Sequence[int]):
        super().__init__()
        dims = (obs_dim, *hidden)
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Dense_{i}", nn.Linear(d_in, d_out))
        self.n_layers = len(hidden)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = _normalize_obs(obs).to(torch.bfloat16)
        for i in range(self.n_layers):
            layer = getattr(self, f"Dense_{i}")
            # The product rounds to bfloat16 before the bias is added,
            # as in flax's Dense.
            x = gelu_tanh(F.linear(x, layer.weight.to(torch.bfloat16))
                          + layer.bias.to(torch.bfloat16))
        return x.to(torch.float32)


def _rowwise_sums(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` in float32 with each row's sums added in one fixed
    order (an elementwise product, then one reduction over the inputs),
    so a row's result does not depend on how many rows share the call: a
    GEMM picks its kernel, and with it the order of its sums, by the
    batch size."""
    return (x.to(torch.float32)[..., None, :]
            * weight.to(torch.float32)).sum(dim=-1)


def rowwise_policy_mean(net: "ActorCritic", obs: torch.Tensor) -> torch.Tensor:
    """The actor's mean latent, ``net(obs)[0]``, computed row by row
    (:func:`_rowwise_sums`): the same rounding points as the module's
    forward (bfloat16 products rounded before the bias, the float32
    head), other sum orders. A cluster's mean is then the same alone as
    in a fleet, on every device."""
    x = _normalize_obs(obs).to(torch.bfloat16)
    for i in range(net.n_layers):
        layer = getattr(net, f"Dense_{i}")
        w = layer.weight.to(torch.bfloat16)
        x = gelu_tanh(_rowwise_sums(x, w).to(torch.bfloat16)
                      + layer.bias.to(torch.bfloat16))
    head = net.actor_mean
    return _rowwise_sums(x, head.weight) + head.bias


class PolicyMLP(_Torso):
    """Deterministic policy: observation -> latent action. bfloat16 torso,
    float32 zero-initialised output head (``Dense_<n>``)."""

    def __init__(self, obs_dim: int, out_dim: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__(obs_dim, hidden)
        head = nn.Linear(hidden[-1], out_dim)
        nn.init.zeros_(head.weight)
        nn.init.zeros_(head.bias)
        self.add_module(f"Dense_{len(hidden)}", head)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"Dense_{self.n_layers}")(super().forward(obs))


class ActorCritic(_Torso):
    """Gaussian actor and value critic on a shared torso (PPO).

    The actor emits (mean, log_std) over the latent action space; log_std
    is a learned state-independent vector. The zero-initialised mean head
    makes the initial policy the codec's zero point: all zones open, both
    capacity types allowed, mild consolidation and hpa_scale = 1.
    """

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (128, 128),
                 init_log_std: float = -0.5,
                 generator: torch.Generator | None = None):
        super().__init__(obs_dim, hidden)
        self.init_log_std = init_log_std
        self.actor_mean = nn.Linear(hidden[-1], act_dim)
        self.log_std = nn.Parameter(torch.empty(act_dim))
        self.critic = nn.Linear(hidden[-1], 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialisation of the module: every torso layer and the
        critic ``lecun_normal`` (a normal truncated at two standard
        deviations, scaled to variance 1 / fan_in) with zero biases, the
        actor-mean head zero, ``log_std`` the constant ``init_log_std``.
        Draws come from ``generator`` (the default generator when None),
        layer by layer in the modules' order."""
        for i in range(self.n_layers):
            _lecun_normal_(getattr(self, f"Dense_{i}"), generator)
        _lecun_normal_(self.critic, generator)
        nn.init.zeros_(self.actor_mean.weight)
        nn.init.zeros_(self.actor_mean.bias)
        self.log_std.fill_(self.init_log_std)

    def forward(self, obs: torch.Tensor):
        x = super().forward(obs)
        return self.actor_mean(x), self.log_std, self.critic(x).squeeze(-1)
