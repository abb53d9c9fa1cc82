"""Action feasibility projection: the Kyverno guardrails as math.

The PyTorch form of `ccka_tpu/policy/constraints.py`: box-clamp every
field; intersect capacity types with each pool's intrinsic set; SLO pools
always allow on-demand; a collapsed zone mask resets to all zones;
hpa_scale bounded to [0.1, 4]. Differentiable clips (JAX's gradient at a
tie) and selects; leaves may carry a leading batch axis.
"""

from __future__ import annotations

import functools

import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import ClusterConfig
from ccka_tpu_torch.sim.dynamics import clip
from ccka_tpu_torch.sim.types import CT_OD, N_CT, Action

_MIN_ZONE_MASS = 1e-3

# The consolidateAfter action ceiling shared with the latent codec.
CONSOLIDATE_AFTER_MAX_S = 600.0


def static_ct_allow(cluster: ClusterConfig, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    allow = torch.zeros((cluster.n_pools, N_CT), dtype=torch.float32,
                        device=dev)
    for i, pool in enumerate(cluster.pools):
        for j, ct in enumerate(("spot", "on-demand")):
            if ct in pool.capacity_types:
                allow[i, j] = 1.0
    return allow


def slo_pool_mask(cluster: ClusterConfig, device=None) -> torch.Tensor:
    return torch.tensor(
        [1.0 if p.strategy == "slo" else 0.0 for p in cluster.pools],
        dtype=torch.float32, device=resolve_device(device))


@functools.lru_cache(maxsize=None)
def _masks(cluster: ClusterConfig, device: torch.device):
    """(static_ct_allow, slo_pool_mask) of a topology on a device, made
    once: the projection then copies nothing from the host, so a CUDA
    graph can capture it."""
    return static_ct_allow(cluster, device), slo_pool_mask(cluster, device)


def project_feasible(action: Action, cluster: ClusterConfig) -> Action:
    """Project an arbitrary action into the Kyverno-feasible set."""
    static, slo_mask = _masks(cluster, action.zone_weight.device)

    zone_w = clip(action.zone_weight, 0.0, 1.0)
    mass = zone_w.sum(dim=-1, keepdim=True)
    zone_w = torch.where(mass < _MIN_ZONE_MASS, torch.ones_like(zone_w),
                         zone_w)

    ct = clip(action.ct_allow, 0.0, 1.0) * static
    ct_od = torch.maximum(ct[..., CT_OD], slo_mask)
    ct = torch.cat([ct[..., :CT_OD], ct_od[..., None], ct[..., CT_OD + 1:]],
                   dim=-1)

    return Action(
        zone_weight=zone_w,
        ct_allow=ct,
        consolidation_aggr=clip(action.consolidation_aggr, 0.0, 1.0),
        consolidate_after_s=clip(action.consolidate_after_s, 0.0,
                                 CONSOLIDATE_AFTER_MAX_S),
        hpa_scale=clip(action.hpa_scale, 0.1, 4.0),
    )
