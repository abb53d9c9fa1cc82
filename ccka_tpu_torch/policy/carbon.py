"""Carbon-aware zone selection: "follow the sun" as a rule backend.

The PyTorch form of `ccka_tpu/policy/carbon.py`. The policy keeps the
Peak/Off-Peak disruption, capacity-type and HPA semantics of the rule
profiles and derives the zone weight every tick from the live carbon
signal: zones cleaner than the fleet mean get a weight above 0.5, dirtier
ones below. The weight steers where new capacity is provisioned;
consolidation and spot churn then drain the dirty zones, so the fleet
walks toward the clean region over a few provisioning cycles.

``decide`` is batch-first and differentiable. Its sums over zones and
over (capacity type, pool) are left-to-right chains in the order the CUDA
kernel adds (`csrc/rollout_profiles.cu`, CARBON), so the kernel and this
plain version can round alike.
"""

from __future__ import annotations

import torch

from ccka_tpu_torch.config import ClusterConfig
from ccka_tpu_torch.policy.base import PolicyBackend
from ccka_tpu_torch.policy.rule import (offpeak_action, peak_action,
                                        select_profile)
from ccka_tpu_torch.sim.dynamics import ExoStep, clip, seqsum
from ccka_tpu_torch.sim.types import Action, ClusterState


def carbon_zone_weight(carbon_g_kwh: torch.Tensor, *,
                       sharpness: float = 10.0) -> torch.Tensor:
    """[..., Z] carbon signal -> [..., Z] zone weight in (0, 1): the
    margin against the mean over zones is relative, so a zone 10 % cleaner
    than average saturates toward 1 at the default sharpness."""
    mean = carbon_g_kwh.mean(dim=-1, keepdim=True)
    rel = (mean - carbon_g_kwh) / (mean + 1e-6)
    return torch.sigmoid(sharpness * rel)


def carbon_aware_action(off: Action, peak: Action, state: ClusterState,
                        exo: ExoStep, *, sharpness: float, min_weight: float,
                        stickiness: float) -> Action:
    """The profile chosen per cluster on ``is_peak``, with its zone weight
    replaced by ``max(sigmoid(sharpness * rel + stickiness * occupancy),
    min_weight)``: ``rel`` is a zone's carbon margin against the mean over
    zones, ``occupancy`` its share of the fleet above uniform, in
    [-1, 1]."""
    base = select_profile(exo.is_peak, off, peak)
    carbon = exo.carbon_g_kwh                              # [B, Z]
    n_zones = carbon.shape[-1]
    mean = (seqsum(carbon, (1,)) / n_zones)[:, None]       # [B, 1]
    rel = (mean - carbon) / (mean + 1e-6)
    # [B, P, Z, CT] -> [B, Z], chained capacity type first, then pool.
    nodes_z = seqsum(state.nodes.permute(0, 2, 3, 1), (2, 3))
    total = (seqsum(nodes_z, (1,)) + 1e-6)[:, None]
    # 0 when uniform; clipped so a concentrated fleet cannot out-shout a
    # large carbon divergence.
    occupancy = clip(nodes_z / total * n_zones - 1.0, -1.0, 1.0)
    w = torch.sigmoid(sharpness * rel + stickiness * occupancy)
    w = clip(w, min_weight)                     # [B, Z]
    zone_w = w[:, None, :].expand(base.zone_weight.shape)  # [B, P, Z]
    return base._replace(zone_weight=zone_w)


class CarbonAwarePolicy(PolicyBackend):
    """Rule profiles with carbon-derived zone selection.

    ``min_weight`` keeps a floor under every zone, so the zone
    requirement never renders empty. ``stickiness`` is hysteresis: zones
    already holding fleet get a logit bonus proportional to their share
    above uniform (clipped to [-1, 1]), so carbon noise around a crossover
    cannot flip the requirement until the margin exceeds ``stickiness /
    sharpness``. The memory is the fleet placement itself.
    """

    def __init__(self, cluster: ClusterConfig, *, sharpness: float = 10.0,
                 min_weight: float = 0.05, stickiness: float = 1.0,
                 device=None):
        self.cluster = cluster
        self.sharpness = sharpness
        self.min_weight = min_weight
        self.stickiness = stickiness
        self._off = offpeak_action(cluster, device)
        self._peak = peak_action(cluster, device)

    def decide(self, state: ClusterState, exo: ExoStep, t: int) -> Action:
        return carbon_aware_action(
            self._off, self._peak, state, exo, sharpness=self.sharpness,
            min_weight=self.min_weight, stickiness=self.stickiness)

    def profile_name(self, is_peak: bool) -> str:
        return ("peak" if is_peak else "offpeak") + "+carbon"
