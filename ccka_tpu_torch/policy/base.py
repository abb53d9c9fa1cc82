"""PolicyBackend interface and the observation feature surface.

The PyTorch form of `ccka_tpu/policy/base.py`. ``decide`` is a function of
(batched state, batched tick signals, tick index) and returns an Action
whose leaves are shared or carry the batch axis in front.
"""

from __future__ import annotations

import abc
from typing import NamedTuple

import torch

from ccka_tpu_torch.sim.dynamics import ExoStep, seqsum
from ccka_tpu_torch.sim.types import Action, ClusterState, SimParams


class Observation(NamedTuple):
    """Policy features built from state + tick signals (batch-first)."""

    nodes_pzc: torch.Tensor      # [B, P, Z, T_CT] fleet
    pipeline_ct: torch.Tensor    # [B, T_CT] capacity in flight (nodes)
    running: torch.Tensor        # [B, C]
    demand: torch.Tensor         # [B, C] raw demand this tick
    spot_price_hr: torch.Tensor  # [B, Z]
    od_price_hr: torch.Tensor    # [B, Z]
    carbon_g_kwh: torch.Tensor   # [B, Z]
    is_peak: torch.Tensor        # [B]
    tod_frac: torch.Tensor       # [B] time of day in [0, 1)

    def flatten(self) -> torch.Tensor:
        """[B, F] feature matrix in the JAX package's flatten order."""
        b = self.is_peak.shape[0]
        return torch.cat([x.reshape(b, -1).to(torch.float32) for x in self],
                         dim=1)


def observe(params: SimParams, state: ClusterState,
            exo: ExoStep) -> Observation:
    return Observation(
        nodes_pzc=state.nodes,
        # Chained over (k, p, z), the order the CUDA kernels add in.
        pipeline_ct=seqsum(state.pipeline, (1, 2, 3)),
        running=state.running,
        demand=exo.demand_pods,
        spot_price_hr=exo.spot_price_hr,
        od_price_hr=exo.od_price_hr,
        carbon_g_kwh=exo.carbon_g_kwh,
        is_peak=exo.is_peak,
        tod_frac=(state.time_s % 86400.0) / 86400.0,
    )


class PolicyBackend(abc.ABC):
    """A pluggable decision backend, batched over clusters."""

    @abc.abstractmethod
    def decide(self, state: ClusterState, exo: ExoStep, t: int) -> Action:
        """Map the current clusters + signals to an action."""

    def action_fn(self):
        """Adapter for :func:`ccka_tpu_torch.sim.rollout.batched_rollout_summary`."""
        return lambda state, exo, t: self.decide(state, exo, t)

    @property
    def name(self) -> str:
        return type(self).__name__
