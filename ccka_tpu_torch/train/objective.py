"""The control objective: one scalarization for every backend.

The PyTorch form of `ccka_tpu/train/objective.py`. It prices the signal
families in dollars, per tick:

    J = cost_usd
      + carbon_weight * carbon_g
      + slo_weight * pending pod-ticks       (the smooth SLO carrier)
      + slo_violation_weight * (1 - slo_ok)  (the tick failed the SLO)
      [+ migration_weight * migration_cost_usd]

Lower is better. Leading axes are kept: on [B, T] metrics a step cost is
[B, T] and an episode objective [B].
"""

from __future__ import annotations

import torch

from ccka_tpu_torch.config import TrainConfig
from ccka_tpu_torch.sim.dynamics import clip
from ccka_tpu_torch.sim.types import StepMetrics


def step_cost(metrics: StepMetrics, tcfg: TrainConfig,
              violation_weight=None, migration_cost=None) -> torch.Tensor:
    """Per-tick scalar cost. ``violation_weight`` overrides the config's
    price; ``migration_cost`` (None by default) adds the geo overlay's
    transfer dollars and leaves the four-term expression untouched when
    absent."""
    vw = (tcfg.slo_violation_weight if violation_weight is None
          else violation_weight)
    pending = clip(metrics.demand_pods - metrics.served_pods,
                   0.0).sum(dim=-1)
    cost = (metrics.cost_usd
            + tcfg.carbon_weight * metrics.carbon_g
            + tcfg.slo_weight * pending
            + vw * (1.0 - metrics.slo_ok))
    if migration_cost is not None:
        cost = cost + tcfg.migration_weight * migration_cost
    return cost


def step_reward(metrics: StepMetrics, tcfg: TrainConfig,
                violation_weight=None, migration_cost=None) -> torch.Tensor:
    return -step_cost(metrics, tcfg, violation_weight, migration_cost)


def episode_objective(metrics: StepMetrics, tcfg: TrainConfig) -> torch.Tensor:
    """Sum of per-tick costs over the time axis (the last axis of the
    step cost: [B, T] -> [B])."""
    return step_cost(metrics, tcfg).sum(dim=-1)
