"""The fault tuple the simulator step consumes.

The PyTorch form of `ccka_tpu/faults/types.py`. Leaves carry the batch
axis in front when a caller steps a batch ([B, Z] and [B]); a rollout
takes them time-major per cluster ([B, T, Z] and [B, T]).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccka_tpu_torch import resolve_device


class FaultStep(NamedTuple):
    """One tick of disturbance inputs.

    preempt_hazard: [Z] multiplier on the per-step spot-interruption
      probability (1 = calm; clipped so the probability stays <= 1).
    deny_frac: [] share of this tick's spot provisioning request denied
      (insufficient capacity; denied capacity is not requested, and the
      pending pods ask again next tick).
    delay_frac: [] share of this tick's pipeline arrivals held back one
      more tick.
    signal_stale: [] {0,1} signal outage: policies observe the held
      signals of the last tick before the outage; dynamics use true ones.
    """

    preempt_hazard: torch.Tensor
    deny_frac: torch.Tensor
    delay_frac: torch.Tensor
    signal_stale: torch.Tensor

    @classmethod
    def neutral(cls, n_zones: int, device=None) -> "FaultStep":
        """The no-op disturbance: stepping with it is bitwise stepping
        with ``fault=None``."""
        dev = resolve_device(device)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return cls(preempt_hazard=torch.ones((n_zones,), dtype=torch.float32,
                                             device=dev),
                   deny_frac=zero, delay_frac=zero, signal_stale=zero)
