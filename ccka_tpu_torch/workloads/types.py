"""The workload-family tuples the simulator step consumes and carries.

The PyTorch form of `ccka_tpu/workloads/types.py`. Values are
pod-equivalents of concurrent work (one pod serves one unit a tick). In
a batched step every leaf carries the batch axis in front.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccka_tpu_torch import resolve_device


class WorkloadStep(NamedTuple):
    """One tick of family arrivals: inference load (served first from the
    fleet's headroom), batch work (drained earliest deadline first) and
    best-effort background work. Each [] (or [B])."""

    inf_arrivals: torch.Tensor
    batch_arrivals: torch.Tensor
    bg_arrivals: torch.Tensor

    @classmethod
    def neutral(cls, device=None) -> "WorkloadStep":
        """No arrivals: every queue and counter stays at zero."""
        z = torch.zeros((), dtype=torch.float32,
                        device=resolve_device(device))
        return cls(inf_arrivals=z, batch_arrivals=z, bg_arrivals=z)


class WorkloadState(NamedTuple):
    """Per-family queues carried across ticks.

    inf_queue: [] unserved inference work, capped (the excess is shed).
    batch_backlog: [D] unfinished batch work by age, slot k = work that
      has waited k ticks; slot D-1 is 0 after every step (work reaching it
      unserved is counted as a deadline miss). D = batch_deadline_ticks.
    bg_backlog: [] best-effort backlog.
    """

    inf_queue: torch.Tensor
    batch_backlog: torch.Tensor
    bg_backlog: torch.Tensor

    @classmethod
    def zero(cls, deadline_ticks: int, batch: int | None = None,
             device=None) -> "WorkloadState":
        """Empty queues; ``batch`` puts a batch axis in front."""
        dev = resolve_device(device)
        lead = () if batch is None else (batch,)

        def zeros(*shape):
            return torch.zeros(lead + shape, dtype=torch.float32, device=dev)

        return cls(inf_queue=zeros(),
                   batch_backlog=zeros(int(deadline_ticks)),
                   bg_backlog=zeros())
