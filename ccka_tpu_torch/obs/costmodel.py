"""The observatory's publish/read bridge to the exporter gauges.

The PyTorch form of the publish/read half of `ccka_tpu/obs/costmodel.py`:

- :func:`total_dispatches` — calls summed over every watched entry point
  of this session (`obs/compile.py::compile_report`), the
  ``ccka_program_dispatches_total`` gauge;
- :func:`publish_pipeline_snapshot` / :func:`pipeline_snapshot` — the
  latest measured occupancy / imbalance / achieved-fraction triple, for
  promexport's ``ccka_pipeline_occupancy`` / ``ccka_shard_imbalance`` /
  ``ccka_achieved_roofline_fraction`` gauges (a fleet service exports
  what the observatory last measured; absent = series skipped, never a
  fake 0).

The JAX module's other half reads what XLA says a compiled program
costs (``attribute``, ``program_table``, the roofline helpers,
``crosscheck_bytes``); its counterpart is ROADMAP item A12. Host-side
dict lookups only: a service tick reads these every tick.
"""

from __future__ import annotations

import threading
from typing import Mapping

from ccka_tpu_torch.obs.compile import compile_report

_LOCK = threading.Lock()

# The observatory's latest pipeline measurement (occupancy fractions,
# shard imbalance, achieved fraction), published by whoever measured it.
_PIPELINE_SNAPSHOT: dict = {}


def total_dispatches() -> int:
    """Sum of calls across every watched entry point this session (the
    ``ccka_program_dispatches_total`` gauge)."""
    return sum(s.get("calls", 0) for s in compile_report().values())


def publish_pipeline_snapshot(*, occupancy: Mapping[str, float],
                              shard_imbalance: float | None = None,
                              achieved_fraction: float | None = None
                              ) -> None:
    """Publish the observatory's latest pipeline measurement for the
    exporter gauges. Occupancy is the stage-fraction dict (generation/
    kernel/host, summing to ~1)."""
    with _LOCK:
        _PIPELINE_SNAPSHOT.clear()
        _PIPELINE_SNAPSHOT.update({
            "occupancy": {k: float(v) for k, v in occupancy.items()},
            "shard_imbalance": (float(shard_imbalance)
                                if shard_imbalance is not None else None),
            "achieved_fraction": (float(achieved_fraction)
                                  if achieved_fraction is not None
                                  else None),
        })


def pipeline_snapshot() -> dict | None:
    """The latest published measurement, or None (gauges then skip)."""
    with _LOCK:
        return dict(_PIPELINE_SNAPSHOT) if _PIPELINE_SNAPSHOT else None
