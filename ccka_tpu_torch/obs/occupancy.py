"""The pipeline occupancy ledger: where a streaming run's time goes.

The PyTorch form of `ccka_tpu/obs/occupancy.py::OccupancyLedger`: seconds
per stage ("generation", "kernel", "host") accumulated from fenced spans
(`obs/trace.py`), and their fractions of the measured total. The
synchronous drive of `sim/streaming.py` fills one; its fractions are the
device's busy and idle shares that the double-buffered drive sets out to
overlap. The ledger reads no input of the computation, so a run with it
gives the same results as a run without.
"""

from __future__ import annotations

import dataclasses

# "generation": packed stream synthesis; "kernel": the rollout kernel's
# launch; "host": the work after the last fence (finalize, reads).
PIPELINE_STAGES = ("generation", "kernel", "host")


@dataclasses.dataclass
class OccupancyLedger:
    """Accumulated per-stage seconds of one measured pipeline."""

    seconds: dict = dataclasses.field(
        default_factory=lambda: {s: 0.0 for s in PIPELINE_STAGES})
    repeats: int = 0

    def add(self, stage: str, dur_s: float) -> None:
        if stage not in self.seconds:
            raise ValueError(f"unknown pipeline stage {stage!r} — the "
                             f"ledger vocabulary is {PIPELINE_STAGES}")
        self.seconds[stage] += float(dur_s)

    @property
    def total_s(self) -> float:
        return sum(self.seconds.values())

    def fractions(self) -> dict:
        """Stage fractions of the measured total (they sum to 1), or {}
        before any measurement."""
        total = self.total_s
        if total <= 0.0:
            return {}
        return {k: v / total for k, v in self.seconds.items()}

    def to_dict(self) -> dict:
        return {
            "seconds": {k: round(v, 6) for k, v in self.seconds.items()},
            "fractions": {k: round(v, 6)
                          for k, v in self.fractions().items()},
            "repeats": self.repeats,
        }
