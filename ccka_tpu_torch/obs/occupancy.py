"""The pipeline occupancy ledger and the mesh's shard imbalance: where a
run's time goes.

The PyTorch form of `ccka_tpu/obs/occupancy.py`:

- :class:`OccupancyLedger`: seconds per stage ("generation", "kernel",
  "host") accumulated from fenced spans (`obs/trace.py`), and their
  fractions of the measured total. The synchronous drive of
  `sim/streaming.py` fills one; its fractions are the device's busy and
  idle shares that the double-buffered drive sets out to overlap.
- :func:`measure_packed_pipeline`: the three stages (``generate_fn`` ->
  ``kernel_fn`` -> ``host_fn``) for N repeats under one tracer, each
  device stage a fenced span.
- :func:`measure_shard_times`: each shard's kernel seconds, shard ``i``'s
  lane block run alone (with its ``cluster0``), each fenced on its own,
  so an imbalance is attributed to a shard.
- :func:`shard_imbalance`: max over mean of those times (1.0 balanced).

The instruments read no input of the computation, so a run with them
gives the same results as a run without.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from ccka_tpu_torch.obs.trace import SpanTracer

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


def measure_packed_pipeline(generate_fn: Callable[[int], object],
                            kernel_fn: Callable[[object, int], object],
                            host_fn: Callable[[object], object]
                            | None = None,
                            *, repeats: int = 1,
                            tracer: SpanTracer | None = None,
                            label: str = "pipeline"
                            ) -> tuple[OccupancyLedger, object]:
    """Measure the packed generate -> rollout -> summary pipeline:
    ``generate_fn(i)`` makes repeat ``i``'s stream (a fresh world per
    repeat), ``kernel_fn(stream, i)`` runs the kernel and returns its
    summary, ``host_fn(summary)`` the host stage (unfenced: the kernel
    stage's fence has drained the device). Returns ``(ledger, the last
    host_fn result)`` (the summary itself without ``host_fn``)."""
    tr = tracer or SpanTracer()
    ledger = OccupancyLedger()
    host_out = None
    for i in range(max(repeats, 1)):
        with tr.device_span(f"{label}.generation", repeat=i) as sp:
            stream = generate_fn(i)
            sp.fence(stream)
        ledger.add("generation", sp.dur_s)
        with tr.device_span(f"{label}.kernel", repeat=i) as sp:
            out = kernel_fn(stream, i)
            sp.fence(out)
        ledger.add("kernel", sp.dur_s)
        with tr.span(f"{label}.host", repeat=i) as sp:
            host_out = host_fn(out) if host_fn is not None else out
        ledger.add("host", sp.dur_s)
        ledger.repeats += 1
    return ledger, host_out


def measure_shard_times(shard_fn: Callable[[int], object], n_shards: int,
                        *, tracer: SpanTracer | None = None,
                        label: str = "shard") -> list[float]:
    """Each shard's kernel seconds: ``shard_fn(i)`` runs shard ``i``'s
    lane block and returns its device outputs, fenced on their own. The
    shards run one after another, so each time is that shard's work."""
    tr = tracer or SpanTracer()
    times = []
    for i in range(n_shards):
        with tr.device_span(f"{label}.{i}", shard=i) as sp:
            sp.fence(shard_fn(i))
        times.append(sp.dur_s)
    return times


def shard_imbalance(per_shard_s: Sequence[float]) -> float | None:
    """Max over mean of the shards' times: 1.0 is a balanced mesh, and a
    real measurement is at least 1. None on an empty or all-zero one."""
    ts = [float(t) for t in per_shard_s]
    if not ts:
        return None
    mean = sum(ts) / len(ts)
    if mean <= 0.0:
        return None
    return max(ts) / mean
