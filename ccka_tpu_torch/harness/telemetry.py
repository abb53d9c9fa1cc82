"""Telemetry: structured timing, JSONL export and profiler capture.

The PyTorch form of `ccka_tpu/harness/telemetry.py`:

- :class:`StageTimer` — named-phase timing of one control tick, on spans
  (a re-export of `ccka_tpu_torch.obs.trace.StageTimer`);
- :class:`TelemetryWriter` — append-only JSONL of tick reports, flushed
  per write;
- :func:`profile_trace` — a `torch.profiler` capture around a block,
  gated on a log directory.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator, Mapping

from ccka_tpu_torch.obs.trace import StageTimer  # noqa: F401  (re-export)


class TelemetryWriter:
    """Append-only JSONL sink for structured tick records: one JSON object
    per line, flushed per write; parent directories are made on demand."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def write(self, record: Mapping) -> None:
        self._fh.write(json.dumps(dict(record), sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "TelemetryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_telemetry(path: str) -> list[dict]:
    """A JSONL telemetry file back as records (blank lines skipped)."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize_telemetry(records: list[dict]) -> dict:
    """Controller tick records reduced to a session scoreboard: SLO
    attainment, cost and carbon rates, latency, apply/verify health and
    each phase's timing distribution."""
    if not records:
        return {"ticks": 0}

    def _vals(key):
        return [float(r[key]) for r in records if key in r]

    def _frac(key):
        vals = [bool(r.get(key)) for r in records]
        return sum(vals) / len(vals)

    def _stats(vals):
        if not vals:
            return {}
        arr = sorted(vals)
        # Nearest-rank p95: ceil(0.95 n) - 1.
        rank = max(0, -(-95 * len(arr) // 100) - 1)
        return {"mean": round(sum(arr) / len(arr), 3),
                "p95": round(arr[rank], 3),
                "max": round(arr[-1], 3)}

    phases: dict[str, list[float]] = {}
    for r in records:
        for phase, ms in (r.get("timings_ms") or {}).items():
            phases.setdefault(phase, []).append(float(ms))

    peak_ticks = sum(1 for r in records if r.get("is_peak"))
    return {
        "ticks": len(records),
        "peak_ticks": peak_ticks,
        "slo_attainment": round(_frac("slo_ok"), 4),
        "applied_frac": round(_frac("applied"), 4),
        "verified_frac": round(_frac("verified"), 4),
        "fallbacks": int(sum(_vals("fallbacks"))),
        "cost_usd_hr": _stats(_vals("cost_usd_hr")),
        "carbon_g_hr": _stats(_vals("carbon_g_hr")),
        "usd_per_kreq": _stats(_vals("usd_per_kreq")),
        "g_co2_per_kreq": _stats(_vals("g_co2_per_kreq")),
        "waste_frac": _stats(_vals("waste_frac")),
        "latency_p95_ms": _stats(_vals("latency_p95_ms")),
        "pending_pods": _stats(_vals("pending_pods")),
        "nodes_spot": _stats(_vals("nodes_spot")),
        "nodes_od": _stats(_vals("nodes_od")),
        "timings_ms": {k: _stats(v) for k, v in sorted(phases.items())},
        "profiles": sorted({r.get("profile", "") for r in records} - {""}),
    }


@contextlib.contextmanager
def profile_trace(log_dir: str | None) -> Iterator[None]:
    """A `torch.profiler` capture (CPU, and CUDA when present) around a
    block, gated on ``log_dir``: a falsy one makes this a no-op, so call
    sites can pass a CLI flag straight through. The trace lands in
    ``log_dir`` as a Chrome trace JSON (TensorBoard's profiler plugin
    reads it too)."""
    if not log_dir:
        yield
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
