"""Replay signal backend: stored traces as the time-series store.

The PyTorch form of the host half of `ccka_tpu/signals/replay.py`:
traces saved as compressed ``.npz`` files (the same format, both ways)
and replayed deterministically. The stored trace is held on the CPU; a
request names the device its slice lands on.

The device window samplers of the JAX backend (``batch_trace_device``,
``packed_trace_device``, ``packed_block_trace_device``) are not ported
yet (ROADMAP A10b) and raise.
"""

from __future__ import annotations

import json
import math
import os
import warnings
from typing import Mapping

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.signals.base import (ExogenousTrace, SignalSource,
                                         TraceMeta, as_f32)

_FIELDS = ("spot_price_hr", "od_price_hr", "carbon_g_kwh", "demand_pods",
           "is_peak")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_trace(path: str, trace: ExogenousTrace, meta: TraceMeta) -> None:
    """Persist a trace and its provenance to ``path`` (.npz)."""
    arrays = {k: _host(getattr(trace, k)) for k in _FIELDS}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({
            "source": meta.source,
            "start_unix_s": meta.start_unix_s,
            "dt_s": meta.dt_s,
            "zones": list(meta.zones),
            "description": meta.description,
        }).encode("utf-8"), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_trace(path: str) -> tuple[ExogenousTrace, TraceMeta]:
    """A saved trace (float32 CPU tensors) and its provenance."""
    with np.load(path) as data:
        trace = ExogenousTrace(**{k: as_f32(data[k]) for k in _FIELDS})
        raw = (bytes(data["__meta__"].tobytes()) if "__meta__" in data
               else b"{}")
    md = json.loads(raw.decode("utf-8") or "{}")
    meta = TraceMeta(
        source=md.get("source", "replay"),
        start_unix_s=float(md.get("start_unix_s", 0.0)),
        dt_s=float(md.get("dt_s", 30.0)),
        zones=tuple(md.get("zones", ())),
        description=md.get("description", ""),
    )
    trace.validate_shapes()
    return trace, meta


class ReplaySignalSource(SignalSource):
    """Replays a stored trace; deterministic, seed-independent.

    ``trace(steps)`` tiles the stored trace when a longer horizon is asked
    for (diurnal signals tile naturally) and slices when shorter;
    ``offset_steps`` selects held-out windows. ``faults`` / ``workloads``
    are kept for the packed device path (ROADMAP A10b).
    """

    def __init__(self, trace: ExogenousTrace, meta: TraceMeta,
                 *, offset_steps: int = 0, faults=None, workloads=None):
        trace.validate_shapes()
        self._trace = trace.to("cpu")
        self._meta = meta
        self.offset_steps = offset_steps
        self.faults = faults if faults is not None and faults.enabled \
            else None
        self.workloads = (workloads if workloads is not None
                          and workloads.enabled else None)

    @classmethod
    def from_file(cls, path: str, *, offset_steps: int = 0,
                  faults=None, workloads=None) -> "ReplaySignalSource":
        trace, meta = load_trace(path)
        return cls(trace, meta, offset_steps=offset_steps, faults=faults,
                   workloads=workloads)

    def meta(self) -> TraceMeta:
        return self._meta

    def trace(self, steps: int, *, seed: int = 0,
              device=None) -> ExogenousTrace:
        del seed  # replay is deterministic
        return self._trace_at(self.offset_steps, steps).to(
            resolve_device(device))

    def _trace_at(self, offset: int, steps: int) -> ExogenousTrace:
        stored = self._trace.steps
        need = offset + steps
        full = self._trace
        if need > stored:
            reps = -(-need // stored)  # ceil
            full = ExogenousTrace(*(
                torch.cat([a] * reps, dim=-2 if a.dim() >= 2 else -1)
                for a in self._trace))
        return full.slice_steps(offset, steps)

    def batch_trace(self, steps: int, seeds, device=None) -> ExogenousTrace:
        """[B, T, ...] batch of distinct windows into the stored trace:
        seed ``s`` replays from offset ``offset_steps + s * step mod
        stored``, ``step`` near stored / golden ratio and coprime to it (a
        bijection on offsets, so distinct seeds give distinct windows
        whenever the store is long enough; repeats are warned)."""
        dev = resolve_device(device)
        seeds = [int(s) for s in seeds]
        stored = self._trace.steps
        step = max(1, round(stored * 0.6180339887498949))
        while math.gcd(step, stored) != 1:
            step += 1
        if len({s % stored for s in seeds}) < len(seeds):
            warnings.warn(
                f"replay batch_trace: {len(seeds)} seeds over a "
                f"{stored}-step store must repeat windows (pigeonhole); "
                "capture a longer trace for a fully distinct batch",
                stacklevel=2)
        ext = self._trace_at(0, stored + steps)
        windows = [ext.slice_steps((self.offset_steps + s * step) % stored,
                                   steps) for s in seeds]
        return ExogenousTrace(*(torch.stack(xs).to(dev)
                                for xs in zip(*windows)))

    def _not_ported(self, what: str):
        raise NotImplementedError(
            f"ReplaySignalSource.{what}: the replay backend's device window "
            "samplers are not ported yet (ROADMAP A10b); use trace() or "
            "batch_trace()")

    def batch_trace_device(self, *args, **kwargs):
        self._not_ported("batch_trace_device")

    def packed_trace_device(self, *args, **kwargs):
        self._not_ported("packed_trace_device")

    def packed_block_trace_device(self, *args, **kwargs):
        self._not_ported("packed_block_trace_device")


def trace_from_arrays(arrays: Mapping[str, np.ndarray], dt_s: float,
                      zones: tuple[str, ...]
                      ) -> tuple[ExogenousTrace, TraceMeta]:
    """A replayable trace from raw arrays (for example parsed Prometheus
    query_range results)."""
    trace = ExogenousTrace(**{k: as_f32(arrays[k]) for k in _FIELDS})
    trace.validate_shapes()
    meta = TraceMeta(source="replay", start_unix_s=0.0, dt_s=dt_s,
                     zones=zones)
    return trace, meta
