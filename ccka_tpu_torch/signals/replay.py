"""Replay signal backend: stored traces as the time-series store.

The PyTorch form of `ccka_tpu/signals/replay.py`: traces saved as
compressed ``.npz`` files (the same format, both ways) and replayed
deterministically. The stored trace is held on the CPU; a request names
the device its slice lands on.

The device window samplers take the synthetic backend's signatures
(`signals/synthetic.py`), so the trainers and the streaming pipeline
take a replay source unchanged:

- :meth:`ReplaySignalSource.batch_trace_device` gathers ``[B, T, ...]``
  windows out of the periodic extension of the store, which is tiled on
  the device and cached; the window offsets are drawn from the caller's
  ``torch.Generator``;
- :meth:`ReplaySignalSource.packed_trace_device` packs such windows into
  the kernels' ``[T_pad, rows, B]`` stream, with the fault and workload
  lane blocks appended (each family from its own generator, seeded from
  (seed, the family's tag)); the workload lanes are phased by the same
  offsets as the windows;
- :meth:`ReplaySignalSource.packed_block_trace_device` gives one time
  block of that stream: its exo rows are bitwise the rows of the
  unblocked stream of the same seed.

Every sampler draws its offsets in :meth:`ReplaySignalSource.
_window_offsets`, the one place they are drawn.
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
from ccka_tpu_torch.sim import lanes

_FIELDS = ("spot_price_hr", "od_price_hr", "carbon_g_kwh", "demand_pods",
           "is_peak")


def _indexed_device(device) -> torch.device:
    """:func:`resolve_device` with the card's index filled in: a tensor's
    device carries one (``cuda:0``), and a bare ``cuda`` compares unequal
    to it, which would refuse a caller's ``out=`` buffer and miss the
    extension cache."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
    add their lane blocks to the packed device streams: the stored trace
    is calm weather and records only the primary demand, so both are
    synthesized on top of the replayed windows.
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
        self._ext_dev: ExogenousTrace | None = None  # see _extension

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

    # -- device window samplers --------------------------------------------

    def _window_offsets(self, generator: torch.Generator,
                        n: int) -> torch.Tensor:
        """The one per-window offset draw ([n] int64 on the generator's
        device): uniform over the stored length, shifted by
        ``offset_steps``. The exo windows and the workload lanes that are
        phased to them read the same draw."""
        stored = self._trace.steps
        return (self.offset_steps + torch.randint(
            0, stored, (n,), generator=generator,
            device=generator.device)) % stored

    def _extension(self, length: int, dev: torch.device) -> ExogenousTrace:
        """The periodic extension of the store, at least ``length`` ticks,
        on ``dev``: tiled once and cached (a longer request re-tiles;
        the extension is prefix-stable, so a shorter one is its prefix)."""
        cached = self._ext_dev
        if cached is not None and cached.is_peak.device == dev:
            if cached.steps >= length:
                return cached
            # Geometric growth: a block loop re-tiles O(log) times.
            length = max(length, 2 * cached.steps)
        self._ext_dev = self._trace_at(0, length).to(dev)
        return self._ext_dev

    def _windows(self, ext: ExogenousTrace, starts: torch.Tensor,
                 steps: int) -> ExogenousTrace:
        """[n, steps, ...] windows of ``ext`` starting at ``starts``."""
        idx = (starts[:, None]
               + torch.arange(steps, device=starts.device)[None, :])
        return ExogenousTrace(*(a[idx] for a in ext))

    def batch_trace_device(self, steps: int, generator: torch.Generator,
                           batch: int, device=None, *,
                           sharding=None) -> ExogenousTrace:
        """[B, T, ...] windows sampled on ``device``: offsets uniform over
        the stored length, drawn from ``generator`` (which must live on
        that device), windows gathered from the cached extension. Windows
        may overlap (the store is finite): sampling with replacement over
        the window population. ``sharding`` is refused, as in the JAX
        package (``supports_device_traces`` stays False)."""
        if sharding is not None:
            raise SystemExit(
                "ccka: replay traces are sampled from a host-resident "
                "store and cannot be synthesized into a device sharding; "
                "use the synthetic signals backend for sharded "
                "--device-traces fleets")
        dev = _indexed_device(device)
        ext = self._extension(self._trace.steps + steps, dev)
        return self._windows(ext, self._window_offsets(generator, batch),
                             steps)

    def packed_rows(self) -> int:
        """Rows of this source's packed stream: the exo block and each
        present lane block."""
        z = self._trace.n_zones
        return (lanes.exo_rows(z)
                + (lanes.fault_rows(z) if self.faults else 0)
                + (lanes.workload_rows(z) if self.workloads else 0))

    def _pack(self, tr: ExogenousTrace, starts: torch.Tensor, steps: int,
              t_pad: int, lane_seed: int, out: torch.Tensor | None,
              dev: torch.device) -> torch.Tensor:
        """``tr`` packed into ``[t_pad, packed_rows(), B]`` (into ``out``
        when given), each lane block drawn from its family's generator of
        ``lane_seed``; the workload lanes' clocks start at ``starts``."""
        from ccka_tpu_torch.faults.process import packed_fault_lanes
        from ccka_tpu_torch.signals.synthetic import family_generator
        from ccka_tpu_torch.sim.megakernel import _pack_exo
        from ccka_tpu_torch.workloads.process import packed_workload_lanes

        z = self._trace.n_zones
        batch = int(starts.shape[0])
        shape = (t_pad, self.packed_rows(), batch)
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=dev)
        elif (tuple(out.shape) != shape or out.dtype != torch.float32
              or out.device != dev or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous float32 tensor "
                             f"{list(shape)} on {dev}, got {out.dtype} "
                             f"{list(out.shape)} on {out.device}")
        base = lanes.exo_rows(z)
        out[:, :base] = _pack_exo(tr, t_pad)
        if self.faults is not None:
            # No price_dev: the stored spot series carries no separable
            # anomaly channel, so the price-correlated hazard term is
            # the synthetic backend's alone.
            hi = base + lanes.fault_rows(z)
            out[:, base:hi] = packed_fault_lanes(
                self.faults, family_generator(lane_seed,
                                              lanes.FAULT_KEY_TAG, dev),
                steps, t_pad, z, batch)
            base = hi
        if self.workloads is not None:
            dt_s = self._meta.dt_s or 30.0
            out[:, base:base + lanes.workload_rows(z)] = \
                packed_workload_lanes(
                    self.workloads, family_generator(
                        lane_seed, lanes.WORKLOAD_KEY_TAG, dev),
                    steps, t_pad, z, batch, dt_s=dt_s,
                    start_unix_s=self._meta.start_unix_s,
                    start_offset_s=starts.to(torch.float32) * dt_s,
                    wrap_period_s=self._trace.steps * dt_s)
        return out

    def packed_trace_device(self, steps: int, seed: int, batch: int, *,
                            t_pad: int | None = None,
                            out: torch.Tensor | None = None,
                            device=None) -> torch.Tensor:
        """The packed ``[T_pad, packed_rows(), B]`` stream of replayed
        windows on ``device``: the windows :meth:`batch_trace_device`
        samples from ``family_generator(seed, None)``, packed as the
        kernels read them, then the fault and workload lane blocks.
        ``t_pad`` (default ``steps``) pads with zero ticks; ``out`` takes
        a dead stream of the same shape and is written over."""
        from ccka_tpu_torch.signals.synthetic import family_generator

        if out is not None and device is None:
            device = out.device
        dev = _indexed_device(device)
        t_pad = steps if t_pad is None else int(t_pad)
        if t_pad < steps:
            raise ValueError(f"t_pad={t_pad} < steps={steps}")
        offs = self._window_offsets(family_generator(int(seed), None, dev),
                                    batch)
        tr = self._windows(self._extension(self._trace.steps + steps, dev),
                           offs, steps)
        return self._pack(tr, offs, steps, t_pad, int(seed), out, dev)

    def packed_block_trace_device(self, block_T: int, seed: int, batch: int,
                                  block_index: int, *,
                                  total_steps: int | None = None,
                                  shard: int | None = None,
                                  out: torch.Tensor | None = None,
                                  t_chunk: int = 64,
                                  device=None) -> torch.Tensor:
        """Block ``block_index`` (``[block_T, packed_rows(), B]``) of the
        replayed stream of ``seed``: the window offsets are drawn once per
        seed (the same draw as :meth:`packed_trace_device`), so block
        ``j`` replays ticks ``[j*block_T, (j+1)*block_T)`` of the same
        windows and the exo rows of a blocked run concatenate bitwise to
        the unblocked stream's. The lane blocks draw from the block's own
        seed (`signals/synthetic.py::block_seed`), the blocked lane family
        of the synthetic backend. ``total_steps`` sizes the extension
        once for the whole horizon; ``shard`` (a cluster chunk's index)
        gives that chunk its own windows."""
        from ccka_tpu_torch.signals.synthetic import (block_seed,
                                                      family_generator)

        lanes.block_layout(block_T, block_T, t_chunk)  # divisibility
        if out is not None and device is None:
            device = out.device
        dev = _indexed_device(device)
        j = int(block_index)
        wseed = int(seed)
        if shard is not None:
            wseed = int(np.random.SeedSequence(
                [int(seed), int(shard)]).generate_state(1, np.uint64)[0])
        offs = self._window_offsets(family_generator(wseed, None, dev),
                                    batch)
        # + block_T of slack: the last block covers the padded horizon.
        horizon = max(int(total_steps or 0), (j + 1) * block_T)
        ext = self._extension(self._trace.steps + horizon + block_T, dev)
        t0 = offs + j * block_T
        tr = self._windows(ext, t0, block_T)
        return self._pack(tr, t0, block_T, block_T,
                          block_seed(seed, j, shard), out, dev)


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
