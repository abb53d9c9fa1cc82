"""Synthetic signal backend: diurnal price/carbon + bursty demand.

The PyTorch form of `ccka_tpu/signals/synthetic.py`. Four generators:

- :meth:`batch_trace` draws its AR(1) noise on the host with numpy's
  per-seed streams, exactly as the JAX package's ``batch_trace`` does, so
  the two packages give the same traces for the same seeds;
- :meth:`batch_trace_device` draws the noise with a ``torch.Generator`` on
  the device: the same generative family, another random stream;
- :meth:`packed_trace_device` synthesizes the kernels' packed
  ``[T_pad, rows, B]`` stream directly, time-major, with the fault and
  workload lane blocks of the source's ``faults=`` and ``workloads=``
  configs appended. Each lane family draws from its own generator,
  seeded from (seed, the family's tag), so widening a stream leaves its
  exo rows bitwise those of the plain stream on the same seed;
- :meth:`packed_block_trace_device` synthesizes one time block of such a
  stream at its global tick, from the block's own seed
  (:func:`block_seed`): the streaming pipeline's unit
  (`sim/streaming.py`).

The first two share :meth:`SyntheticSignalSource._assemble`, the last two
:meth:`SyntheticSignalSource._assemble_packed` (the same formulas).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import (ClusterConfig, SignalsConfig, SimConfig,
                                   WorkloadConfig)
from ccka_tpu_torch.signals.base import ExogenousTrace, SignalSource, TraceMeta
from ccka_tpu_torch.sim import lanes

_DAY_S = 86400.0

# AR(1) families: (rho, sigma) of the spot-price, carbon and demand noise.
_AR1_SPOT = (0.97, 0.04)
_AR1_CARBON = (0.95, 0.03)
_AR1_DEMAND = (0.9, 0.5)


class SyntheticSignalSource(SignalSource):
    """Sinusoidal diurnal spot price and carbon intensity, bursty demand.

    - Spot price: node-type mean, +-35% diurnal swing, AR(1) noise,
      per-zone phase offsets; clipped to [20%, 95%] of on-demand.
    - On-demand price: constant per zone.
    - Carbon: base minus a midday solar dip plus an evening ramp, noise.
    - Demand: 40% of the burst scale off-peak rising to the full burst at
      peak, bursty noise, split over the two workload classes.
    - is_peak: 1 during 09:00-21:00 local.
    """

    def __init__(self, cluster: ClusterConfig, workload: WorkloadConfig,
                 sim: SimConfig, signals: SignalsConfig, *,
                 start_unix_s: float = 0.0, faults=None, workloads=None):
        self.cluster = cluster
        self.workload = workload
        self.sim = sim
        self.signals = signals
        self.start_unix_s = start_unix_s
        # The packed stream's lane blocks: a FaultsConfig / WorkloadsConfig
        # that is None or disabled adds none.
        self.faults = faults if faults is not None and faults.enabled \
            else None
        self.workloads = (workloads if workloads is not None
                          and workloads.enabled else None)
        self._zp = self._zone_params()
        # Longest trace assembled so far per seed, on the CPU. Generation
        # is prefix-stable (numpy's per-seed streams draw step by step),
        # so a shorter request is a slice of it, and a tick costs O(1)
        # amortized instead of regenerating O(t) every scrape.
        self._cache: dict[int, ExogenousTrace] = {}

    supports_device_traces = True

    def meta(self) -> TraceMeta:
        return TraceMeta(
            source="synthetic",
            start_unix_s=self.start_unix_s,
            dt_s=self.sim.dt_s,
            zones=self.cluster.zones,
            description="sinusoidal diurnal spot price + duck-curve carbon "
                        "+ bursty demand",
        )

    def trace(self, steps: int, *, seed: int = 0,
              device=None) -> ExogenousTrace:
        """[T, ...]: one seed's trace, a slice of the cached one; the
        same numbers as ``batch_trace(steps, [seed], device="cpu")[0]``
        on every device."""
        return self.forecast(0, steps, seed=seed, device=device)

    def tick(self, t_index: int, *, seed: int = 0,
             device=None) -> ExogenousTrace:
        """Tick ``t_index`` as a one-step trace, sliced out of the cache."""
        return self.forecast(t_index, 1, seed=seed, device=device)

    def forecast(self, t_index: int, steps: int, *, seed: int = 0,
                 device=None) -> ExogenousTrace:
        dev = resolve_device(device)
        self._ensure_cached(t_index + steps, seed)
        return self._cache[seed].slice_steps(t_index, steps).to(dev)

    def _ensure_cached(self, steps: int, seed: int) -> None:
        cached = self._cache.get(seed)
        if cached is not None and cached.steps >= steps:
            return
        # Geometric growth: a tick-by-tick caller regenerates rarely.
        gen_steps = max(steps, 2 * cached.steps if cached is not None
                        else 0, 128)
        self._cache[seed] = ExogenousTrace(*(x[0] for x in self.batch_trace(
            gen_steps, [seed], device="cpu")))

    def batch_trace(self, steps: int, seeds, device=None) -> ExogenousTrace:
        """[B, T, ...] traces for a batch of seeds: numpy's per-seed noise
        streams (the JAX package's ``batch_trace`` draws the same numbers),
        assembled in torch on ``device``."""
        dev = resolve_device(device)
        noises = [self._noise(steps, int(s)) for s in seeds]
        stacked = tuple(torch.as_tensor(np.stack(parts), device=dev)
                        for parts in zip(*noises))
        return self._assemble(steps, stacked)

    def batch_trace_device(self, steps: int, generator: torch.Generator,
                           batch: int, device=None) -> ExogenousTrace:
        """[B, T, ...] trace batch synthesized on ``device``, its AR(1)
        noise drawn from ``generator`` (which must live on that device)."""
        dev = resolve_device(device)
        z = self.cluster.n_zones
        noise = (
            _ar1_device(generator, (batch, steps, z), *_AR1_SPOT, dev),
            _ar1_device(generator, (batch, steps, z), *_AR1_CARBON, dev),
            _ar1_device(generator, (batch, steps), *_AR1_DEMAND, dev),
        )
        return self._assemble(steps, noise)

    def packed_rows(self) -> int:
        """Rows of this source's packed stream: the exo block and each
        present lane block."""
        z = self.cluster.n_zones
        return (lanes.exo_rows(z)
                + (lanes.fault_rows(z) if self.faults else 0)
                + (lanes.workload_rows(z) if self.workloads else 0))

    def packed_generate_fn(self, steps: int, batch: int, *,
                           t_pad: int | None = None, device=None):
        """``seed -> [T_pad, packed_rows(), B]`` stream synthesis on
        ``device``: the exo rows from the generator seeded by ``seed``
        alone, each lane block from its family's own generator."""
        dev = resolve_device(device)
        t_pad = steps if t_pad is None else int(t_pad)
        if t_pad < steps:
            raise ValueError(f"t_pad={t_pad} < steps={steps}")

        def generate(seed: int) -> torch.Tensor:
            return self._synthesize(int(seed), steps, t_pad, batch, dev)

        return generate

    def _synthesize(self, seed: int, steps: int, t_pad: int, batch: int,
                    dev, *, t0_ticks: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """One packed stream from ``seed``: the exo noise from
        ``family_generator(seed, None)``, each lane block from its
        family's generator. ``t0_ticks`` puts the first row at that
        global tick (the diurnal, peak and workload clocks); ``out``
        (``[t_pad, packed_rows(), B]``, float32 on ``dev``) is written in
        place of a new tensor, every element of it."""
        from ccka_tpu_torch.faults.process import packed_fault_lanes
        from ccka_tpu_torch.workloads.process import packed_workload_lanes

        z = self.cluster.n_zones
        shape = (t_pad, self.packed_rows(), batch)
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=dev)
        elif (tuple(out.shape) != shape or out.dtype != torch.float32
              or out.device.type != torch.device(dev).type
              or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous float32 tensor "
                             f"{list(shape)} on {dev}, got {out.dtype} "
                             f"{list(out.shape)} on {out.device}")
        g = family_generator(seed, None, dev)
        noise = (_ar1_scan(g, (steps, z, batch), *_AR1_SPOT),
                 _ar1_scan(g, (steps, z, batch), *_AR1_CARBON),
                 _ar1_scan(g, (steps, batch), *_AR1_DEMAND))
        base = lanes.exo_rows(z)
        out[:, :base] = self._assemble_packed(steps, t_pad, noise,
                                              t0_ticks=t0_ticks)
        if self.faults is not None:
            hi = base + lanes.fault_rows(z)
            out[:, base:hi] = packed_fault_lanes(
                self.faults, family_generator(seed, lanes.FAULT_KEY_TAG,
                                              dev),
                steps, t_pad, z, batch, price_dev=noise[0])
            base = hi
        del noise
        if self.workloads is not None:
            offset = None
            if t0_ticks is not None:
                offset = np.full(batch, np.float32(t0_ticks)
                                 * np.float32(self.sim.dt_s), np.float32)
            out[:, base:base + lanes.workload_rows(z)] = \
                packed_workload_lanes(
                    self.workloads, family_generator(
                        seed, lanes.WORKLOAD_KEY_TAG, dev),
                    steps, t_pad, z, batch, dt_s=self.sim.dt_s,
                    start_unix_s=self.start_unix_s, start_offset_s=offset)
        return out

    def packed_trace_device(self, steps: int, seed: int, batch: int, *,
                            t_pad: int | None = None,
                            out: torch.Tensor | None = None,
                            device=None) -> torch.Tensor:
        """The packed ``[T_pad, packed_rows(), B]`` stream the rollout
        kernels read (rows: spot, od, carbon, demand, is_peak, padding,
        then the fault and workload blocks), synthesized in that layout
        on ``device``: no [B, T, ...] trace and no transpose. The AR(1)
        noise is a log-depth doubling scan (:func:`_ar1_scan`). The same
        generative family as :meth:`batch_trace_device`, another random
        stream. ``t_pad`` (default ``steps``) pads the horizon with
        zero ticks. ``out`` takes a dead stream of the same shape and
        writes the stream into it (the port's counterpart of JAX's
        ``recycle=`` donation)."""
        if out is None:
            return self.packed_generate_fn(steps, batch, t_pad=t_pad,
                                           device=device)(int(seed))
        t_pad = steps if t_pad is None else int(t_pad)
        return self._synthesize(int(seed), steps, t_pad, batch, out.device,
                                out=out)

    def packed_block_generate_fn(self, block_T: int, batch: int, *,
                                 t_chunk: int = 64, device=None):
        """``(block_seed, t0_ticks, out=None) -> [block_T, packed_rows(),
        B]``: the streaming pipeline's unit of synthesis
        (`sim/streaming.py`). ``block_seed`` is one block's seed
        (:func:`block_seed`); ``t0_ticks`` the global tick of its first
        row, so the diurnal, peak and workload clocks run on the same
        wall clock as an unblocked stream's.

        Each block is an independent segment of the same generative
        family: the AR(1) latents restart from their stationary draw at
        every block, so a blocked stream is another random stream than an
        unblocked one on the same seed, with the same marginals (use one
        or the other within an experiment). Each lane family draws from
        the block's seed under its own tag, so widening a blocked stream
        leaves its exo and fault rows bitwise the same."""
        lanes.block_layout(block_T, block_T, t_chunk)  # divisibility
        dev = resolve_device(device)

        def generate(seed: int, t0_ticks: int,
                     out: torch.Tensor | None = None) -> torch.Tensor:
            return self._synthesize(int(seed), block_T, block_T, batch, dev,
                                    t0_ticks=int(t0_ticks), out=out)

        return generate

    def packed_block_trace_device(self, block_T: int, seed: int, batch: int,
                                  block_index: int, *,
                                  shard: int | None = None,
                                  out: torch.Tensor | None = None,
                                  t_chunk: int = 64,
                                  device=None) -> torch.Tensor:
        """Block ``block_index`` (``[block_T, packed_rows(), B]``) of the
        blocked stream family of ``seed``, starting at global tick
        ``block_index * block_T``; ``shard`` (a cluster chunk's index)
        gives chunk ``shard`` its own world. ``out`` takes a dead block
        buffer of the same shape and writes the block into it (the port's
        counterpart of JAX's ``recycle=`` donation): a block loop then
        allocates no stream after its first two blocks."""
        if out is not None and device is None:
            device = out.device
        return self.packed_block_generate_fn(
            block_T, batch, t_chunk=t_chunk, device=device)(
            block_seed(seed, block_index, shard), block_index * block_T,
            out=out)

    def _assemble_packed(self, steps: int, t_pad: int, noise: tuple,
                         t0_ticks: int | None = None) -> torch.Tensor:
        """The :meth:`_assemble` formulas, time-major: noise (spot
        [T, Z, B], carbon [T, Z, B], demand [T, B]) -> the exo block
        [T_pad, exo_rows(Z), B] (zero padding).

        ``t0_ticks``: the global tick of the first row (a block of a
        blocked stream). The clock then runs in float32 from the day
        fraction of ``start_unix_s``, reduced in float64 on the host, as
        the JAX package's block synthesis computes it; ``None`` keeps the
        float64 host clock of an unblocked stream."""
        spot_noise, carbon_noise, demand_noise = noise
        dev = spot_noise.device
        B = demand_noise.shape[-1]
        if t0_ticks is None:
            t = self.start_unix_s + np.arange(steps) * self.sim.dt_s
            tod = torch.as_tensor(((t % _DAY_S) / _DAY_S).astype(np.float32),
                                  device=dev)                     # [T]
        else:
            day = float(np.float32(_DAY_S))
            ticks = (torch.arange(steps, dtype=torch.float32, device=dev)
                     + float(np.float32(t0_ticks)))
            tod = torch.remainder(
                float(np.float32(self.start_unix_s % _DAY_S))
                + torch.remainder(ticks * float(np.float32(self.sim.dt_s)),
                                  day), day) / day
        tod_zb = tod[:, None, None]
        nt = self.cluster.node_type
        zp = {k: torch.as_tensor(v, device=dev)[None, :, None]
              for k, v in self._zp.items()}

        diurnal = 1.0 + 0.35 * torch.sin(
            2 * np.pi * (tod_zb - 0.25 + zp["spot_phase"]))      # [T, Z, 1]
        spot = (nt.spot_price_hr_mean * zp["spot_scale"] * diurnal
                * (1.0 + spot_noise))                            # [T, Z, B]
        od_z = float(nt.od_price_hr) * zp["od_scale"]            # [1, Z, 1]
        spot = torch.minimum(torch.maximum(spot, 0.2 * od_z), 0.95 * od_z)

        base = zp["carbon_base"]
        solar = zp["solar_frac"] * base * _bump(
            tod_zb + zp["solar_phase"], center=13.5 / 24, width=3.5 / 24)
        evening = 0.25 * base * _bump(tod_zb + zp["evening_phase"],
                                      center=19.5 / 24, width=2.0 / 24)
        carbon = (base - solar + evening) * zp["carbon_scale"]
        carbon = torch.clamp(carbon * (1.0 + carbon_noise), min=20.0)

        total = float(self.workload.total_pods)
        level = total * (0.4 + 0.6 * _bump(tod, center=14.0 / 24,
                                           width=5.0 / 24))[:, None]
        level = torch.clamp(level * (1.0 + 0.15 * demand_noise),
                            0.0, 2.0 * total)                    # [T, B]
        is_peak = ((tod >= 9 / 24) & (tod < 21 / 24)).to(torch.float32)

        Z = self.cluster.n_zones
        out = torch.zeros((t_pad, lanes.exo_rows(Z), B), dtype=torch.float32,
                          device=dev)
        out[:steps, 0:Z] = spot
        out[:steps, Z:2 * Z] = od_z
        out[:steps, 2 * Z:3 * Z] = carbon
        out[:steps, 3 * Z] = torch.ceil(level / 2.0)
        out[:steps, 3 * Z + 1] = torch.floor(level / 2.0)
        out[:steps, 3 * Z + 2] = is_peak[:, None]
        return out

    def _zone_params(self) -> dict[str, np.ndarray]:
        """Per-zone signal parameters, each a float32 [Z] array. A
        multi-region cluster gives each zone its region's grid profile."""
        z = self.cluster.n_zones
        frac = np.arange(z, dtype=np.float32) / max(z, 1)
        default = np.float32(self.signals.carbon_default_g_kwh)
        zp = {
            "spot_phase": frac * 0.15,
            "solar_phase": np.zeros(z, np.float32),
            "evening_phase": frac * 0.15,
            "carbon_base": np.full(z, default, np.float32),
            "solar_frac": np.full(z, 0.45, np.float32),
            "carbon_scale": 1.0 + 0.1 * frac,
            "od_scale": np.ones(z, np.float32),
            "spot_scale": np.ones(z, np.float32),
        }
        if not self.cluster.regions:
            return zp
        i = 0
        for r in self.cluster.regions:
            nz = max(len(r.zones), 1)
            tzf = np.float32(r.tz_offset_hr / 24.0)
            for j in range(len(r.zones)):
                intra = np.float32(j / nz)
                zp["spot_phase"][i] = tzf + 0.05 * intra
                zp["solar_phase"][i] = tzf
                zp["evening_phase"][i] = tzf + 0.05 * intra
                zp["carbon_base"][i] = r.carbon_base_g_kwh or default
                zp["solar_frac"][i] = r.solar_frac
                zp["carbon_scale"][i] = 1.0 + 0.1 * intra
                zp["od_scale"][i] = r.od_price_scale
                zp["spot_scale"][i] = r.spot_price_scale
                i += 1
        return {k: v.astype(np.float32) for k, v in zp.items()}

    def _noise(self, steps: int, seed: int) -> tuple[np.ndarray, ...]:
        """Per-family AR(1) noise streams for one seed (numpy)."""
        z = self.cluster.n_zones
        return (
            _ar1(np.random.default_rng([seed, 0]), (steps, z), *_AR1_SPOT),
            _ar1(np.random.default_rng([seed, 1]), (steps, z), *_AR1_CARBON),
            _ar1(np.random.default_rng([seed, 2]), (steps,), *_AR1_DEMAND),
        )

    def _assemble(self, steps: int, noise: tuple) -> ExogenousTrace:
        """Deterministic diurnal structure + noise -> trace.

        ``noise`` is (spot [B, T, Z], carbon [B, T, Z], demand [B, T])
        float32 tensors on one device; the trace comes back there."""
        spot_noise, carbon_noise, demand_noise = noise
        dev = spot_noise.device
        t = self.start_unix_s + np.arange(steps) * self.sim.dt_s  # [T] f64
        tod = torch.as_tensor(((t % _DAY_S) / _DAY_S).astype(np.float32),
                              device=dev)                         # [T]
        tod_z = tod[:, None]
        nt = self.cluster.node_type
        zp = {k: torch.as_tensor(v, device=dev) for k, v in self._zp.items()}

        diurnal = 1.0 + 0.35 * torch.sin(
            2 * np.pi * (tod_z - 0.25 + zp["spot_phase"]))       # [T, Z]
        spot = (nt.spot_price_hr_mean * zp["spot_scale"] * diurnal
                * (1.0 + spot_noise))
        od_z = float(nt.od_price_hr) * zp["od_scale"]       # [Z]
        spot = torch.minimum(torch.maximum(spot, 0.2 * od_z), 0.95 * od_z)
        od = od_z.expand(spot.shape)

        base = zp["carbon_base"]
        solar = zp["solar_frac"] * base * _bump(
            tod_z + zp["solar_phase"], center=13.5 / 24, width=3.5 / 24)
        evening = 0.25 * base * _bump(tod_z + zp["evening_phase"],
                                      center=19.5 / 24, width=2.0 / 24)
        carbon = base - solar + evening
        carbon = carbon * zp["carbon_scale"]
        carbon = carbon * (1.0 + carbon_noise)
        carbon = torch.clamp(carbon, min=20.0)

        is_peak = ((tod >= 9 / 24) & (tod < 21 / 24)).to(torch.float32)
        is_peak = is_peak.expand(demand_noise.shape)

        total = float(self.workload.total_pods)
        level = total * (0.4 + 0.6 * _bump(tod, center=14.0 / 24,
                                           width=5.0 / 24))
        level = level * (1.0 + 0.15 * demand_noise)
        level = torch.clamp(level, 0.0, 2.0 * total)
        demand = torch.stack([torch.ceil(level / 2.0),
                              torch.floor(level / 2.0)], dim=-1)

        trace = ExogenousTrace(
            spot_price_hr=spot.contiguous(),
            od_price_hr=od.contiguous(),
            carbon_g_kwh=carbon.contiguous(),
            demand_pods=demand.contiguous(),
            is_peak=is_peak.contiguous(),
        )
        trace.validate_shapes()
        return trace


def _ar1(rng: np.random.Generator, shape, rho: float,
         sigma: float) -> np.ndarray:
    """Stationary AR(1) noise along axis 0 (numpy, float32): ``x0 =
    N(0,s); x_t = rho x_{t-1} + sqrt(1-rho^2) N(0,s)`` from one normal
    stream whose first draw is the initial condition; the recursion runs
    in `scipy.signal.lfilter`."""
    from scipy.signal import lfilter

    steps = shape[0]
    rest = shape[1:]
    eps = rng.standard_normal(size=(steps + 1,) + rest, dtype=np.float32)
    eps *= np.float32(sigma)
    scale = np.float32(np.sqrt(1.0 - rho * rho))
    zi = (np.float32(rho) * eps[0])[None, ...]
    out, _ = lfilter(np.asarray([scale], np.float32),
                     np.asarray([1.0, -rho], np.float32), eps[1:],
                     axis=0, zi=zi)
    return out


def _ar1_device(generator: torch.Generator, shape, rho: float, sigma: float,
                device) -> torch.Tensor:
    """Stationary AR(1) along axis 1 of ``shape`` ([B, T, ...]), drawn on
    ``device``: ``x_0 ~ N(0, s)``, then the recurrence stepped over T."""
    x0_shape = (shape[0],) + tuple(shape[2:])
    x0 = sigma * torch.randn(x0_shape, generator=generator, device=device)
    eps = torch.randn(shape, generator=generator, device=device)
    eps.mul_(float(np.float32(math.sqrt(1.0 - rho * rho) * sigma)))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    prev = x0
    for t in range(shape[1]):
        prev = rho * prev + eps[:, t]
        out[:, t] = prev
    return out


def family_generator(seed: int, tag: int | None, device) -> torch.Generator:
    """The generator of one family of a packed stream: the exo noise
    (``tag`` None) or a lane family (its key tag), seeded by mixing
    (``seed``, ``tag``), so families never share draws."""
    words = [int(seed)] if tag is None else [int(seed), int(tag)]
    mixed = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def block_seed(seed: int, block_index: int, shard: int | None = None) -> int:
    """The seed of block ``block_index`` of a blocked stream of ``seed``
    (and of cluster chunk ``shard``): (``seed``, ``BLOCK_KEY_TAG``, the
    block[, the chunk]) mixed as :func:`family_generator` mixes a family,
    so blocks, chunks and lane families never share draws."""
    words = [int(seed), lanes.BLOCK_KEY_TAG, int(block_index)]
    if shard is not None:
        words.append(int(shard))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def _ar1_scan(generator: torch.Generator, shape, rho: float,
              sigma: float) -> torch.Tensor:
    """Stationary AR(1) along axis 0 of ``shape`` ([T, ...]) on the
    generator's device: ``x_0 ~ N(0, s)`` (drawn first, then the [T, ...]
    innovations), ``x_t = rho x_{t-1} + sqrt(1 - rho^2) N(0, s)``. The
    recurrence runs as a doubling scan: after pass k every tick holds the
    sum of its last 2^k weighted innovations, so ceil(log2 T) passes of
    whole-tensor work replace T small steps."""
    dev = generator.device
    steps = shape[0]
    x0 = sigma * torch.randn((1,) + tuple(shape[1:]), generator=generator,
                             device=dev)
    y = torch.randn(shape, generator=generator, device=dev)
    y.mul_(float(np.float32(math.sqrt(1.0 - rho * rho) * sigma)))
    span, coef = 1, rho
    while span < steps:
        y[span:] += y[:-span] * coef
        span, coef = 2 * span, coef * coef
    apow = torch.as_tensor(
        (rho ** np.arange(1, steps + 1, dtype=np.float64)).astype(np.float32),
        device=dev).reshape((steps,) + (1,) * (len(shape) - 1))
    return y.add_(apow * x0)


def _bump(x, center: float, width: float):
    """Smooth periodic bump in [0,1] centered at ``center`` (day fraction)."""
    d = torch.minimum(torch.abs(x - center), 1.0 - torch.abs(x - center))
    return torch.exp(-0.5 * (d / (width / 2.0)) ** 2)
