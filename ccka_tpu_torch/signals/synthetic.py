"""Synthetic signal backend: diurnal price/carbon + bursty demand.

The PyTorch form of `ccka_tpu/signals/synthetic.py`. Three generators:

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
  exo rows bitwise those of the plain stream on the same seed.

The first two share :meth:`SyntheticSignalSource._assemble`, the third
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

    def meta(self) -> TraceMeta:
        return TraceMeta(
            source="synthetic",
            start_unix_s=self.start_unix_s,
            dt_s=self.sim.dt_s,
            zones=self.cluster.zones,
            description="sinusoidal diurnal spot price + duck-curve carbon "
                        "+ bursty demand",
        )

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
        from ccka_tpu_torch.faults.process import packed_fault_lanes
        from ccka_tpu_torch.workloads.process import packed_workload_lanes

        dev = resolve_device(device)
        t_pad = steps if t_pad is None else int(t_pad)
        if t_pad < steps:
            raise ValueError(f"t_pad={t_pad} < steps={steps}")
        z = self.cluster.n_zones

        def generate(seed: int) -> torch.Tensor:
            g = family_generator(seed, None, dev)
            noise = (_ar1_scan(g, (steps, z, batch), *_AR1_SPOT),
                     _ar1_scan(g, (steps, z, batch), *_AR1_CARBON),
                     _ar1_scan(g, (steps, batch), *_AR1_DEMAND))
            out = torch.zeros((t_pad, self.packed_rows(), batch),
                              dtype=torch.float32, device=dev)
            base = lanes.exo_rows(z)
            out[:, :base] = self._assemble_packed(steps, t_pad, noise)
            if self.faults is not None:
                hi = base + lanes.fault_rows(z)
                out[:, base:hi] = packed_fault_lanes(
                    self.faults, family_generator(
                        seed, lanes.FAULT_KEY_TAG, dev),
                    steps, t_pad, z, batch, price_dev=noise[0])
                base = hi
            del noise
            if self.workloads is not None:
                out[:, base:base + lanes.workload_rows(z)] = \
                    packed_workload_lanes(
                        self.workloads, family_generator(
                            seed, lanes.WORKLOAD_KEY_TAG, dev),
                        steps, t_pad, z, batch, dt_s=self.sim.dt_s,
                        start_unix_s=self.start_unix_s)
            return out

        return generate

    def packed_trace_device(self, steps: int, seed: int, batch: int, *,
                            t_pad: int | None = None,
                            device=None) -> torch.Tensor:
        """The packed ``[T_pad, packed_rows(), B]`` stream the rollout
        kernels read (rows: spot, od, carbon, demand, is_peak, padding,
        then the fault and workload blocks), synthesized in that layout
        on ``device``: no [B, T, ...] trace and no transpose. The AR(1)
        noise is a log-depth doubling scan (:func:`_ar1_scan`). The same
        generative family as :meth:`batch_trace_device`, another random
        stream. ``t_pad`` (default ``steps``) pads the horizon with
        zero ticks."""
        return self.packed_generate_fn(steps, batch, t_pad=t_pad,
                                       device=device)(int(seed))

    def _assemble_packed(self, steps: int, t_pad: int,
                         noise: tuple) -> torch.Tensor:
        """The :meth:`_assemble` formulas, time-major: noise (spot
        [T, Z, B], carbon [T, Z, B], demand [T, B]) -> the exo block
        [T_pad, exo_rows(Z), B] (zero padding)."""
        spot_noise, carbon_noise, demand_noise = noise
        dev = spot_noise.device
        B = demand_noise.shape[-1]
        t = self.start_unix_s + np.arange(steps) * self.sim.dt_s  # [T] f64
        tod = torch.as_tensor(((t % _DAY_S) / _DAY_S).astype(np.float32),
                              device=dev)                         # [T]
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
