"""Disturbance processes, synthesized as lane blocks of the packed stream.

The PyTorch form of `ccka_tpu/faults/process.py`: a
``[T_pad, fault_rows(Z), B]`` block appended to the exo stream the
rollout kernels read, so every policy scored on one stream sees one
fault realization. Rows, from the block's first:

    0..Z-1   preempt_hazard[z]  multiplier on interrupt_p (1 = calm)
    Z        deny_frac          spot provisioning denied this tick
    Z+1      delay_frac         pipeline arrivals held back one tick
    Z+2      signal_stale       {0,1} outage indicator
    padding to a multiple of 8 (zeros)

Windows (storms, insufficient capacity, outages) are thresholded
stationary AR(1) latents: the threshold for an in-window share ``f`` is
the Gaussian quantile ``Phi^-1(1 - f)`` (``f = 0`` gives +inf: never),
and ``rho = exp(-1 / mean_ticks)`` sets the window length. Generation is
two steps: :func:`draw_fault_latents` draws the four AR(1) latents from
the family's generator, and :func:`fault_lanes_from_latents` turns
latents into lanes, a pure function (the tests feed it the JAX package's
latents). With every intensity at 0 the lanes are exactly (hazard 1,
deny 0, delay 0, stale 0): consuming them is bitwise a no-op.

The scenario axis (`search/axis.py`) takes the intensities per cell:
:func:`draw_fault_normals` draws the unit normals once at the inner
width, and :func:`fault_lanes_p` makes the block of S cells from them,
each cell bitwise the baked block of its config on the same draws.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

from ccka_tpu_torch.config import FaultsConfig
from ccka_tpu_torch.faults.types import FaultStep
from ccka_tpu_torch.sim import lanes

# The spot-price AR(1) sigma: the unit of the price coupling (+coupling x
# hazard per +1 sigma of price anomaly).
PRICE_DEV_SIGMA = 0.04


def _threshold(frac: float) -> float:
    """Gaussian threshold for a stationary in-window share ``frac`` of a
    unit-variance latent; ``frac <= 0`` -> +inf (never)."""
    if frac <= 0.0:
        return float("inf")
    return float(NormalDist().inv_cdf(1.0 - frac))


def _window_rho(mean_ticks: int) -> float:
    return math.exp(-1.0 / max(mean_ticks, 1))


def _window(latent: torch.Tensor, frac: float) -> torch.Tensor:
    """{0,1} window indicator of a unit-variance latent."""
    return (latent > _threshold(frac)).to(torch.float32)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package's ``f32(x)``."""
    return float(torch.tensor(x, dtype=torch.float32))


def draw_fault_latents(faults: FaultsConfig, generator: torch.Generator,
                       steps: int, batch: int) -> tuple:
    """The four [T, B] AR(1) latents, in draw order: storm, insufficient
    capacity (ICE), delay burst (rho 0.8), outage. All four are drawn
    whatever the intensities, so every intensity of one seed shares the
    same draws (nested windows at rising severity)."""
    from ccka_tpu_torch.signals.synthetic import _ar1_scan

    shape = (steps, batch)
    return (
        _ar1_scan(generator, shape, _window_rho(
            faults.preempt_storm_mean_ticks), 1.0),
        _ar1_scan(generator, shape, _window_rho(faults.ice_mean_ticks), 1.0),
        _ar1_scan(generator, shape, 0.8, 1.0),
        _ar1_scan(generator, shape, _window_rho(faults.outage_mean_ticks),
                  1.0),
    )


def fault_lanes_from_latents(faults: FaultsConfig, latents: tuple,
                             steps: int, t_pad: int, Z: int, *,
                             price_dev: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Latents (:func:`draw_fault_latents`) -> the
    ``[T_pad, fault_rows(Z), B]`` lane block. ``price_dev``: the spot
    price's AR(1) anomaly [T, Z, B] for the price-coupled hazard; None
    decouples whatever the config says."""
    storm_l, ice_l, burst, outage_l = latents
    batch = storm_l.shape[1]
    hazard = 1.0 + _f32(faults.preempt_storm_hazard) * _window(
        storm_l, faults.preempt_storm_frac)                   # [T, B]
    hazard = hazard[:, None, :].expand(steps, Z, batch)
    if faults.preempt_price_coupling > 0.0 and price_dev is not None:
        hazard = hazard * (1.0 + _f32(faults.preempt_price_coupling)
                           * torch.clamp(price_dev, min=0.0)
                           / PRICE_DEV_SIGMA)
    deny = _f32(faults.ice_deny_frac) * _window(ice_l, faults.ice_frac)
    if faults.delay_jitter_frac > 0.0:
        delay = torch.clamp(_f32(faults.delay_jitter_frac)
                            * (1.0 + 0.5 * burst), 0.0, 0.9)
    else:
        delay = torch.zeros_like(burst)
    stale = _window(outage_l, faults.outage_frac)

    block = torch.zeros((t_pad, lanes.fault_rows(Z), batch),
                        dtype=torch.float32, device=storm_l.device)
    block[:steps, 0:Z] = hazard
    block[:steps, Z] = deny
    block[:steps, Z + 1] = delay
    block[:steps, Z + 2] = stale
    return block


def packed_fault_lanes(faults: FaultsConfig, generator: torch.Generator,
                       steps: int, t_pad: int, Z: int, batch: int, *,
                       price_dev: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """``[T_pad, fault_rows(Z), B]`` lane block drawn from ``generator``
    (the fault family's own, `signals/synthetic.py::family_generator`)
    on its device."""
    return fault_lanes_from_latents(
        faults, draw_fault_latents(faults, generator, steps, batch), steps,
        t_pad, Z, price_dev=price_dev)


def _cells(values, dev, ndim: int) -> torch.Tensor:
    """Float32 [S] values as a tensor of ``ndim`` dims with the cell axis
    at dim 1 (the scenario axis's [T, S, ...] layout)."""
    v = torch.as_tensor(np.asarray(values, np.float32), device=dev)
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def _window_p(latent: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """:func:`_window` with a float32 threshold per cell (a +inf
    threshold, frac 0, gives exact zeros)."""
    return (latent > thresh).to(torch.float32)


def _block_out(out: torch.Tensor | None, shape: tuple, dev) -> torch.Tensor:
    """``out`` checked against ``shape``, or a new float32 block."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    if tuple(out.shape) != shape or out.dtype != torch.float32:
        raise ValueError(f"out must be float32 {list(shape)}, got "
                         f"{out.dtype} {list(out.shape)}")
    return out


def draw_fault_normals(generator: torch.Generator, steps: int,
                       batch: int) -> tuple:
    """The unit normals behind :func:`draw_fault_latents`, in its draw
    order (storm, ICE, delay burst, outage), each an (initial [1, B],
    innovations [T, B]) pair: the draws every cell of the scenario axis
    shares."""
    from ccka_tpu_torch.signals.synthetic import _ar1_normals

    return tuple(_ar1_normals(generator, (steps, batch)) for _ in range(4))


def fault_lanes_p(derived: dict, normals: tuple, steps: int, t_pad: int,
                  Z: int, *, price_dev: torch.Tensor | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``[T_pad, fault_rows(Z), S, B]`` fault block of S cells on one
    set of draws (:func:`draw_fault_normals`, width B): cell s from the
    float32 [S] values of ``derived`` (`search/params.py::ScenarioParams.
    derived()["faults"]`). Each cell repeats :func:`fault_lanes_from_
    latents`' float32 operations in its order, so a cell is bitwise the
    baked block of its config on the same draws; the baked path's host
    gates become arithmetic that is exact at the neutral value (coupling
    0 multiplies by exactly 1.0; ``abs`` turns the delay lane's -0.0 at
    frac 0 into the baked +0.0). ``price_dev`` [T, Z, B] is shared by
    every cell; ``out`` takes a [T_pad, fault_rows(Z), S, B] view."""
    from ccka_tpu_torch.signals.synthetic import _ar1_from_normals

    d = derived
    storm_n, ice_n, burst_n, outage_n = normals
    dev, batch = storm_n[1].device, storm_n[1].shape[1]
    S = len(d["storm_thresh"])
    out = _block_out(out, (t_pad, lanes.fault_rows(Z), S, batch), dev)

    def window(pair, name: str) -> torch.Tensor:            # [T, S, B]
        return _window_p(_ar1_from_normals(*pair, d[name + "_rho64"]),
                         _cells(d[name + "_thresh"], dev, 3))

    hazard = 1.0 + _cells(d["storm_hazard"], dev, 3) * window(storm_n,
                                                              "storm")
    if price_dev is not None:
        torch.mul(hazard[:, None], 1.0 + (
            _cells(d["price_coupling"], dev, 3)[:, None]
            * torch.clamp(price_dev, min=0.0)[:, :, None, :])
            / PRICE_DEV_SIGMA, out=out[:steps, 0:Z])
    else:
        out[:steps, 0:Z] = hazard[:, None]
    del hazard
    out[:steps, Z] = _cells(d["ice_deny"], dev, 3) * window(ice_n, "ice")
    burst = _ar1_from_normals(*burst_n, 0.8)
    out[:steps, Z + 1] = torch.abs(torch.clamp(
        _cells(d["delay_frac"], dev, 3) * (1.0 + 0.5 * burst)[:, None],
        0.0, 0.9))
    out[:steps, Z + 2] = window(outage_n, "outage")
    out[:steps, Z + 3:] = 0.0
    out[steps:] = 0.0
    return out


def packed_fault_lanes_p(derived: dict, generator: torch.Generator,
                         steps: int, t_pad: int, Z: int, batch: int, *,
                         price_dev: torch.Tensor | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`packed_fault_lanes` with the searchable intensities per
    cell (every continuous field of the section arrives through
    ``derived``): the draws at the inner width ``batch`` from
    ``generator`` (the fault family's), then :func:`fault_lanes_p`'s
    ``[T_pad, fault_rows(Z), S, batch]`` block, every cell on the same
    storms (common random numbers)."""
    return fault_lanes_p(derived, draw_fault_normals(generator, steps, batch),
                         steps, t_pad, Z, price_dev=price_dev, out=out)


def has_fault_lanes(exo_packed: torch.Tensor, Z: int) -> bool:
    """Whether a packed stream carries the fault block (from its row
    count; an unknown count raises)."""
    return lanes.stream_layout(int(exo_packed.shape[1]), Z)[0]


def unpack_fault_lanes(exo_packed: torch.Tensor, T: int,
                       Z: int) -> FaultStep:
    """The fault block of a widened stream as a `FaultStep` of views with
    leaves [B, T, Z] / [B, T], for the plain rollout."""
    if not has_fault_lanes(exo_packed, Z):
        raise ValueError("stream carries no fault lanes")
    x = exo_packed[:T, lanes.exo_rows(Z):]
    return FaultStep(preempt_hazard=x[:, 0:Z].permute(2, 0, 1),
                     deny_frac=x[:, Z].permute(1, 0),
                     delay_frac=x[:, Z + 1].permute(1, 0),
                     signal_stale=x[:, Z + 2].permute(1, 0))


def sample_fault_steps(faults: FaultsConfig, generator: torch.Generator,
                       steps: int, Z: int) -> FaultStep:
    """One trace's time-major FaultStep (leaves [T, Z] / [T]): a batch-1
    synthesis of the same processes."""
    block = packed_fault_lanes(faults, generator, steps, steps, Z, 1)
    return FaultStep(preempt_hazard=block[:, 0:Z, 0],
                     deny_frac=block[:, Z, 0], delay_frac=block[:, Z + 1, 0],
                     signal_stale=block[:, Z + 2, 0])


def _generate_p(cfg: FaultsConfig, derived: dict, generator: torch.Generator,
                steps: int, t_pad: int, Z: int, batch: int, *, ctx: dict,
                out: torch.Tensor) -> torch.Tensor:
    """The "faults" family's traced-parameter generator
    (`sim/lanes.py::lane_param_generator`): :func:`packed_fault_lanes_p`
    coupled to the stream's spot noise (``cfg`` adds nothing: every
    searchable field arrives through ``derived``)."""
    return packed_fault_lanes_p(derived, generator, steps, t_pad, Z, batch,
                                price_dev=ctx.get("price_dev"), out=out)


lanes.provide_lane_param_generator("faults", _generate_p)
