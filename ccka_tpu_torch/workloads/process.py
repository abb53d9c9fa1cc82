"""Workload-family arrival processes, synthesized as packed-stream lanes.

The PyTorch form of `ccka_tpu/workloads/process.py`: a
``[T_pad, workload_rows(Z), B]`` block appended after the fault block (if
any), rows from the block's first:

    0   inf_arrivals    inference work arriving this tick (pods)
    1   batch_arrivals  batch work arriving this tick
    2   bg_arrivals     best-effort background work
    padding to workload_rows(Z) = fault_rows(Z) + 8 (zeros)

Inference follows a diurnal shape (peak at 14:00) with flash-crowd
windows; batch backfill is anti-diurnal with burst waves; background is a
noisy floor. Windows reuse the fault family's thresholded AR(1). As for
faults, :func:`draw_workload_latents` draws and
:func:`workload_lanes_from_latents` is a pure function of the latents.
With every rate at 0 the lanes are exactly 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ccka_tpu_torch.config import WorkloadsConfig
from ccka_tpu_torch.faults.process import _f32, _window, _window_rho
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.workloads.types import WorkloadStep

_DAY_S = 86400.0


def draw_workload_latents(wl: WorkloadsConfig, generator: torch.Generator,
                          steps: int, batch: int) -> tuple:
    """The five [T, B] AR(1) latents, in draw order: inference noise
    (rho 0.9, sigma 0.2), flash-crowd window, batch noise (0.85, 0.3),
    burst window, background noise (0.9, 0.2)."""
    from ccka_tpu_torch.signals.synthetic import _ar1_scan

    shape = (steps, batch)
    return (
        _ar1_scan(generator, shape, 0.9, 0.2),
        _ar1_scan(generator, shape,
                  _window_rho(wl.inference_flash_mean_ticks), 1.0),
        _ar1_scan(generator, shape, 0.85, 0.3),
        _ar1_scan(generator, shape, _window_rho(wl.batch_burst_mean_ticks),
                  1.0),
        _ar1_scan(generator, shape, 0.9, 0.2),
    )


def _time_of_day(steps: int, batch: int, dt_s: float, start_unix_s: float,
                 start_offset_s, wrap_period_s, device) -> torch.Tensor:
    """Day fraction of every tick: [T, 1] on one shared clock, or [T, B]
    with per-trace ``start_offset_s`` [B] (wrapped at ``wrap_period_s``).
    The day is reduced in float64 before the float32 cast: at epoch scale
    float32's step is 128 s."""
    if start_offset_s is None:
        t = start_unix_s + np.arange(steps) * dt_s
        return torch.as_tensor(((t % _DAY_S) / _DAY_S).astype(np.float32),
                               device=device)[:, None]
    t_rel = (torch.as_tensor((np.arange(steps) * dt_s).astype(np.float32),
                             device=device)[:, None]
             + torch.as_tensor(start_offset_s, dtype=torch.float32,
                               device=device)[None, :])
    if wrap_period_s is not None:
        t_rel = torch.remainder(t_rel, _f32(wrap_period_s))
    tt = _f32(start_unix_s % _DAY_S) + torch.remainder(t_rel, _DAY_S)
    return torch.remainder(tt, _DAY_S) / _DAY_S


def workload_lanes_from_latents(wl: WorkloadsConfig, latents: tuple,
                                steps: int, t_pad: int, Z: int, *,
                                dt_s: float, start_unix_s: float = 0.0,
                                start_offset_s=None,
                                wrap_period_s: float | None = None
                                ) -> torch.Tensor:
    """Latents (:func:`draw_workload_latents`) -> the
    ``[T_pad, workload_rows(Z), B]`` lane block. ``dt_s`` and
    ``start_unix_s`` anchor the diurnal shapes to the exo stream's clock;
    ``start_offset_s`` [B] shifts each trace's clock (a replayed window),
    ``wrap_period_s`` wraps it with the replayed store."""
    from ccka_tpu_torch.signals.synthetic import _bump

    noise_i, flash_l, noise_b, burst_l, noise_g = latents
    dev = noise_i.device
    batch = noise_i.shape[1]
    tod = _time_of_day(steps, batch, dt_s, start_unix_s, start_offset_s,
                       wrap_period_s, dev)
    shape = _bump(tod, center=14.0 / 24, width=5.0 / 24)
    diurnal = 0.4 + 0.6 * shape
    flash = _window(flash_l, wl.inference_flash_frac)
    inf = (_f32(wl.inference_rate_pods) * diurnal * (1.0 + noise_i)
           * (1.0 + (_f32(wl.inference_flash_mult) - 1.0) * flash))
    anti = 1.5 - shape
    burst = _window(burst_l, wl.batch_burst_frac)
    bat = (_f32(wl.batch_rate_pods) * anti * (1.0 + noise_b)
           * (1.0 + (_f32(wl.batch_burst_mult) - 1.0) * burst))
    bg = _f32(wl.background_rate_pods) * (1.0 + noise_g)

    block = torch.zeros((t_pad, lanes.workload_rows(Z), batch),
                        dtype=torch.float32, device=dev)
    block[:steps, 0] = torch.clamp(inf, min=0.0)
    block[:steps, 1] = torch.clamp(bat, min=0.0)
    block[:steps, 2] = torch.clamp(bg, min=0.0)
    return block


def packed_workload_lanes(wl: WorkloadsConfig, generator: torch.Generator,
                          steps: int, t_pad: int, Z: int, batch: int, *,
                          dt_s: float, start_unix_s: float = 0.0,
                          start_offset_s=None,
                          wrap_period_s: float | None = None
                          ) -> torch.Tensor:
    """``[T_pad, workload_rows(Z), B]`` lane block drawn from
    ``generator`` (the workload family's own) on its device."""
    return workload_lanes_from_latents(
        wl, draw_workload_latents(wl, generator, steps, batch), steps,
        t_pad, Z, dt_s=dt_s, start_unix_s=start_unix_s,
        start_offset_s=start_offset_s, wrap_period_s=wrap_period_s)


def has_workload_lanes(exo_packed: torch.Tensor, Z: int) -> bool:
    """Whether a packed stream carries the workload block (from its row
    count; an unknown count raises)."""
    return lanes.stream_layout(int(exo_packed.shape[1]), Z)[1]


def unpack_workload_lanes(exo_packed: torch.Tensor, T: int,
                          Z: int) -> WorkloadStep:
    """The workload block of a widened stream as a `WorkloadStep` of
    [B, T] views, for the plain rollout."""
    wb = lanes.workload_base(int(exo_packed.shape[1]), Z)
    x = exo_packed[:T, wb:wb + 3]
    return WorkloadStep(inf_arrivals=x[:, 0].permute(1, 0),
                        batch_arrivals=x[:, 1].permute(1, 0),
                        bg_arrivals=x[:, 2].permute(1, 0))


def sample_workload_steps(wl: WorkloadsConfig, generator: torch.Generator,
                          steps: int, Z: int, *, dt_s: float = 30.0,
                          start_unix_s: float = 0.0) -> WorkloadStep:
    """One trace's time-major WorkloadStep (leaves [T]): a batch-1
    synthesis of the same processes."""
    block = packed_workload_lanes(wl, generator, steps, steps, Z, 1,
                                  dt_s=dt_s, start_unix_s=start_unix_s)
    return WorkloadStep(inf_arrivals=block[:, 0, 0],
                        batch_arrivals=block[:, 1, 0],
                        bg_arrivals=block[:, 2, 0])
