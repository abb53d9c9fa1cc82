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
With every rate at 0 the lanes are exactly 0. For the scenario axis,
:func:`draw_workload_normals` and :func:`workload_lanes_p` make the
block of S cells of rates and spike amplitudes on shared draws.
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


def draw_workload_normals(generator: torch.Generator, steps: int,
                          batch: int) -> tuple:
    """The unit normals behind :func:`draw_workload_latents`, in its draw
    order (inference noise, flash window, batch noise, burst window,
    background noise), each an (initial [1, B], innovations [T, B])
    pair."""
    from ccka_tpu_torch.signals.synthetic import _ar1_normals

    return tuple(_ar1_normals(generator, (steps, batch)) for _ in range(5))


def workload_lanes_p(derived: dict, normals: tuple, steps: int, t_pad: int,
                     Z: int, *, dt_s: float, start_unix_s: float = 0.0,
                     start_offset_s=None,
                     wrap_period_s: float | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``[T_pad, workload_rows(Z), S, B]`` workload block of S cells
    on one set of draws (:func:`draw_workload_normals`): cell s's rates,
    window and spike amplitudes from the float32 [S] values of
    ``derived`` (`ScenarioParams.derived()["workloads"]`), each cell
    repeating :func:`workload_lanes_from_latents`' float32 operations in
    its order (bitwise the baked block of its config on the same draws).
    The clock shapes and the three noise latents do not depend on the
    cell and are computed once. Clock arguments as for
    :func:`packed_workload_lanes`."""
    from ccka_tpu_torch.faults.process import _block_out, _cells, _window_p
    from ccka_tpu_torch.signals.synthetic import _ar1_from_normals, _bump

    d = derived
    inf_n, flash_n, bat_n, burst_n, bg_n = normals
    dev, batch = inf_n[1].device, inf_n[1].shape[1]
    S = len(d["inf_rate"])
    out = _block_out(out, (t_pad, lanes.workload_rows(Z), S, batch), dev)

    def cells(name: str) -> torch.Tensor:
        return _cells(d[name], dev, 3)

    def window(pair, name: str) -> torch.Tensor:            # [T, S, B]
        return _window_p(_ar1_from_normals(*pair, d[name + "_rho64"]),
                         cells(name + "_thresh"))

    tod = _time_of_day(steps, batch, dt_s, start_unix_s, start_offset_s,
                       wrap_period_s, dev)
    shape = _bump(tod, center=14.0 / 24, width=5.0 / 24)     # [T, 1 or B]
    diurnal = (0.4 + 0.6 * shape)[:, None]
    noise = 1.0 + _ar1_from_normals(*inf_n, 0.9, 0.2)[:, None]
    out[:steps, 0] = torch.clamp(
        cells("inf_rate") * diurnal * noise
        * (1.0 + (cells("flash_mult") - 1.0) * window(flash_n, "flash")),
        min=0.0)
    anti = (1.5 - shape)[:, None]
    noise = 1.0 + _ar1_from_normals(*bat_n, 0.85, 0.3)[:, None]
    out[:steps, 1] = torch.clamp(
        cells("batch_rate") * anti * noise
        * (1.0 + (cells("burst_mult") - 1.0) * window(burst_n, "burst")),
        min=0.0)
    out[:steps, 2] = torch.clamp(
        cells("bg_rate") * (1.0 + _ar1_from_normals(*bg_n, 0.9, 0.2)[:, None]),
        min=0.0)
    out[:steps, 3:] = 0.0
    out[steps:] = 0.0
    return out


def packed_workload_lanes_p(derived: dict, generator: torch.Generator,
                            steps: int, t_pad: int, Z: int, batch: int, *,
                            dt_s: float, start_unix_s: float = 0.0,
                            start_offset_s=None,
                            wrap_period_s: float | None = None,
                            out: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """:func:`packed_workload_lanes` with the searchable rates and spike
    amplitudes per cell: the draws at the inner width ``batch`` from
    ``generator`` (the workload family's), then :func:`workload_lanes_p`'s
    ``[T_pad, workload_rows(Z), S, batch]`` block."""
    return workload_lanes_p(
        derived, draw_workload_normals(generator, steps, batch), steps,
        t_pad, Z, dt_s=dt_s, start_unix_s=start_unix_s,
        start_offset_s=start_offset_s, wrap_period_s=wrap_period_s, out=out)


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


def _generate_p(cfg: WorkloadsConfig, derived: dict,
                generator: torch.Generator, steps: int, t_pad: int, Z: int,
                batch: int, *, ctx: dict, out: torch.Tensor) -> torch.Tensor:
    """The "workloads" family's traced-parameter generator
    (`sim/lanes.py::lane_param_generator`): :func:`packed_workload_lanes_p`
    on the stream's clock (``cfg``'s kernel-side knobs stay in
    SimParams)."""
    return packed_workload_lanes_p(
        derived, generator, steps, t_pad, Z, batch, dt_s=ctx["dt_s"],
        start_unix_s=ctx.get("start_unix_s", 0.0),
        start_offset_s=ctx.get("start_offset_s"),
        wrap_period_s=ctx.get("wrap_period_s"), out=out)


lanes.provide_lane_param_generator("workloads", _generate_p)
