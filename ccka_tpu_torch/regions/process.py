"""Per-region geo processes, synthesized as a lane block of the packed stream.

The PyTorch form of `ccka_tpu/regions/process.py`: a
``[T_pad, region_rows(Z), B]`` block appended after the fault and
workload blocks (when present), drawn from the region family's own
generator (`signals/synthetic.py::family_generator` under
:data:`REGION_KEY_TAG`), so widening a stream changes none of its other
rows. Region values broadcast to each of the region's zones
(``GeoConfig.zone_region_index``); consumers read one representative
zone per region (:func:`region_slots`). Rows, from the block's first:

    0..Z-1     price_dev[z]       relative spot-price deviation
                                  (storm surge + AR(1); 0 = neutral)
    Z..2Z-1    carbon_dev[z]      carbon-intensity deviation, g/kWh
    2Z..3Z-1   capacity[z]        migratable capacity, pods/tick
                                  (collapses in denial windows)
    3Z..4Z-1   inf_arrivals[z]    migratable inference work
    4Z..5Z-1   batch_arrivals[z]  migratable batch work
    5Z..6Z-1   bg_arrivals[z]     migratable background work
    padding to ``region_rows(Z) = 4 * fault_rows(Z) + 32`` (zeros)

Storm and denial windows are the fault family's thresholded stationary
AR(1) latents (`faults/process.py::_window`); the diurnal shapes are the
signal generator's `_bump` on the workload family's clock
(`workloads/process.py::_time_of_day`). The seven latents are drawn in a
fixed order whatever the config, so every config of one seed shares its
draws. The neutral contract: with every rate and sigma at 0 the lanes
are exactly 0. For the scenario axis, :func:`draw_region_normals` and
:func:`region_lanes_p` make the block of S cells whose spot storms
differ (the other blocks keep their config gates) on shared draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccka_tpu_torch.config import GeoConfig
from ccka_tpu_torch.faults.process import _f32, _window, _window_rho
from ccka_tpu_torch.signals.synthetic import _ar1_scan, _bump
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.workloads.process import _time_of_day

REGION_KEY_TAG = lanes.REGION_KEY_TAG
region_rows = lanes.region_rows

# Sub-block order inside the region lane block (each Z rows wide).
REGION_LANE_FIELDS = ("price_dev", "carbon_dev", "capacity",
                      "inf_arrivals", "batch_arrivals", "bg_arrivals")


class RegionStep(NamedTuple):
    """Per-region geo lane values, time-major ``[T, R, B]`` leaves (or
    ``[T, R]`` for one trace): one representative zone per region."""

    price_dev: torch.Tensor
    carbon_dev: torch.Tensor
    capacity: torch.Tensor
    inf_arrivals: torch.Tensor
    batch_arrivals: torch.Tensor
    bg_arrivals: torch.Tensor


def _zone_region_index(geo: GeoConfig, Z: int) -> tuple[int, ...]:
    """The zone -> region map used at zone count ``Z``: the config's when
    it covers ``Z`` zones, else every zone in region 0 (a widened source
    on another topology reads as one region rather than mis-indexing)."""
    zri = geo.zone_region_index
    if len(zri) == Z:
        return tuple(zri)
    return (0,) * Z


def region_slots(geo: GeoConfig, Z: int) -> tuple[int, ...]:
    """First zone index of each region: the zone consumers read each
    region's broadcast value from."""
    slots: list[int] = []
    for z, r in enumerate(_zone_region_index(geo, Z)):
        if r == len(slots):
            slots.append(z)
    return tuple(slots)


def packed_region_lanes(geo: GeoConfig, generator: torch.Generator,
                        steps: int, t_pad: int, Z: int, batch: int, *,
                        dt_s: float, start_unix_s: float = 0.0,
                        start_offset_s=None,
                        wrap_period_s: float | None = None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """``[t_pad, region_rows(Z), B]`` lane block drawn from ``generator``
    (the region family's own) on its device. The clock arguments are the
    workload lanes' (`workloads/process.py::packed_workload_lanes`), so
    the diurnal shapes stay in phase with the exo demand on unblocked,
    blocked and replayed clocks. ``out`` (a ``[t_pad, region_rows(Z), B]``
    float32 view, e.g. the region rows of a whole stream) is written in
    place of a new tensor, every element of it.

    Each latent is drawn and folded in before the next, so a full day at
    B = 32768 holds at most two ``[T, R, B]`` latents beside the block."""
    dev = generator.device
    zri = _zone_region_index(geo, Z)
    R = max(zri) + 1
    shape = (steps, R, batch)
    rows = region_rows(Z)
    if out is None:
        out = torch.empty((t_pad, rows, batch), dtype=torch.float32,
                          device=dev)
    elif tuple(out.shape) != (t_pad, rows, batch) or \
            out.dtype != torch.float32:
        raise ValueError(f"out must be float32 {[t_pad, rows, batch]}, got "
                         f"{out.dtype} {list(out.shape)}")
    zri_ix = torch.tensor(zri, dtype=torch.long, device=dev)

    def put(i: int, x: torch.Tensor | None) -> None:
        """Field ``i`` ([T, R, B], None for exact zeros) broadcast to its
        Z rows."""
        if x is None:
            out[:steps, i * Z:(i + 1) * Z] = 0.0
        else:
            out[:steps, i * Z:(i + 1) * Z] = x.index_select(1, zri_ix)

    tod = _time_of_day(steps, batch, dt_s, start_unix_s, start_offset_s,
                       wrap_period_s, dev)[:, None, :]    # [T, 1, 1 or B]

    # Spot-price deviation: AR(1) noise plus storm windows; the same
    # windows optionally dirty the regional grid (peaker dispatch).
    lat = _ar1_scan(generator, shape, 0.97, 1.0)
    price = None
    if geo.price_dev_sigma > 0.0:
        price = _f32(geo.price_dev_sigma) * lat
    lat = _ar1_scan(generator, shape,
                    _window_rho(geo.price_storm_mean_ticks), 1.0)
    storm = None
    if geo.price_storm_frac > 0.0:
        storm = _window(lat, geo.price_storm_frac)
        surge = (_f32(geo.price_storm_mult) - 1.0) * storm
        price = surge if price is None else price + surge
    put(0, price)
    del price

    lat = _ar1_scan(generator, shape, 0.95, 1.0)
    carbon = None
    if geo.carbon_dev_sigma_g_kwh > 0.0:
        carbon = _f32(geo.carbon_dev_sigma_g_kwh) * lat
    if storm is not None and geo.price_storm_carbon_g_kwh > 0.0:
        dirty = _f32(geo.price_storm_carbon_g_kwh) * storm
        carbon = dirty if carbon is None else carbon + dirty
    put(1, carbon)
    del carbon, storm

    # Migratable capacity, collapsing by deny_frac in denial windows.
    lat = _ar1_scan(generator, shape,
                    _window_rho(geo.capacity_deny_mean_ticks), 1.0)
    cap = None
    if geo.capacity_pods > 0.0:
        cap = torch.full(shape, _f32(geo.capacity_pods), device=dev)
        if geo.capacity_deny_window_frac > 0.0:
            deny = _window(lat, geo.capacity_deny_window_frac)
            cap = cap * (1.0 - _f32(geo.capacity_deny_frac) * deny)
        cap = torch.clamp(cap, min=0.0)
    put(2, cap)
    del cap

    # Migratable family arrivals: diurnal inference, anti-diurnal batch,
    # flat background (the workload families' shapes).
    bump = _bump(tod, center=14.0 / 24, width=5.0 / 24)
    for i, (rate, rho, sigma, level) in enumerate((
            (geo.migratable_inference_pods, 0.9, 0.2, 0.4 + 0.6 * bump),
            (geo.migratable_batch_pods, 0.85, 0.3, 1.5 - bump),
            (geo.migratable_background_pods, 0.9, 0.2, None))):
        noise = _ar1_scan(generator, shape, rho, sigma)
        x = None
        if rate > 0.0:
            x = _f32(rate) * (1.0 + noise) if level is None \
                else _f32(rate) * level * (1.0 + noise)
            x = torch.clamp(x, min=0.0)
        put(3 + i, x)
    out[:steps, 6 * Z:] = 0.0
    out[steps:] = 0.0
    return out


def draw_region_normals(geo: GeoConfig, generator: torch.Generator,
                        steps: int, Z: int, batch: int) -> tuple:
    """The unit normals behind :func:`packed_region_lanes`' seven latents,
    in its draw order (price, storm window, carbon, capacity denial,
    inference, batch and background noise), each an (initial
    [1, R, B], innovations [T, R, B]) pair."""
    from ccka_tpu_torch.signals.synthetic import _ar1_normals

    R = max(_zone_region_index(geo, Z)) + 1
    return tuple(_ar1_normals(generator, (steps, R, batch))
                 for _ in range(7))


def region_lanes_p(geo: GeoConfig, derived: dict, normals: tuple,
                   steps: int, t_pad: int, Z: int, *, dt_s: float,
                   start_unix_s: float = 0.0, start_offset_s=None,
                   wrap_period_s: float | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``[T_pad, region_rows(Z), S, B]`` region block of S cells on
    one set of draws (:func:`draw_region_normals`). Only the spot-storm
    block varies by cell (window, surge multiplier and storm carbon from
    the float32 [S] values of ``derived``, `ScenarioParams.derived()
    ["regions"]`): each cell adds ``(mult - 1) * storm`` to the price
    deviation and ``carbon * storm`` to the carbon deviation, exact
    no-ops where the window never opens, so a cell is bitwise the baked
    block of its config. The sigma, capacity and migration blocks keep
    :func:`packed_region_lanes`' host gates on ``geo`` and are computed
    once. Clock arguments as for :func:`packed_region_lanes`."""
    from ccka_tpu_torch.faults.process import _block_out, _cells, _window_p
    from ccka_tpu_torch.signals.synthetic import _ar1_from_normals

    d = derived
    dev = normals[0][1].device
    batch = normals[0][1].shape[2]
    S = len(d["storm_thresh"])
    zri_ix = torch.tensor(_zone_region_index(geo, Z), dtype=torch.long,
                          device=dev)
    out = _block_out(out, (t_pad, region_rows(Z), S, batch), dev)

    def put(i: int, x: torch.Tensor | None) -> None:
        """Field ``i`` broadcast to its Z rows: None for exact zeros,
        [T, R, B] shared by every cell, or [T, S, R, B] by cell."""
        dst = out[:steps, i * Z:(i + 1) * Z]                # [T, Z, S, B]
        if x is None:
            dst.fill_(0.0)
        elif x.dim() == 3:
            dst.copy_(x.index_select(1, zri_ix)[:, :, None].expand_as(dst))
        else:
            dst.copy_(x.permute(0, 2, 1, 3).index_select(1, zri_ix))

    def latent(i: int, rho, sigma: float = 1.0) -> torch.Tensor:
        return _ar1_from_normals(*normals[i], rho, sigma)

    # The storm window by cell: [T, S, R, B].
    storm = _window_p(latent(1, d["storm_rho64"]),
                      _cells(d["storm_thresh"], dev, 4))
    price = None
    if geo.price_dev_sigma > 0.0:
        price = (_f32(geo.price_dev_sigma) * latent(0, 0.97))[:, None]
    surge = (_cells(d["storm_mult"], dev, 4) - 1.0) * storm
    put(0, surge if price is None else price + surge)
    del price, surge
    carbon = None
    if geo.carbon_dev_sigma_g_kwh > 0.0:
        carbon = (_f32(geo.carbon_dev_sigma_g_kwh) * latent(2, 0.95))[:, None]
    dirty = _cells(d["storm_carbon"], dev, 4) * storm
    put(1, dirty if carbon is None else carbon + dirty)
    del carbon, dirty, storm

    cap = None
    if geo.capacity_pods > 0.0:
        shape = tuple(normals[3][1].shape)
        cap = torch.full(shape, _f32(geo.capacity_pods), device=dev)
        if geo.capacity_deny_window_frac > 0.0:
            deny = _window(latent(3, _window_rho(
                geo.capacity_deny_mean_ticks)), geo.capacity_deny_window_frac)
            cap = cap * (1.0 - _f32(geo.capacity_deny_frac) * deny)
        cap = torch.clamp(cap, min=0.0)
    put(2, cap)
    del cap

    tod = _time_of_day(steps, batch, dt_s, start_unix_s, start_offset_s,
                       wrap_period_s, dev)[:, None, :]    # [T, 1, 1 or B]
    bump = _bump(tod, center=14.0 / 24, width=5.0 / 24)
    for i, (rate, rho, sigma, level) in enumerate((
            (geo.migratable_inference_pods, 0.9, 0.2, 0.4 + 0.6 * bump),
            (geo.migratable_batch_pods, 0.85, 0.3, 1.5 - bump),
            (geo.migratable_background_pods, 0.9, 0.2, None))):
        x = None
        if rate > 0.0:
            noise = latent(4 + i, rho, sigma)
            x = _f32(rate) * (1.0 + noise) if level is None \
                else _f32(rate) * level * (1.0 + noise)
            x = torch.clamp(x, min=0.0)
        put(3 + i, x)
    out[:steps, 6 * Z:] = 0.0
    out[steps:] = 0.0
    return out


def packed_region_lanes_p(geo: GeoConfig, derived: dict,
                          generator: torch.Generator, steps: int,
                          t_pad: int, Z: int, batch: int, *, dt_s: float,
                          start_unix_s: float = 0.0, start_offset_s=None,
                          wrap_period_s: float | None = None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`packed_region_lanes` with the spot-storm block per cell: the
    seven latents' draws at the inner width ``batch`` from ``generator``
    (the region family's), then :func:`region_lanes_p`'s
    ``[T_pad, region_rows(Z), S, batch]`` block."""
    return region_lanes_p(
        geo, derived, draw_region_normals(geo, generator, steps, Z, batch),
        steps, t_pad, Z, dt_s=dt_s, start_unix_s=start_unix_s,
        start_offset_s=start_offset_s, wrap_period_s=wrap_period_s, out=out)


def has_region_lanes(exo_packed: torch.Tensor, Z: int) -> bool:
    """Whether a packed stream carries the region block (from its row
    count; an unknown count raises)."""
    return lanes.resolve_layout(int(exo_packed.shape[1]), Z).has("regions")


def region_step_from_block(block: torch.Tensor, T: int, Z: int,
                           geo: GeoConfig) -> RegionStep:
    """A bare ``[T_pad, >= 6Z, B]`` region block -> :class:`RegionStep`
    (leaves ``[T, R, B]`` views), reading each region's representative
    zone."""
    slots = list(region_slots(geo, Z))
    return RegionStep(*(block[:T, i * Z:(i + 1) * Z][:, slots]
                        for i in range(len(REGION_LANE_FIELDS))))


def unpack_region_lanes(exo_packed: torch.Tensor, T: int, Z: int,
                        geo: GeoConfig) -> RegionStep:
    """The region lanes of a widened stream (exo block + family blocks)
    as a :class:`RegionStep`: what the geo overlay reads."""
    lo, _hi = lanes.resolve_layout(int(exo_packed.shape[1]),
                                   Z).block("regions")
    return region_step_from_block(exo_packed[:, lo:lo + 6 * Z], T, Z, geo)


def sample_region_steps(geo: GeoConfig, generator: torch.Generator,
                        steps: int, Z: int, *, dt_s: float = 30.0,
                        start_unix_s: float = 0.0) -> RegionStep:
    """One trace's :class:`RegionStep` (leaves ``[T, R]``) for standalone
    rollouts: the same processes as the packed lanes, a batch of one."""
    block = packed_region_lanes(geo, generator, steps, steps, Z, 1,
                                dt_s=dt_s, start_unix_s=start_unix_s)
    return RegionStep(*(x[..., 0]
                        for x in region_step_from_block(block, steps, Z,
                                                        geo)))


def _generate(cfg: GeoConfig, generator: torch.Generator, steps: int,
              t_pad: int, Z: int, batch: int, *, ctx: dict,
              out: torch.Tensor) -> torch.Tensor:
    """The "regions" family's generator (`sim/lanes.py::lane_generator`):
    :func:`packed_region_lanes` on the stream's clock."""
    return packed_region_lanes(
        cfg, generator, steps, t_pad, Z, batch, dt_s=ctx["dt_s"],
        start_unix_s=ctx.get("start_unix_s", 0.0),
        start_offset_s=ctx.get("start_offset_s"),
        wrap_period_s=ctx.get("wrap_period_s"), out=out)


lanes.provide_lane_generator("regions", _generate)


def _generate_p(cfg: GeoConfig, derived: dict, generator: torch.Generator,
                steps: int, t_pad: int, Z: int, batch: int, *, ctx: dict,
                out: torch.Tensor) -> torch.Tensor:
    """The "regions" family's traced-parameter generator
    (`sim/lanes.py::lane_param_generator`): :func:`packed_region_lanes_p`
    on the stream's clock."""
    return packed_region_lanes_p(
        cfg, derived, generator, steps, t_pad, Z, batch, dt_s=ctx["dt_s"],
        start_unix_s=ctx.get("start_unix_s", 0.0),
        start_offset_s=ctx.get("start_offset_s"),
        wrap_period_s=ctx.get("wrap_period_s"), out=out)


lanes.provide_lane_param_generator("regions", _generate_p)
