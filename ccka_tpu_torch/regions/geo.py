"""Batched expectation dynamics for inter-region workload migration.

The PyTorch form of `ccka_tpu/regions/geo.py`. A tick loop over the
per-region lane signals (`regions/process.py`), one queue per (region,
migratable family), the migration action applied each tick:

    tick t:  arrive  lane arrivals and the transit landing now join the
                     queue, before the move, so migration can arbitrage
                     fresh work;
             move    ``moved[s, d, f] = q[s, f] * rates[s, d, f]``
                     (sanitized rates: at most the existing mass leaves);
             transit moved mass rides a ring of ``transfer_latency_ticks``
                     slots and lands that many ticks later;
             serve   regional capacity drains the queues in strict
                     priority inference > batch > background;
             price   served pods pay the regional spot price and emit at
                     the regional intensity; moved pods pay
                     ``transfer_cost_usd_per_pod`` (the "migration" term).

Nothing is dropped: initial mass + arrivals == served + queued +
in-transit at every tick, which :func:`conservation_residual` checks in
float64. The queues are float32 and round as the JAX package's do, so
the policies see the same queues and open the same lanes; a float64
shadow of the queues takes the same float32 terms, and the shadow less
the queues is the mass the rounding has taken, reported per tick as
``rounding_pods``. Without that ledger the float32 rounding (the JAX
package's) drifts past the 0.01-pod conservation gate over a day (2880
ticks) where a policy moves thousands of pods a tick back and forth:
:func:`conservation_residual` gives both readings. With two regions the
transit sums are exact (one nonzero term each).
The state is batch-major (``q`` ``[B, R, F]``, the ring ``[L, B, R,
F]``), each tick's series is written into preallocated ``[T, B, ...]``
tensors on the lanes' device, and no tick reads the host, so the loop
only enqueues work on the card. The residual and the summary's float64
sums are taken on that device too, a time chunk at a time, without
copying the series to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ccka_tpu_torch.config import GeoConfig
from ccka_tpu_torch.regions.migrate import (GeoPolicy, N_FAMILIES,
                                            RegionSignals, family_total,
                                            sanitize_rates)
from ccka_tpu_torch.regions.process import RegionStep

# Economic base rates of the overlay: a self-consistent market every
# policy is scored in (the fronts need equal prices, not a cloud bill).
_POD_USD_PER_TICK = 0.02        # base spot $ per served pod-tick
_POD_KWH_PER_TICK = 0.004       # energy per served pod-tick
_BASE_CARBON_G_KWH = 400.0      # grid intensity before the deviation

# Ticks a float64 reduction converts at once (bounds its temporary).
_SUM_CHUNK = 256


class GeoRollout(NamedTuple):
    """Per-tick series of one geo rollout; leaves ``[T, B, ...]``."""

    cost_usd: torch.Tensor            # [T, B] serve cost at regional prices
    carbon_g: torch.Tensor            # [T, B] emissions, regional intensity
    migration_cost_usd: torch.Tensor  # [T, B] transfer dollars
    moved_pods: torch.Tensor          # [T, B] mass put in transit
    served: torch.Tensor              # [T, B, R, F]
    pending: torch.Tensor             # [T, B, R, F] post-serve queues
    in_transit: torch.Tensor          # [T, B] total mass in flight
    deadline_miss_pods: torch.Tensor  # [T, B] batch backlog past deadline
    migration_rate_mean: torch.Tensor  # [T, B] mean applied off-diag rate
    # [T, B] the mass float32 rounding has taken from the queues so far
    # (a float64 shadow of the queues less the queues): the work queued
    # is pending + rounding_pods. The JAX package has no such series; its
    # fields come first.
    rounding_pods: torch.Tensor


def _batch_major(step: RegionStep) -> RegionStep:
    """RegionStep leaves as float32 ``[T, B, R]``: from one trace's
    ``[T, R]`` or a packed stream's ``[T, R, B]``."""
    def fix(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.ndim == 2:
            return x[:, None, :]
        return x.permute(0, 2, 1)
    return RegionStep(*(fix(x) for x in step))


def geo_rollout(geo: GeoConfig, policy: GeoPolicy | None, step: RegionStep,
                *, rates_override=None) -> GeoRollout:
    """The migration dynamics of one policy over lane signals, on the
    lanes' device.

    ``rates_override``: a fixed ``[R, R, F]`` tensor applied every tick
    in place of the policy (the actuation parse-back path: the chaos test
    feeds the rates that survived the command stream). It is sanitized
    here, so no caller can pass a mass-creating action."""
    s = _batch_major(step)
    T, B, R = s.price_dev.shape
    dev = s.price_dev.device
    L = max(int(geo.transfer_latency_ticks), 1)
    F = N_FAMILIES
    xfer_usd = float(np.float32(geo.transfer_cost_usd_per_pod))
    deadline = float(np.float32(geo.batch_deadline_ticks))
    off_diag = float(np.float32(max(R * (R - 1) * F, 1)))
    arrivals = torch.stack([s.inf_arrivals, s.batch_arrivals,
                            s.bg_arrivals], dim=-1)       # [T, B, R, F]
    rates = None
    if rates_override is not None:
        rates = sanitize_rates(torch.as_tensor(
            rates_override, dtype=torch.float32, device=dev)
        ).expand(B, R, R, F)

    def series(*tail):
        return torch.empty((T, B) + tail, dtype=torch.float32, device=dev)

    out = GeoRollout(series(), series(), series(), series(), series(R, F),
                     series(R, F), series(), series(), series(), series())
    q = torch.zeros((B, R, F), dtype=torch.float32, device=dev)
    ring = torch.zeros((L, B, R, F), dtype=torch.float32, device=dev)
    q64 = torch.zeros((B, R, F), dtype=torch.float64, device=dev)

    for t in range(T):
        price, carbon, cap = s.price_dev[t], s.carbon_dev[t], s.capacity[t]
        slot = ring[t % L]                 # lands now; refilled below
        q64.add_(arrivals[t]).add_(slot)
        q = q + arrivals[t] + slot
        if rates_override is None:
            rates = policy.rates(RegionSignals(price, carbon, cap, q))
        moved = q[:, :, None, :] * rates              # [B, src, dst, F]
        leaving = moved.sum(dim=2)
        q64.sub_(leaving)
        q = q - leaving
        slot.copy_(moved.sum(dim=1))
        # Strict-priority serve: inference > batch > background.
        rem = torch.clamp(cap, min=0.0)
        served = out.served[t]
        for f in range(F):
            torch.minimum(q[..., f], rem, out=served[..., f])
            rem = rem - served[..., f]
        q64.sub_(served)
        q = q - served
        out.pending[t].copy_(q)
        out.rounding_pods[t].copy_((q64 - q).sum(dim=(1, 2)))
        served_tot = family_total(served)             # [B, R]
        spot = _POD_USD_PER_TICK * torch.clamp(1.0 + price, min=0.1)
        intensity = torch.clamp(_BASE_CARBON_G_KWH + carbon, min=0.0)
        torch.sum(served_tot * spot, dim=-1, out=out.cost_usd[t])
        torch.sum(served_tot * _POD_KWH_PER_TICK * intensity, dim=-1,
                  out=out.carbon_g[t])
        moved_tot = moved.sum(dim=(1, 2, 3))
        out.moved_pods[t].copy_(moved_tot)
        torch.mul(moved_tot, xfer_usd, out=out.migration_cost_usd[t])
        out.in_transit[t].copy_(ring.sum(dim=(0, 2, 3),
                                         dtype=torch.float64))
        torch.sum(torch.clamp(q[..., 1] - torch.clamp(cap, min=0.0)
                              * deadline, min=0.0), dim=-1,
                  out=out.deadline_miss_pods[t])
        torch.div(rates.sum(dim=(1, 2, 3)), off_diag,
                  out=out.migration_rate_mean[t])
    return out


def _sum64(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``x`` summed over axis 0 and ``dims`` (of the remaining axes,
    counted from 1 as in ``x``) in float64, a chunk of ticks at a time,
    on ``x``'s device."""
    rest = tuple(d - 1 for d in dims)
    total = None
    for t0 in range(0, x.shape[0], _SUM_CHUNK):
        part = x[t0:t0 + _SUM_CHUNK].double().sum(dim=0)
        if rest:
            part = part.sum(dim=rest)
        total = part if total is None else total + part
    return total


def conservation_residual(step: RegionStep, out: GeoRollout, *,
                          ledger: bool = True) -> float:
    """Work-conservation residual of a rollout in pods, summed in
    float64: |arrivals - served - pending - in-transit - rounding| after
    the last tick, the largest over the batch. With the queues' rounding
    accounted (``ledger``), exactly conserved dynamics leave only the
    float32 rounding of the reported series. ``ledger=False`` leaves the
    rounding term out: the JAX package's residual, which reads the
    queues' float32 drift too."""
    s = _batch_major(step)
    arrived = (_sum64(s.inf_arrivals, (2,)) + _sum64(s.batch_arrivals, (2,))
               + _sum64(s.bg_arrivals, (2,)))                    # [B]
    served = _sum64(out.served, (2, 3))
    pending = out.pending[-1].double().sum(dim=(1, 2))
    transit = out.in_transit[-1].double()
    rest = arrived - served - pending - transit
    if ledger:
        rest = rest - out.rounding_pods[-1].double()
    return float(rest.abs().max())


def rollout_summary(geo: GeoConfig, out: GeoRollout) -> dict:
    """Scalar surfaces of one rollout: batch means of the per-tick
    totals (float64), the Pareto axes and the per-class SLO rows."""
    del geo
    T = out.cost_usd.shape[0]

    def mean_b(x):
        return float(_sum64(x, ()).mean())

    def pend(f):
        return float(_sum64(out.pending[..., f], (2,)).mean())

    cost, mig = mean_b(out.cost_usd), mean_b(out.migration_cost_usd)
    miss = mean_b(out.deadline_miss_pods)
    return {
        "horizon_ticks": int(T),
        "cost_usd": cost,
        "migration_cost_usd": mig,
        "total_cost_usd": cost + mig,
        "carbon_kg": mean_b(out.carbon_g) / 1e3,
        "moved_pods": mean_b(out.moved_pods),
        "deadline_miss_pod_ticks": miss,
        "migration_rate_mean": float(
            _sum64(out.migration_rate_mean, (1,)) / out.cost_usd.numel()),
        "per_class": {
            "inference": {"pending_pod_ticks": pend(0)},
            "batch": {"pending_pod_ticks": pend(1),
                      "deadline_miss_pod_ticks": miss},
            "background": {"pending_pod_ticks": pend(2)},
        },
    }


# -- the service's gauges read this snapshot --------------------------------

_GEO_SNAPSHOT: dict | None = None


def publish_geo_snapshot(geo: GeoConfig, step: RegionStep,
                         out: GeoRollout) -> dict:
    """Publish the latest rollout's gauge surfaces for the service
    (`harness/service.py::_geo_surfaces`) and the exporter
    (`ccka_region_migration_rate`, `ccka_region_carbon_intensity`): per-
    region carbon intensity in g/kWh (the lane mean over the horizon) and
    the mean applied migration rate. The tick path never threads geo
    state; it reads the snapshot."""
    global _GEO_SNAPSHOT
    del geo
    s = _batch_major(step)
    n = s.carbon_dev.shape[0] * s.carbon_dev.shape[1]
    carbon = (_sum64(s.carbon_dev, (1,)) / n).cpu().numpy()        # [R]
    moved = float(_sum64(out.moved_pods, (1,)) / out.moved_pods.numel())
    rate = float(_sum64(out.migration_rate_mean, (1,))
                 / out.migration_rate_mean.numel())
    snap = {
        "migration_rate": {"mean": rate},
        "carbon_intensity": {
            f"r{r}": float(_BASE_CARBON_G_KWH + carbon[r])
            for r in range(carbon.shape[0])},
        "moved_pods_per_tick": moved,
    }
    _GEO_SNAPSHOT = snap
    return snap


def geo_snapshot() -> dict | None:
    """The latest published geo gauge snapshot (None before any)."""
    return _GEO_SNAPSHOT
