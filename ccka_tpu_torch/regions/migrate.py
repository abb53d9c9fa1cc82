"""Inter-region migration action space, its sanitizer and its command wire.

The PyTorch form of `ccka_tpu/regions/migrate.py`. The action is a rate
tensor ``rates[..., R, R, F]``: the share of region ``src``'s pending mass
in migratable family ``f`` that moves to region ``dst`` this tick. Every
policy's raw output passes through :func:`sanitize_rates`, which makes it
safe for the expectation dynamics (`regions/geo.py`):

  * rates lie in [0, 1] and the diagonal is zero (no self-migration);
  * a source's outflow summed over destinations never exceeds 1, so a
    tick moves at most the mass that exists: work is conserved by
    construction, and a mis-tuned policy degrades to smaller moves.

Moved mass pays ``transfer_cost_usd_per_pod`` (the objective's
"migration" term) and lands ``transfer_latency_ticks`` later.

The actuation half renders rates as `actuation/sink.py::PatchCommand`s
(:func:`render_migration_commands`) and parses what landed back into
rates (:func:`apply_migration_commands`), so a `ChaosSink` can drop or
rewrite single commands and conservation is held on the rates that
survived the wire.

Nothing differentiates through geo, so the clamps here are
`torch.clamp` / `torch.maximum`; a differentiated use would go through
`sim/dynamics.py::clip`. The policies make no host-to-device copy (a
copy from pageable memory waits for the device): their constants are
Python scalars, and the family mobility tensor is made once per device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ccka_tpu_torch.actuation.sink import PatchCommand

# Migratable workload families, in lane order (`regions/process` rows
# 3Z:6Z): the mobile counterparts of the per-class demand.
MIGRATABLE_FAMILIES = ("inference", "batch", "background")
N_FAMILIES = len(MIGRATABLE_FAMILIES)

# Per-family mobility of the built-in policies: inference is latency-
# sensitive (migrates reluctantly), batch and background are the
# arbitrage payload.
_FAMILY_MOBILITY = (0.25, 1.0, 0.75)
_MOBILITY: dict = {}


def _mobility(device) -> torch.Tensor:
    """:data:`_FAMILY_MOBILITY` as a float32 tensor on ``device``, made
    on the first call for that device."""
    key = str(device)
    if key not in _MOBILITY:
        _MOBILITY[key] = torch.tensor(_FAMILY_MOBILITY, dtype=torch.float32,
                                      device=device)
    return _MOBILITY[key]


class RegionSignals(NamedTuple):
    """What a migration policy reads each tick; the last axis is the
    region axis ``R`` (leading batch axes broadcast)."""

    price_dev: torch.Tensor    # [..., R] relative spot-price deviation
    carbon_dev: torch.Tensor   # [..., R] carbon deviation, g/kWh
    capacity: torch.Tensor     # [..., R] serveable pods this tick
    queues: torch.Tensor       # [..., R, F] pending migratable mass


def sanitize_rates(rates: torch.Tensor) -> torch.Tensor:
    """Enforce the action space's invariants on a raw ``[..., R, R, F]``
    rate tensor: clamp to [0, 1], zero the diagonal, and scale any source
    whose outflow (summed over destinations) exceeds 1 down to 1.
    Idempotent."""
    r = torch.clamp(rates, 0.0, 1.0)
    R = r.shape[-2]
    eye = torch.eye(R, dtype=torch.bool, device=r.device)[:, :, None]
    r = torch.where(eye, 0.0, r)
    out = r.sum(dim=-2, keepdim=True)   # outflow per source, over dst
    scale = torch.where(out > 1.0, 1.0 / torch.clamp(out, min=1e-30), 1.0)
    return r * scale


def _pairwise_pref(x: torch.Tensor, deadband: float = 0.0) -> torch.Tensor:
    """``[..., R] -> [..., R, R]`` one-way preference: positive where the
    source's signal exceeds the destination's by more than ``deadband``,
    the hysteresis that keeps AR(1) wiggles from shuttling mass back and
    forth at a transfer cost a hop."""
    return torch.clamp(x[..., :, None] - x[..., None, :] - deadband,
                       min=0.0)


def _dest_gate(capacity: torch.Tensor) -> torch.Tensor:
    """Soft destination gate in [0, 1): a region with no migratable
    capacity attracts nothing."""
    cap = torch.clamp(capacity, min=0.0)
    return (cap / (cap + 1.0))[..., None, :, None]   # [..., 1, R, 1]


# Carbon deviations are g/kWh, price deviations relative: this puts a
# ~100 g/kWh inter-region gap on the scale of a ~1x price gap.
_CARBON_SCALE = 1.0 / 100.0
_GAIN = 0.5
# Gradient deadbands: a >20 % price gap, a >30 g/kWh carbon gap, a
# >2-tick backlog-per-capacity gap.
_PRICE_DEADBAND = 0.2
_CARBON_DEADBAND = 0.3
_CONG_DEADBAND = 2.0


@dataclass(frozen=True)
class GeoPolicy:
    """A named migration policy: signals -> raw ``[..., R, R, F]`` rates,
    sanitized by :meth:`rates`."""

    name: str
    description: str
    rate_fn: Callable[[RegionSignals], torch.Tensor]

    def rates(self, sig: RegionSignals) -> torch.Tensor:
        return sanitize_rates(self.rate_fn(sig))


def _rates_none(sig: RegionSignals) -> torch.Tensor:
    R = sig.price_dev.shape[-1]
    return torch.zeros(tuple(sig.price_dev.shape[:-1]) + (R, R, N_FAMILIES),
                       dtype=torch.float32, device=sig.price_dev.device)


def family_total(x: torch.Tensor) -> torch.Tensor:
    """``x[..., F]`` summed over the families left to right. A reduction
    kernel's order differs between devices, and the queue total feeds the
    deadbands, so a last-bit difference could open a lane on one device
    and not on the other; fixed-order adds give every device the same
    bits."""
    total = x[..., 0]
    for f in range(1, x.shape[-1]):
        total = total + x[..., f]
    return total


def _congestion(sig: RegionSignals) -> torch.Tensor:
    """Backlog pressure per region: queued mass per unit of serve
    capacity. Drives work out of capacity-denied regions."""
    return family_total(sig.queues) / (torch.clamp(sig.capacity, min=0.0)
                                       + 1.0)


def _shaped(pref: torch.Tensor, sig: RegionSignals) -> torch.Tensor:
    return (_GAIN * pref[..., None] * _dest_gate(sig.capacity)
            * _mobility(pref.device))


def _rates_cost_first(sig: RegionSignals) -> torch.Tensor:
    pref = (_pairwise_pref(sig.price_dev, _PRICE_DEADBAND)
            + 0.2 * _pairwise_pref(_congestion(sig), _CONG_DEADBAND))
    return _shaped(pref, sig)


def _rates_carbon_first(sig: RegionSignals) -> torch.Tensor:
    pref = (_pairwise_pref(sig.carbon_dev * _CARBON_SCALE,
                           _CARBON_DEADBAND)
            + 0.2 * _pairwise_pref(_congestion(sig), _CONG_DEADBAND))
    return _shaped(pref, sig)


def _rates_balanced(sig: RegionSignals) -> torch.Tensor:
    pref = (0.5 * _pairwise_pref(sig.price_dev, _PRICE_DEADBAND)
            + 0.5 * _pairwise_pref(sig.carbon_dev * _CARBON_SCALE,
                                   _CARBON_DEADBAND)
            + 0.5 * _pairwise_pref(_congestion(sig), _CONG_DEADBAND))
    return _shaped(pref, sig)


GEO_POLICIES: dict[str, GeoPolicy] = {
    "none": GeoPolicy(
        "none", "no migration — the round-18 status quo baseline",
        _rates_none),
    "cost-first": GeoPolicy(
        "cost-first", "chase the cheapest region's spot price",
        _rates_cost_first),
    "carbon-first": GeoPolicy(
        "carbon-first", "chase the cleanest region's grid",
        _rates_carbon_first),
    "balanced": GeoPolicy(
        "balanced", "blend price and carbon gradients; inference "
        "migrates reluctantly", _rates_balanced),
}


def resolve_geo_policies(names) -> dict[str, GeoPolicy]:
    """Validated name -> GeoPolicy map; unknown names are refused before
    anything runs."""
    names = [n for n in names if n]
    if not names:
        raise ValueError(f"no geo policies named; library: "
                         f"{sorted(GEO_POLICIES)}")
    bad = [n for n in names if n not in GEO_POLICIES]
    if bad:
        raise ValueError(f"unknown geo policies {bad}; library: "
                         f"{sorted(GEO_POLICIES)}")
    return {n: GEO_POLICIES[n] for n in names}


# -- the command wire -------------------------------------------------------

_MIG_RESOURCE = "configmap"
_MIG_ANNOTATION = "ccka.io/migration-rate"


def render_migration_commands(rates, *, min_rate: float = 1e-6
                              ) -> list[PatchCommand]:
    """One merge `PatchCommand` per nonzero (src, dst, family) rate of an
    ``[R, R, F]`` tensor or array, in (src, dst, family) order: the audit
    and replay wire the sinks (and `ChaosSink`) speak."""
    if isinstance(rates, torch.Tensor):
        rates = rates.detach().cpu().numpy()
    r = np.asarray(rates, np.float64)
    if r.ndim != 3 or r.shape[0] != r.shape[1] or r.shape[2] != N_FAMILIES:
        raise ValueError(f"migration rates must be [R, R, {N_FAMILIES}]; "
                         f"got {r.shape}")
    cmds: list[PatchCommand] = []
    for src in range(r.shape[0]):
        for dst in range(r.shape[1]):
            for f, fam in enumerate(MIGRATABLE_FAMILIES):
                rate = float(r[src, dst, f])
                if src == dst or rate <= min_rate:
                    continue
                cmds.append(PatchCommand(
                    _MIG_RESOURCE, f"geo-mig-{fam}-r{src}-r{dst}", "merge",
                    {"metadata": {"annotations": {
                        _MIG_ANNOTATION: f"{rate:.9f}"}}}))
    return cmds


def apply_migration_commands(commands, n_regions: int) -> torch.Tensor:
    """A (possibly chaos-thinned) command stream parsed back into the
    ``[R, R, F]`` rates the cluster saw (on the CPU; `geo_rollout` moves
    an override to the lanes' device). A dropped command
    leaves its cell at 0; unrelated commands are ignored; the result is
    sanitized again, so a rewritten stream cannot break conservation."""
    rates = np.zeros((n_regions, n_regions, N_FAMILIES), np.float32)
    fam_ix = {fam: f for f, fam in enumerate(MIGRATABLE_FAMILIES)}
    for cmd in commands:
        if (not isinstance(cmd, PatchCommand)
                or cmd.resource != _MIG_RESOURCE
                or not cmd.name.startswith("geo-mig-")):
            continue
        try:
            fam, s_tok, d_tok = cmd.name[len("geo-mig-"):].rsplit("-", 2)
            src, dst = int(s_tok[1:]), int(d_tok[1:])
            rate = float(json.loads(json.dumps(cmd.patch))["metadata"]
                         ["annotations"][_MIG_ANNOTATION])
        except (ValueError, KeyError, TypeError):
            continue
        if fam in fam_ix and 0 <= src < n_regions and 0 <= dst < n_regions:
            rates[src, dst, fam_ix[fam]] = rate
    return sanitize_rates(torch.from_numpy(rates))
