"""Cost / carbon / SLO Pareto scoreboard for the geo migration policies.

The PyTorch form of `ccka_tpu/regions/pareto.py`. Each policy becomes one
point per workload class,

    (total $ with transfer cost,  kg CO2,  the class's SLO debt)

where the SLO axis is the inference / background pending pod-ticks or the
batch deadline-miss pod-ticks, all lower-better. The front is the
non-dominated subset; a migration policy earns its keep where it strictly
dominates the ``none`` baseline on some class in some scenario.

The scenario library composes the regional lane processes into episodes:
spot storms, capacity denials, carbon seesaws. Every policy of a suite is
scored on the same lanes, drawn once per scenario, so front positions
are policy differences, not luck.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import GeoConfig
from ccka_tpu_torch.regions import geo as geo_dyn
from ccka_tpu_torch.regions.migrate import (GEO_POLICIES,
                                            MIGRATABLE_FAMILIES,
                                            resolve_geo_policies)
from ccka_tpu_torch.regions.process import (REGION_KEY_TAG,
                                            packed_region_lanes,
                                            region_step_from_block)

# SLO axis per workload class (keys of `rollout_summary()["per_class"]`).
_CLASS_SLO = {
    "inference": "pending_pod_ticks",
    "batch": "deadline_miss_pod_ticks",
    "background": "pending_pod_ticks",
}


@dataclass(frozen=True)
class GeoScenario:
    """One named geo episode: a GeoConfig recipe (its zone_region_index
    is bound to the cluster when the suite runs)."""

    name: str
    description: str
    geo: GeoConfig


def _scn(name: str, description: str, **over) -> GeoScenario:
    base = dict(
        enabled=True, price_dev_sigma=0.05, carbon_dev_sigma_g_kwh=30.0,
        capacity_pods=10.0, migratable_inference_pods=2.5,
        migratable_batch_pods=4.0, migratable_background_pods=1.5,
        batch_deadline_ticks=16, transfer_cost_usd_per_pod=0.005,
        transfer_latency_ticks=2)
    base.update(over)
    return GeoScenario(name, description, GeoConfig(**base))


GEO_SCENARIOS: dict[str, GeoScenario] = {s.name: s for s in (
    _scn("calm",
         "steady prices and grids — migration should roughly break even",
         price_dev_sigma=0.02, carbon_dev_sigma_g_kwh=15.0),
    _scn("spot-storm",
         "regional spot-price storms (3-4x surges) hit one region while "
         "the other stays cheap — the cost-arbitrage episode",
         price_storm_frac=0.15, price_storm_mult=4.0,
         price_storm_mean_ticks=24, price_storm_carbon_g_kwh=150.0,
         price_dev_sigma=0.1),
    _scn("capacity-denial",
         "stockout windows zero one region's migratable capacity while "
         "backlog builds — staying put means batch deadline misses",
         capacity_pods=8.0, capacity_deny_frac=1.0,
         capacity_deny_window_frac=0.3, capacity_deny_mean_ticks=20,
         migratable_batch_pods=6.0),
    _scn("carbon-seesaw",
         "grid intensities swing +/-120 g/kWh out of phase across "
         "regions — the carbon-arbitrage episode",
         carbon_dev_sigma_g_kwh=120.0, price_dev_sigma=0.03),
)}


def resolve_geo_scenarios(names) -> dict[str, GeoScenario]:
    """Validated name -> GeoScenario map; unknown names are refused
    before anything runs."""
    names = [n for n in names if n]
    if not names:
        raise ValueError(f"no geo scenarios named; library: "
                         f"{sorted(GEO_SCENARIOS)}")
    bad = [n for n in names if n not in GEO_SCENARIOS]
    if bad:
        raise ValueError(f"unknown geo scenarios {bad}; library: "
                         f"{sorted(GEO_SCENARIOS)}")
    return {n: GEO_SCENARIOS[n] for n in names}


# -- dominance --------------------------------------------------------------

def dominates(a, b, *, tol: float = 0.0) -> bool:
    """True iff point ``a`` Pareto-dominates ``b`` (every axis lower-
    better): a <= b everywhere and a < b somewhere, beyond ``tol``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return bool(np.all(a <= b + tol) and np.any(a < b - tol))


def pareto_front(points: dict[str, tuple]) -> list[str]:
    """Names of the non-dominated points, sorted; ``points`` maps a name
    to its lower-better axis tuple."""
    names = sorted(points)
    return [n for n in names
            if not any(dominates(points[m], points[n])
                       for m in names if m != n)]


def class_points(summaries: dict[str, dict], klass: str) -> dict[str, tuple]:
    """Per-policy (total $, kg CO2, class SLO) points of one class, from
    `rollout_summary` dicts."""
    axis = _CLASS_SLO[klass]
    return {name: (s["total_cost_usd"], s["carbon_kg"],
                   s["per_class"][klass][axis])
            for name, s in summaries.items()}


# -- the suite --------------------------------------------------------------

def scenario_seed(seed: int, index: int) -> int:
    """The lane seed of scenario ``index`` of a suite of ``seed``: the two
    mixed as `signals/synthetic.py::family_generator` mixes a family."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1, np.uint64)[0])


def fronts(summaries: dict[str, dict]) -> dict:
    """Per-class points, front and the policies that strictly dominate
    ``none``."""
    out = {}
    for klass in _CLASS_SLO:
        pts = class_points(summaries, klass)
        out[klass] = {
            "points": {n: [float(v) for v in p] for n, p in pts.items()},
            "front": pareto_front(pts),
            "dominates_none": sorted(
                n for n, p in pts.items()
                if n != "none" and dominates(p, pts["none"])),
        }
    return out


def _bound_scenarios(scenarios, zone_region_index) -> dict:
    """{name: (GeoScenario, its GeoConfig bound to the zones)}, sorted by
    name (the suite's scenario order and lane indices)."""
    zri = tuple(int(z) for z in zone_region_index)
    out = {}
    for sname, scn in sorted(resolve_geo_scenarios(scenarios).items()):
        geo = dataclasses.replace(scn.geo, zone_region_index=zri)
        geo.validate()
        out[sname] = (scn, geo)
    return out


def scenario_lanes(*, scenarios, zone_region_index, seed: int = 0,
                   steps: int = 192, batch: int = 8, dt_s: float = 30.0,
                   device=None) -> dict[str, torch.Tensor]:
    """{scenario: its ``[steps, region_rows(Z), batch]`` lane block} as
    :func:`run_geo_suite` draws them, on ``device`` (default ``cuda``):
    scenario ``i`` of the sorted names from the generator of
    (``scenario_seed(seed, i)``, the region tag) on that device."""
    from ccka_tpu_torch.signals.synthetic import family_generator

    dev = resolve_device(device)
    Z = len(tuple(zone_region_index))
    return {sname: packed_region_lanes(
        geo, family_generator(scenario_seed(seed, si), REGION_KEY_TAG, dev),
        steps, steps, Z, batch, dt_s=dt_s)
        for si, (sname, (_scn, geo)) in enumerate(
            _bound_scenarios(scenarios, zone_region_index).items())}


def run_geo_suite(*, scenarios, policies, zone_region_index,
                  seed: int = 0, steps: int = 192, batch: int = 8,
                  dt_s: float = 30.0, device=None, lanes=None) -> dict:
    """Score every policy on every scenario and build the per-class
    Pareto fronts: per-scenario summaries, fronts, strict dominance over
    the ``none`` baseline and the conservation residuals, each with the
    queues' rounding ledger (``conservation_residual``, the gated one) and
    without it (``conservation_residual_raw``, the JAX package's formula).

    Everything runs on ``device`` (default ``cuda``; raises without a
    GPU): each scenario's lanes are drawn there once
    (:func:`scenario_lanes`) and shared by every policy. ``lanes`` (a
    :func:`scenario_lanes` map, from any device) replaces the draw, so
    one set of lanes can be scored on two devices."""
    dev = resolve_device(device)
    scn_map = _bound_scenarios(scenarios, zone_region_index)
    pol_map = resolve_geo_policies(policies)
    if "none" not in pol_map:          # the baseline anchors dominance
        pol_map = {"none": GEO_POLICIES["none"], **pol_map}
    Z = len(tuple(zone_region_index))
    if lanes is None:
        lanes = scenario_lanes(scenarios=scenarios,
                               zone_region_index=zone_region_index,
                               seed=seed, steps=steps, batch=batch,
                               dt_s=dt_s, device=dev)
    out_scenarios = []
    dominance_found = False
    max_residual = max_raw = 0.0
    for sname, (scn, geo) in scn_map.items():
        step = region_step_from_block(lanes[sname].to(dev), steps, Z, geo)
        summaries: dict[str, dict] = {}
        residuals: dict[str, float] = {}
        raw: dict[str, float] = {}
        for pname, pol in sorted(pol_map.items()):
            roll = geo_dyn.geo_rollout(geo, pol, step)
            summaries[pname] = geo_dyn.rollout_summary(geo, roll)
            residuals[pname] = geo_dyn.conservation_residual(step, roll)
            raw[pname] = geo_dyn.conservation_residual(step, roll,
                                                       ledger=False)
            if pname != "none":   # what the service's gauges read
                geo_dyn.publish_geo_snapshot(geo, step, roll)
            del roll              # a day's series at fleet width is GBs
        max_residual = max(max_residual, *residuals.values())
        max_raw = max(max_raw, *raw.values())
        pareto = fronts(summaries)
        dominance_found |= any(f["dominates_none"] for f in pareto.values())
        out_scenarios.append({
            "scenario": sname,
            "description": scn.description,
            "summaries": summaries,
            "conservation_residual": residuals,
            "conservation_residual_raw": raw,
            "pareto": pareto,
        })
        del step
    return {
        "scenarios": out_scenarios,
        "policies": sorted(pol_map),
        "classes": sorted(_CLASS_SLO),
        "families": list(MIGRATABLE_FAMILIES),
        "steps": steps,
        "batch": batch,
        "dominance_found": bool(dominance_found),
        "max_conservation_residual": float(max_residual),
        "max_conservation_residual_raw": float(max_raw),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else str(dev),
    }
