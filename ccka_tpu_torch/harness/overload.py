"""Overload scoreboard: paired stressed/calm multi-tenant service runs.

The PyTorch form of `ccka_tpu/harness/overload.py`. The fault board
measures how policies degrade when the *world* misbehaves and the
recovery board whether the loop survives dying; this board measures
whether the CONTROL PLANE stays responsive and fair when some of its
tenants misbehave — the property KIS-S/NeuroScaler demand of a control
loop that manages the very load stressing it. Each cell of
{tenant count x chaos intensity x slow-tenant fraction} runs the
:class:`~ccka_tpu_torch.harness.service.FleetService` twice over the SAME
seeded world:

- **stressed**: the last ``slow_frac`` of the fleet runs a composed
  stress profile (the hung-scrape ``slow_profile`` archetype + the
  cell's `CHAOS_PRESETS` intensity on its kubectl edge, shed-eligible
  priority), behind an admission cap at ``cap_frac`` of the fleet;
- **calm**: the same fleet, same seed, same service posture, every
  tenant healthy.

Isolation metrics per cell (the acceptance surface):

- ``healthy_usd_ratio_{mean,max}`` — per-tenant paired $/SLO-hour,
  stressed vs calm, over the HEALTHY tenants only. Bulkheads working =
  ratio 1.0 bitwise (healthy decide rows are row-independent);
  the board states the measured ratio rather than assuming it.
- ``latency_ms`` p50/p99/max on the service's clock (real time plus
  the virtual scrape delays; dispatch and fan-out count), next to
  the configured ``tick_deadline_ms`` and a count of deadline
  violations — bounded ticks proven on the record.
- shed/deferral/bulkhead/cadence counters, breaker transition counts,
  and the injected chaos tally (every dropped decide is accounted,
  never silent).

The ``slow_frac == 0`` cells are the null-stress control: stressed and
calm runs are then literally identical configurations, so their ratio
pins the service-layer overhead at exactly 1.0. Used by the
`overload-eval` command; unknown intensity/profile/policy names are
rejected up front (the chaos-eval convention). Runs on the card unless
``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ccka_tpu_torch.config import (CHAOS_PRESETS, SERVICE_PRESETS,
                                   FrameworkConfig)

_KNOWN_POLICIES = ("rule", "carbon", "flagship")


def _latency_stats(lats_ms) -> dict:
    arr = np.asarray(lats_ms, np.float64)
    return {
        "p50": round(float(np.percentile(arr, 50)), 3),
        "p99": round(float(np.percentile(arr, 99)), 3),
        "max": round(float(arr.max()), 3),
        "mean": round(float(arr.mean()), 3),
    }


def _run_service(cfg, backend, n, profiles, svc, *, ticks, seed,
                 horizon, device=None) -> dict:
    """One warmed service run; returns its board-relevant surfaces."""
    from ccka_tpu_torch.harness.service import fleet_service_from_config

    service = fleet_service_from_config(
        cfg, backend, n, profiles=profiles, service=svc,
        horizon_ticks=horizon, seed=seed, device=device)
    service.warmup()
    reports = service.run(ticks)
    out = {
        "usd_per_slo_hr": service.tenant_usd_per_slo_hr(),
        "fresh_ticks": service.tenant_fresh_ticks.copy(),
        "latencies_ms": list(service.latencies_ms),
        "sheds_total": service.sheds_total,
        "deferrals_total": service.deferrals_total,
        "cadence_skips_total": service.cadence_skips_total,
        "bulkhead_skips_total": service.bulkhead_skips_total,
        "scrape_timeouts_total": service.scrape_timeouts_total,
        "scrape_failures_total": service.scrape_failures_total,
        "actuation_giveups_total": service.actuation_giveups_total,
        "breaker_transitions": service.breaker_transition_counts(),
        "chaos_injected": service.chaos_injected(),
        "cadence_divisor_last": reports[-1].cadence_divisor,
        "queue_depth_last": reports[-1].admission_queue_depth,
    }
    service.close()
    return out


def overload_scoreboard(cfg: FrameworkConfig, *,
                        policies=("rule", "flagship"),
                        tenants=(16, 64),
                        intensities=("off", "moderate", "severe"),
                        slow_fracs=(0.0, 0.25, 0.5),
                        slow_profile: str = "slow",
                        service_preset: str = "default",
                        cap_frac: float = 0.75,
                        ticks: int = 48,
                        seed: int = 211, device=None) -> dict:
    """The overload board (module docstring). ``intensities``
    must name `config.CHAOS_PRESETS` entries, ``slow_profile`` a
    `service.TENANT_PROFILES` archetype, ``service_preset`` a
    `config.SERVICE_PRESETS` posture, and ``policies`` a subset of
    {rule, carbon, flagship} — all rejected up front. ``device``: the
    card unless ``"cpu"``; without a GPU and without that request it
    raises before any run."""
    from ccka_tpu_torch import resolve_device
    from ccka_tpu_torch.harness.service import TENANT_PROFILES
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    bad = [i for i in intensities if i not in CHAOS_PRESETS]
    if bad:
        raise ValueError(f"unknown chaos intensities {bad}; presets: "
                         f"{sorted(CHAOS_PRESETS)}")
    if slow_profile not in TENANT_PROFILES:
        raise ValueError(f"unknown tenant profile {slow_profile!r}; "
                         f"known: {sorted(TENANT_PROFILES)}")
    if service_preset not in SERVICE_PRESETS:
        raise ValueError(f"unknown service preset {service_preset!r}; "
                         f"presets: {sorted(SERVICE_PRESETS)}")
    if not SERVICE_PRESETS[service_preset].enabled:
        raise ValueError(f"service preset {service_preset!r} is the off "
                         "gate — an overload board over the delegating "
                         "path would measure nothing")
    bad = [p for p in policies if p not in _KNOWN_POLICIES]
    if bad:
        raise ValueError(f"unknown policies {bad}; known: "
                         f"{list(_KNOWN_POLICIES)}")
    bad = [f for f in slow_fracs if not 0.0 <= f < 1.0]
    if bad:
        raise ValueError(f"slow_fracs out of [0, 1): {bad}")
    if not tenants or not intensities or not slow_fracs or not policies:
        raise ValueError("empty grid axis — tenants, intensities, "
                         "slow_fracs and policies all need at least "
                         "one entry")
    bad = [n for n in tenants if int(n) < 1]
    if bad:
        raise ValueError(f"tenant counts must be >= 1: {bad}")
    if not 0.0 < cap_frac <= 1.0:
        raise ValueError("cap_frac out of (0, 1]")
    if ticks < 4:
        raise ValueError("overload runs need ticks >= 4")

    dev = resolve_device(device)
    base_svc = SERVICE_PRESETS[service_preset]
    slow_base = TENANT_PROFILES[slow_profile]
    horizon = max(int(ticks) + 4, 8)

    backends: dict[str, object] = {}
    out: dict = {
        "engine": "fleet service(bounded batched ticks, per-tenant "
                  "breakers/bulkheads, priority shed)",
        "ticks_per_run": int(ticks),
        "seed": int(seed),
        "policies": list(policies),
        "tenants": [int(n) for n in tenants],
        "intensities": list(intensities),
        "slow_fracs": [float(f) for f in slow_fracs],
        "slow_profile": slow_profile,
        "service_preset": service_preset,
        "service": dataclasses.asdict(base_svc),
        "cap_frac": float(cap_frac),
        "cells": {},
    }
    for p in policies:
        if p == "rule":
            backends[p] = RulePolicy(cfg.cluster, device=dev)
        elif p == "carbon":
            backends[p] = CarbonAwarePolicy(cfg.cluster, device=dev)
        else:
            flagship, meta = load_flagship_backend(cfg, device=dev)
            if flagship is None:
                out["flagship_source"] = (
                    "omitted: no flagship checkpoint for this topology "
                    "(no stand-ins)")
                continue
            out["flagship_source"] = {
                "checkpoint": "topology-keyed flagship",
                "selected_iteration": meta.get("selected_iteration")}
            backends[p] = flagship
    # The record's policy list reflects the rows that actually ran —
    # a requested-but-omitted flagship must not read as having run.
    out["policies_requested"] = list(policies)
    out["policies"] = list(backends)
    if not backends:
        # Fail BEFORE the grid runs, not in the invariant summary after
        # minutes of compute (the up-front-rejection contract).
        raise ValueError(
            "no runnable policy rows — every requested policy was "
            "omitted (e.g. 'flagship' without a committed checkpoint "
            "for this topology); add 'rule' or train a flagship first")

    # Calm baselines, ONE per (policy, fleet size): every cell of that
    # column pairs against the same unstressed run (same seed, same
    # capped service posture — slow_frac 0 cells are then literally the
    # same configuration, the zero-overhead control).
    calm: dict[tuple, dict] = {}
    null_runs: dict[tuple, dict] = {}
    for n in tenants:
        svc_n = dataclasses.replace(
            base_svc,
            admission_queue_cap=max(1, int(np.ceil(cap_frac * n))))
        for pname, backend in backends.items():
            calm[(pname, n)] = _run_service(
                cfg, backend, n, ["healthy"] * n, svc_n,
                ticks=ticks, seed=seed, horizon=horizon, device=dev)

    for n in tenants:
        svc_n = dataclasses.replace(
            base_svc,
            admission_queue_cap=max(1, int(np.ceil(cap_frac * n))))
        for intensity in intensities:
            # The stressed archetype composes the hung-scrape profile
            # with this cell's kubectl-edge chaos, shed-eligible.
            stressed = dataclasses.replace(
                slow_base,
                name=f"{slow_base.name}+{intensity}",
                chaos=(intensity if intensity != "off" else ""),
                priority=max(slow_base.priority, 2),
                stale_tolerant=True)
            for frac in slow_fracs:
                # At least one healthy tenant always remains: the
                # paired ratio needs a non-empty healthy set, and
                # frac < 1 already promises one.
                n_slow = min(int(round(float(frac) * n)), n - 1)
                profiles = (["healthy"] * (n - n_slow)
                            + [stressed] * n_slow)
                rows: dict[str, dict] = {}
                for pname, backend in backends.items():
                    if n_slow == 0:
                        # A slow-frac-0 cell is the same all-healthy
                        # configuration whatever the intensity: run
                        # the null control ONCE per (policy, n) — an
                        # INDEPENDENT run from the calm baseline, so
                        # its ratio measures harness determinism
                        # rather than comparing a run to itself — and
                        # reuse it across intensities.
                        if (pname, n) not in null_runs:
                            null_runs[(pname, n)] = _run_service(
                                cfg, backend, n, profiles, svc_n,
                                ticks=ticks, seed=seed, horizon=horizon,
                                device=dev)
                        stress = null_runs[(pname, n)]
                    else:
                        stress = _run_service(cfg, backend, n, profiles,
                                              svc_n, ticks=ticks,
                                              seed=seed, horizon=horizon,
                                              device=dev)
                    base = calm[(pname, n)]
                    healthy = slice(0, n - n_slow)
                    s_usd = stress["usd_per_slo_hr"][healthy]
                    c_usd = base["usd_per_slo_hr"][healthy]
                    ratios = s_usd / np.maximum(c_usd, 1e-12)
                    lat = _latency_stats(stress["latencies_ms"])
                    deadline = float(svc_n.tick_deadline_ms)
                    rows[pname] = {
                        "healthy_usd_ratio_mean": round(
                            float(ratios.mean()), 6),
                        "healthy_usd_ratio_max": round(
                            float(ratios.max()), 6),
                        "healthy_bitwise_frac": round(float(np.mean(
                            s_usd == c_usd)), 4),
                        "latency_ms": lat,
                        "deadline_violations": int(sum(
                            1 for v in stress["latencies_ms"]
                            if v > deadline)),
                        "calm_latency_ms": _latency_stats(
                            base["latencies_ms"]),
                        "sheds_total": int(stress["sheds_total"]),
                        "deferrals_total": int(
                            stress["deferrals_total"]),
                        "cadence_skips_total": int(
                            stress["cadence_skips_total"]),
                        "bulkhead_skips_total": int(
                            stress["bulkhead_skips_total"]),
                        "scrape_timeouts_total": int(
                            stress["scrape_timeouts_total"]),
                        "scrape_failures_total": int(
                            stress["scrape_failures_total"]),
                        "actuation_giveups_total": int(
                            stress["actuation_giveups_total"]),
                        "breaker_transitions": stress[
                            "breaker_transitions"],
                        "chaos_injected": stress["chaos_injected"],
                        "cadence_divisor_last": int(
                            stress["cadence_divisor_last"]),
                        "stressed_fresh_frac": round(float(
                            stress["fresh_ticks"][n - n_slow:].mean()
                            / ticks), 4) if n_slow else None,
                        "healthy_fresh_frac": round(float(
                            stress["fresh_ticks"][healthy].mean()
                            / ticks), 4),
                    }
                    opened = rows[pname]["breaker_transitions"]["opened"]
                    print(f"# overload[n{n}/{intensity}/slow{frac:g}/"
                          f"{pname}]: ratio_max="
                          f"{rows[pname]['healthy_usd_ratio_max']:.4f} "
                          f"p99={lat['p99']:.1f}ms "
                          f"shed={rows[pname]['sheds_total']} "
                          f"opened={opened}", file=sys.stderr)
                out["cells"][f"n{n}/{intensity}/slow{frac:g}"] = {
                    "n_tenants": int(n),
                    "n_slow": n_slow,
                    "intensity": intensity,
                    "slow_frac": float(frac),
                    "admission_queue_cap": int(svc_n.admission_queue_cap),
                    "tick_deadline_ms": float(svc_n.tick_deadline_ms),
                    "rows": rows,
                }

    # Board-level invariants: the acceptance surface, stated on the
    # record itself (test_doc_sync parses these).
    all_rows = [(k, p, r) for k, c in out["cells"].items()
                for p, r in c["rows"].items()]
    out["invariants"] = {
        "healthy_usd_ratio_max": round(max(
            r["healthy_usd_ratio_max"] for _k, _p, r in all_rows), 6),
        "latency_p99_max_ms": round(max(
            r["latency_ms"]["p99"] for _k, _p, r in all_rows), 3),
        "deadline_violations_total": int(sum(
            r["deadline_violations"] for _k, _p, r in all_rows)),
        "sheds_total": int(sum(
            r["sheds_total"] for _k, _p, r in all_rows)),
        "breakers_opened_total": int(sum(
            r["breaker_transitions"]["opened"]
            for _k, _p, r in all_rows)),
    }
    null_ratios = [r["healthy_usd_ratio_max"] for k, _p, r in all_rows
                   if k.endswith("/slow0")]
    # The zero-overhead control only exists when the grid includes a
    # slow-frac-0 column; absent, the key says so instead of crashing.
    out["invariants"]["null_cell_ratio_max"] = (
        round(max(null_ratios), 6) if null_ratios else None)
    return out
