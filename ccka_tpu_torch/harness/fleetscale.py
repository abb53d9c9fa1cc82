"""Fleet-scale tail-latency record: the 10^4-tenant host-loop sweep.

The PyTorch form of `ccka_tpu/harness/fleetscale.py`. The overload board
(`harness/overload.py`) proves the breaker/bulkhead/shed semantics at
16-64 tenants; this harness proves the HOST LOOP at fleet scale. Three
instruments, one record:

- **paired parity** (the refactor gate): the vectorized tenant machine
  vs the per-tenant object loop, same seeded world on the det clock
  — per-tick decisions (lanes), patch streams (DryRunSink commands),
  and every ServiceTickReport counter must be bitwise identical at
  small N before the record may cite the vectorized numbers.
- **chunk parity**: the N=1024 fleet through `sim/lanes.chunk_layout`
  chunked dispatch (one k-tenant graph replayed per chunk) vs the
  unchunked N=1024 graph — chunking the tenant axis must not move a
  single byte of decision output.
- **the sweep**: N in {16 … 10240} x {calm, 25% slow + moderate
  chaos}, recording p50/p99/max tick latency, sheds/deferrals,
  host-loop µs/tenant, and the paired healthy-tenant $/SLO-hour ratio
  against a calm baseline at the same N (bulkheads working = exactly
  1.0: healthy decide rows are row-independent and the admission
  machine orders them ahead of every stressed tenant). The
  vectorized-vs-object host-loop speedup at N=4096 is the record's
  headline (the JAX record gates it at >= 10x).

All knobs are validated up front (the chaos-eval convention). Runs on
the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ccka_tpu_torch.config import (CHAOS_PRESETS, SERVICE_PRESETS,
                                   FrameworkConfig)

# Tenant counts at or above this ride the chunked tenant-axis dispatch
# (one captured k-tenant graph per fleet size, replayed for every chunk).
_CHUNK_FROM = 1024
_CHUNK = 256


def _latency_stats(lats_ms) -> dict:
    arr = np.asarray(lats_ms, np.float64)
    return {
        "p50": round(float(np.percentile(arr, 50)), 3),
        "p99": round(float(np.percentile(arr, 99)), 3),
        "max": round(float(arr.max()), 3),
        "mean": round(float(arr.mean()), 3),
    }


def _det_clock():
    from ccka_tpu_torch.harness.service import VirtualClock
    return VirtualClock(base=lambda: 0.0)


def _report_counters(rep) -> dict:
    """The deterministic slice of a ServiceTickReport (host timing
    fields excluded — they are real microseconds and may differ
    between two otherwise bitwise-identical runs)."""
    d = dataclasses.asdict(rep)
    for k in ("tick_latency_ms", "decide_ms", "fanout_ms",
              "host_loop_us_per_tenant"):
        d.pop(k, None)
    return d


def _patch_stream(service) -> list:
    """Per-sink rendered command streams (through any chaos wrap)."""
    out = []
    for snk in service.sinks:
        inner = getattr(snk, "inner", snk)
        out.append([repr(c) for c in inner.commands])
    return out


def _run_paired(cfg, backend, n, profiles, svc, *, ticks, seed,
                horizon, variants, device=None) -> dict:
    """Run the same seeded world once per (host_loop, dispatch_chunk)
    variant on the det clock and compare EVERYTHING deterministic."""
    from ccka_tpu_torch.harness.service import fleet_service_from_config

    runs = {}
    for name, (host_loop, chunk) in variants.items():
        service = fleet_service_from_config(
            cfg, backend, n, profiles=profiles, service=svc,
            horizon_ticks=horizon, seed=seed, clock=_det_clock(),
            host_loop=host_loop, dispatch_chunk=chunk, device=device)
        service.warmup()
        reports = [_report_counters(r) for r in service.run(ticks)]
        runs[name] = {
            "reports": reports,
            "patches": _patch_stream(service),
            "held": service._held.copy(),
            "usd": service.tenant_cost_usd.copy(),
            "slo": service.tenant_slo_ticks.copy(),
            "transitions": service.breaker_transition_counts(),
        }
        service.close()
    names = list(runs)
    a, b = runs[names[0]], runs[names[1]]
    mismatches = []
    for t, (ra, rb) in enumerate(zip(a["reports"], b["reports"])):
        for k in ra:
            if ra[k] != rb[k]:
                mismatches.append(f"t{t}:{k}")
    if a["patches"] != b["patches"]:
        mismatches.append("patch_streams")
    for k in ("held", "usd", "slo"):
        if not np.array_equal(a[k], b[k]):
            mismatches.append(k)
    if a["transitions"] != b["transitions"]:
        mismatches.append("breaker_transitions")
    return {
        "n_tenants": int(n),
        "ticks": int(ticks),
        "variants": {k: {"host_loop": v[0], "dispatch_chunk": v[1]}
                     for k, v in variants.items()},
        "bitwise_identical": not mismatches,
        "mismatches": mismatches[:16],
        "checked": ["report_counters", "patch_streams", "held_rows",
                    "tenant_usd", "tenant_slo_ticks",
                    "breaker_transitions"],
    }


def fleet_scale_record(cfg: FrameworkConfig, *,
                       tenants=(16, 256, 1024, 4096, 10240),
                       slow_frac: float = 0.25,
                       intensity: str = "moderate",
                       slow_profile: str = "slow",
                       service_preset: str = "default",
                       cap_frac: float = 0.9,
                       ticks: int = 12,
                       parity_n: int = 16,
                       chunk_parity_n: int = 1024,
                       speedup_n: int = 4096,
                       seed: int = 211, device=None) -> dict:
    """The fleet-scale record (module docstring). ``device``: the card
    unless ``"cpu"``; without a GPU and without that request it raises
    before any run."""
    from ccka_tpu_torch import resolve_device
    from ccka_tpu_torch.harness.service import TENANT_PROFILES
    from ccka_tpu_torch.harness.service import fleet_service_from_config
    from ccka_tpu_torch.policy.rule import RulePolicy

    if intensity not in CHAOS_PRESETS:
        raise ValueError(f"unknown chaos intensity {intensity!r}; "
                         f"presets: {sorted(CHAOS_PRESETS)}")
    if slow_profile not in TENANT_PROFILES:
        raise ValueError(f"unknown tenant profile {slow_profile!r}; "
                         f"known: {sorted(TENANT_PROFILES)}")
    if service_preset not in SERVICE_PRESETS or \
            not SERVICE_PRESETS[service_preset].enabled:
        raise ValueError(f"service preset {service_preset!r} must name "
                         "an enabled posture")
    if not 0.0 < slow_frac < 1.0:
        raise ValueError("slow_frac out of (0, 1)")
    if not 0.0 < cap_frac <= 1.0:
        raise ValueError("cap_frac out of (0, 1]")
    if ticks < 4:
        raise ValueError("fleet-scale runs need ticks >= 4")
    if parity_n > 64:
        raise ValueError("parity_n > 64 — the paired parity gate is a "
                         "small-N bitwise pin, not a perf run")
    bad = [n for n in tenants if int(n) < 2]
    if bad:
        raise ValueError(f"tenant counts must be >= 2: {bad}")
    if speedup_n not in tenants:
        raise ValueError(f"speedup_n={speedup_n} must be one of the "
                         f"swept tenant counts {tuple(tenants)}")

    dev = resolve_device(device)
    base_svc = SERVICE_PRESETS[service_preset]
    # One horizon for every run (the speedup pair runs >= 24 ticks):
    # the tick's graph cache is keyed on it, so a uniform horizon
    # means ONE chunk graph per fleet size serves the upper sweep.
    horizon = max(int(ticks), 24) + 4
    backend = RulePolicy(cfg.cluster, device=dev)
    slow_base = TENANT_PROFILES[slow_profile]
    stressed_prof = dataclasses.replace(
        slow_base,
        name=f"{slow_base.name}+{intensity}",
        chaos=(intensity if intensity != "off" else ""),
        priority=max(slow_base.priority, 2),
        stale_tolerant=True)

    def svc_for(n: int):
        return dataclasses.replace(
            base_svc,
            admission_queue_cap=max(1, int(np.ceil(cap_frac * n))))

    def chunk_for(n: int):
        return _CHUNK if n >= _CHUNK_FROM else None

    out: dict = {
        "engine": "vectorized fleet-service host loop (flat-array "
                  "admission machine, chunked tenant-axis dispatch)",
        "ticks_per_run": int(ticks),
        "seed": int(seed),
        "sweep_n": [int(n) for n in tenants],
        "scenarios": ["calm", f"slow{slow_frac:g}_{intensity}"],
        "slow_frac": float(slow_frac),
        "intensity": intensity,
        "service_preset": service_preset,
        "cap_frac": float(cap_frac),
        "dispatch_chunk": {str(int(n)): chunk_for(n) for n in tenants},
        "cells": {},
    }

    # -- gate 1: vectorized-vs-object bitwise parity (det clock) -------
    mix = ["healthy", "batch", "jittery", slow_profile, "flaky"]
    parity_profiles = [mix[i % len(mix)] for i in range(parity_n)]
    out["parity"] = _run_paired(
        cfg, backend, parity_n, parity_profiles, svc_for(parity_n),
        ticks=max(ticks, 12), seed=seed, horizon=horizon,
        variants={"vectorized": ("vectorized", None),
                  "object": ("object", None)}, device=dev)
    print(f"# fleet-scale parity n={parity_n}: bitwise="
          f"{out['parity']['bitwise_identical']}", file=sys.stderr)

    # -- gate 2: chunked-vs-unchunked bitwise parity (det clock) -------
    cp_chunk = (_CHUNK if chunk_parity_n % _CHUNK == 0
                and _CHUNK < chunk_parity_n
                else max(1, chunk_parity_n // 4))
    out["chunk_parity"] = _run_paired(
        cfg, backend, chunk_parity_n, ["healthy"] * chunk_parity_n,
        svc_for(chunk_parity_n), ticks=max(4, min(ticks, 6)),
        seed=seed, horizon=horizon,
        variants={"chunked": ("vectorized", cp_chunk),
                  "unchunked": ("vectorized", None)}, device=dev)
    print(f"# fleet-scale chunk parity n={chunk_parity_n}: bitwise="
          f"{out['chunk_parity']['bitwise_identical']}", file=sys.stderr)

    # -- the sweep -----------------------------------------------------
    def run_cell(n, profiles, host_loop, *, ticks=ticks):
        service = fleet_service_from_config(
            cfg, backend, n, profiles=profiles, service=svc_for(n),
            horizon_ticks=horizon, seed=seed, host_loop=host_loop,
            dispatch_chunk=chunk_for(n), device=dev)
        service.warmup()
        reports = service.run(ticks)
        res = {
            "latencies_ms": list(service.latencies_ms),
            "host_loop_us": [r.host_loop_us_per_tenant
                             for r in reports],
            "active_tenants_last": reports[-1].active_tenants,
            "sheds_total": service.sheds_total,
            "deferrals_total": service.deferrals_total,
            "bulkhead_skips_total": service.bulkhead_skips_total,
            "scrape_timeouts_total": service.scrape_timeouts_total,
            "breaker_transitions": service.breaker_transition_counts(),
            "usd_per_slo_hr": service.tenant_usd_per_slo_hr(),
        }
        service.close()
        return res

    speedup = None
    for n in tenants:
        n = int(n)
        n_slow = min(int(round(slow_frac * n)), n - 1)
        calm = run_cell(n, ["healthy"] * n, "vectorized")
        scen = {
            "calm": (calm, 0, None),
        }
        stress = run_cell(
            n, ["healthy"] * (n - n_slow) + [stressed_prof] * n_slow,
            "vectorized")
        scen[out["scenarios"][1]] = (stress, n_slow, calm)
        for scenario, (res, ns, base) in scen.items():
            lat = _latency_stats(res["latencies_ms"])
            deadline = float(svc_for(n).tick_deadline_ms)
            us = [u for u in res["host_loop_us"] if u is not None]
            cell = {
                "n_tenants": n,
                "scenario": scenario,
                "n_slow": int(ns),
                "dispatch_chunk": chunk_for(n),
                "latency_ms": lat,
                "deadline_violations": int(sum(
                    1 for v in res["latencies_ms"] if v > deadline)),
                "host_loop_us_per_tenant": round(
                    float(np.mean(us)), 4) if us else None,
                "active_tenants_last": res["active_tenants_last"],
                "sheds_total": int(res["sheds_total"]),
                "deferrals_total": int(res["deferrals_total"]),
                "bulkhead_skips_total": int(
                    res["bulkhead_skips_total"]),
                "scrape_timeouts_total": int(
                    res["scrape_timeouts_total"]),
                "breakers_opened": int(
                    res["breaker_transitions"]["opened"]),
            }
            if base is not None:
                healthy = slice(0, n - ns)
                ratios = (res["usd_per_slo_hr"][healthy]
                          / np.maximum(base["usd_per_slo_hr"][healthy],
                                       1e-12))
                cell["healthy_usd_ratio_mean"] = round(
                    float(ratios.mean()), 6)
                cell["healthy_usd_ratio_max"] = round(
                    float(ratios.max()), 6)
                cell["healthy_bitwise_frac"] = round(float(np.mean(
                    res["usd_per_slo_hr"][healthy]
                    == base["usd_per_slo_hr"][healthy])), 4)
            out["cells"][f"n{n}/{scenario}"] = cell
            print(f"# fleet-scale[n{n}/{scenario}]: "
                  f"p99={lat['p99']:.1f}ms "
                  f"host={cell['host_loop_us_per_tenant']}us/tenant "
                  f"shed={cell['sheds_total']}", file=sys.stderr)

        # -- gate 3: the headline speedup pair at speedup_n ------------
        # Dedicated paired runs, post-warm window: the first two ticks
        # carry cold allocator/cache state for BOTH hosts; the record
        # compares the steady loops (the bench's best-of-N idiom).
        if n == speedup_n:
            sp_ticks = max(ticks, 24)
            warm = 2
            pair = {}
            for hl in ("object", "vectorized"):
                res = run_cell(n, ["healthy"] * n, hl, ticks=sp_ticks)
                us = [u for u in res["host_loop_us"][warm:]
                      if u is not None]
                pair[hl] = float(np.mean(us)) if us else 0.0
            speedup = {
                "n_tenants": n,
                "scenario": "calm",
                "ticks": int(sp_ticks),
                "warmup_ticks_dropped": warm,
                "object_us_per_tenant": round(pair["object"], 4),
                "vectorized_us_per_tenant": round(
                    pair["vectorized"], 4),
                "ratio": round(pair["object"]
                               / max(pair["vectorized"], 1e-9), 2),
            }
            print(f"# fleet-scale speedup n={n}: "
                  f"object={pair['object']:.2f} "
                  f"vec={pair['vectorized']:.2f} us/tenant -> "
                  f"{speedup['ratio']:.1f}x", file=sys.stderr)
    out["speedup"] = speedup

    # -- the acceptance surface, stated on the record itself -----------
    ratio_cells = [c for c in out["cells"].values()
                   if "healthy_usd_ratio_max" in c]
    p99_all = [c["latency_ms"]["p99"] for c in out["cells"].values()]
    out["invariants"] = {
        "parity_bitwise": bool(out["parity"]["bitwise_identical"]),
        "chunk_parity_bitwise": bool(
            out["chunk_parity"]["bitwise_identical"]),
        "speedup_ratio": (None if speedup is None
                          else speedup["ratio"]),
        "healthy_usd_ratio_max": round(max(
            c["healthy_usd_ratio_max"] for c in ratio_cells), 6),
        "healthy_ratio_exact_all": bool(all(
            c["healthy_usd_ratio_max"] == 1.0
            and c["healthy_usd_ratio_mean"] == 1.0
            for c in ratio_cells)),
        "latency_p99_max_ms": round(max(p99_all), 3),
        "max_tenants": int(max(tenants)),
    }
    return out
