"""Kill/restart chaos harness: the end-to-end recovery scoreboard.

The PyTorch form of `ccka_tpu/harness/recovery.py`. Its kill ticks come
from Python's ``random`` and its stale scrapes from numpy, so the port's
board kills at the JAX board's ticks and sees its outages; the
controllers run on the card unless ``device="cpu"``.

Round 10 measured how policies degrade when the *world* misbehaves
(`faults/scoreboard.py`); this board measures whether the control loop
itself survives dying. Each cell of {policy} x {actuation intensity}
runs paired controller sessions over the SAME seeded world, signal-fault
schedule and chaos realization:

- **baseline**: an uninterrupted run of ``ticks`` control ticks through
  a `ChaosSink`-wrapped dry-run cluster with a `Reconciler` converging
  every tick;
- **killed**: the same run murdered at a seeded random tick — the
  controller object is discarded (the process-death analog; the sink
  lives on, as a real cluster would), a fresh controller is constructed,
  restored from the durable snapshot, and driven to the end.

Recovery metrics per pair, aggregated per cell:

- ``duplicate_patches`` / ``lost_patches`` — multiset diff of the
  kubectl-equivalent command streams; both MUST be zero (snapshots are
  written at tick boundaries, so resume replays nothing and skips
  nothing);
- ``resume_bitwise`` — the killed run's decision fingerprints (cost/
  carbon/node/profile per tick) match the baseline's exactly;
- ``ticks_to_reconverge`` — post-kill ticks until the fingerprint
  streams agree and stay agreed (0 under the bitwise invariant);
- ``usd_per_slo_hr_vs_baseline`` — paired $/SLO-hour ratio killed vs
  uninterrupted (1.0 under the invariant; the board states it rather
  than assuming it).

Signal-side faults ride along: each intensity pairs its `CHAOS_PRESETS`
actuation preset with a stale-scrape fraction driven through the
degraded-mode state machine — the combined signal and actuation stress.
Used by `bench.py bench_recovery` and the `recover-eval` command.
"""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
import sys
import tempfile
from collections import Counter

import numpy as np

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import CHAOS_PRESETS, FrameworkConfig

# Stale-scrape fraction paired with each actuation intensity: the signal
# half of "combined signal+actuation fault intensities". Kept mild —
# the degraded-mode machine (not the scoreboard) is what a stale tick
# exercises; heavy outage sweeps live on the fault board.
SIGNAL_STALE_FRAC = {"off": 0.0, "mild": 0.04, "moderate": 0.08,
                     "severe": 0.15}

_KNOWN_POLICIES = ("rule", "carbon", "flagship")


def _fingerprint(report) -> tuple:
    """The per-tick decision/estimate identity used for bitwise
    comparison: everything here derives deterministically from (state,
    action, exo), so equality across a kill is equality of the decision
    stream. Timings and snapshot ages are deliberately excluded."""
    return (report.t, report.profile, report.is_peak,
            report.cost_usd_hr, report.carbon_g_hr, report.nodes_spot,
            report.nodes_od, report.pending_pods, report.slo_ok)


def _usd_per_slo_hr(reports, dt_s: float) -> float:
    dt_hr = dt_s / 3600.0
    cost = sum(r.cost_usd_hr for r in reports) * dt_hr
    slo_hr = sum(1.0 for r in reports if r.slo_ok) * dt_hr
    return cost / max(slo_hr, 1e-9)


class _FlakyStaleSource:
    """Wrap a SignalSource with a seeded stale-scrape schedule.

    Staleness is a pure function of (tick, seed), so baseline and killed
    runs sharing a controller seed see the SAME outage realization —
    including a resumed controller, whose source object is brand new."""

    def __init__(self, inner, stale_frac: float):
        self._inner = inner
        self.stale_frac = float(stale_frac)
        self.last_scrape_stale = False

    def tick(self, t_index: int, *, seed: int = 0, device=None):
        out = self._inner.tick(t_index, seed=seed, device=device)
        if self.stale_frac > 0.0:
            r = np.random.default_rng(
                [0x57A1E, int(seed), int(t_index)]).random()
            self.last_scrape_stale = bool(r < self.stale_frac)
        else:
            self.last_scrape_stale = False
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _make_controller(cfg, backend, source, sink, *, seed: int, device,
                     snapshot_path: str = ""):
    from ccka_tpu_torch.harness.controller import Controller

    return Controller(cfg, backend, source, sink, device=device,
                      interval_s=0.0,
                      seed=seed, log_fn=lambda s: None,
                      snapshot_path=snapshot_path,
                      reconcile_backoff_s=0.0)


def _run_pair(cfg, make_backend, preset, stale_frac: float, *,
              ticks: int, seed: int, kill_tick: int,
              snap_path: str, device) -> dict:
    """One paired (baseline, killed+resumed) run; returns its metrics.
    ``make_backend()`` gives each controller its backend: a process that
    dies takes a stateful backend's plan with it, so the resumed
    controller gets a fresh one (a stateless backend may be returned
    every time)."""
    from ccka_tpu_torch.actuation.chaos import ChaosSink
    from ccka_tpu_torch.actuation.sink import DryRunSink
    from ccka_tpu_torch.harness.snapshot import load_snapshot
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    def make_source():
        return _FlakyStaleSource(
            SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                  cfg.signals),
            stale_frac)

    # Baseline: uninterrupted.
    sink_b = DryRunSink()
    ctrl = _make_controller(cfg, make_backend(), make_source(),
                            ChaosSink(sink_b, preset, seed=seed),
                            seed=seed, device=device)
    base_reports = ctrl.run(ticks)
    ctrl.close()
    base_fp = [_fingerprint(r) for r in base_reports]
    base_cmds = [c.render() for c in sink_b.commands]

    # Killed: run to kill_tick, discard the controller (the process
    # dies; the cluster — sink + chaos RNG — survives), construct a
    # fresh one, restore, finish. The source is rebuilt too: a new
    # process would re-create it from config exactly like this.
    sink_k = DryRunSink()
    chaos_k = ChaosSink(sink_k, preset, seed=seed)
    ctrl1 = _make_controller(cfg, make_backend(), make_source(), chaos_k,
                             seed=seed, device=device,
                             snapshot_path=snap_path)
    pre = ctrl1.run(kill_tick)
    ctrl1.close()
    del ctrl1
    ctrl2 = _make_controller(cfg, make_backend(), make_source(), chaos_k,
                             seed=seed, device=device,
                             snapshot_path=snap_path)
    start = ctrl2.restore(load_snapshot(snap_path))
    post = ctrl2.run(ticks - start, start_tick=start)
    ctrl2.close()
    kill_reports = pre + post
    kill_fp = [_fingerprint(r) for r in kill_reports]
    kill_cmds = [c.render() for c in sink_k.commands]

    dup = sum((Counter(kill_cmds) - Counter(base_cmds)).values())
    lost = sum((Counter(base_cmds) - Counter(kill_cmds)).values())
    bitwise = kill_fp == base_fp and kill_cmds == base_cmds
    # Ticks past the kill point until the fingerprint streams agree and
    # STAY agreed (0 when the resume is bitwise). Never-reconverged —
    # the LAST tick still disagrees — reports ticks-kill_tick+1, one
    # past any genuine convergence, so a permanent divergence can never
    # masquerade as late convergence on the board.
    reconverge = ticks - kill_tick + 1
    for i in range(kill_tick, ticks):
        if kill_fp[i:] == base_fp[i:]:
            reconverge = i - kill_tick
            break
    dt_s = float(cfg.sim.dt_s)
    base_usd = _usd_per_slo_hr(base_reports, dt_s)
    kill_usd = _usd_per_slo_hr(kill_reports, dt_s)
    return {
        "kill_tick": kill_tick,
        "duplicate_patches": dup,
        "lost_patches": lost,
        "resume_bitwise": bitwise,
        "ticks_to_reconverge": reconverge,
        "usd_ratio": kill_usd / max(base_usd, 1e-9),
        "reconcile_retries": kill_reports[-1].reconcile_retries_total,
        "actuation_failures": kill_reports[-1].actuation_failures_total,
        "degraded_ticks": kill_reports[-1].degraded_ticks_total,
        "resumes": kill_reports[-1].resumes_total,
        "chaos": dict(chaos_k.stats),
    }


def recovery_scoreboard(cfg: FrameworkConfig, *,
                        policies=("rule", "flagship"),
                        intensities=("off", "mild", "moderate", "severe"),
                        runs_per_cell: int = 8,
                        ticks: int = 32,
                        seed: int = 101,
                        snapshot_dir: str | None = None,
                        device=None) -> dict:
    """The recovery board (module docstring). ``intensities``
    must name `config.CHAOS_PRESETS` entries; ``policies`` is a subset
    of {rule, carbon, flagship} — unknown names are rejected up front,
    matching the chaos-eval/scenario-eval convention. The controllers
    run on ``device`` (the card unless ``device="cpu"``)."""
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    device = resolve_device(device)

    bad = [i for i in intensities if i not in CHAOS_PRESETS]
    if bad:
        raise ValueError(f"unknown chaos intensities {bad}; presets: "
                         f"{sorted(CHAOS_PRESETS)}")
    bad = [p for p in policies if p not in _KNOWN_POLICIES]
    if bad:
        raise ValueError(f"unknown policies {bad}; known: "
                         f"{list(_KNOWN_POLICIES)} — a typo here would "
                         f"otherwise run the full sweep and emit a board "
                         f"missing that row")
    if ticks < 4:
        raise ValueError("recovery runs need ticks >= 4 (a kill point "
                         "strictly inside the run)")

    backends: dict[str, object] = {}
    out: dict = {
        "engine": "controller(dry-run chaos harness, reconciler, "
                  "snapshot/resume)",
        "ticks_per_run": ticks,
        "runs_per_cell": runs_per_cell,
        "seed": seed,
        "policies": list(policies),
        # "intensities" lists the names; "cells" holds the per-
        # {intensity x policy} rows — the SAME schema the JAX package's records
        # embeds and test_doc_sync parses, so the record path is
        # paste-through (no hand restructuring between bench and record).
        "intensities": list(intensities),
        "cells": {},
    }
    for p in policies:
        if p == "rule":
            backends[p] = RulePolicy(cfg.cluster, device=device)
        elif p == "carbon":
            backends[p] = CarbonAwarePolicy(cfg.cluster, device=device)
        else:
            flagship, meta = load_flagship_backend(cfg, device=device)
            if flagship is None:
                out["flagship_source"] = (
                    "omitted: no flagship checkpoint for this topology "
                    "(no stand-ins)")
                continue
            out["flagship_source"] = {
                "checkpoint": "topology-keyed flagship",
                "selected_iteration": meta.get("selected_iteration")}
            backends[p] = flagship

    tmp = snapshot_dir or tempfile.mkdtemp(prefix="ccka-recovery-")
    owns_tmp = snapshot_dir is None
    n_paired = 0
    try:
        for name in intensities:
            preset = CHAOS_PRESETS[name]
            stale_frac = SIGNAL_STALE_FRAC.get(name, 0.0)
            rows: dict[str, dict] = {}
            for pname, backend in backends.items():
                rng = random.Random((seed, name, pname).__repr__())
                pairs = []
                for i in range(runs_per_cell):
                    run_seed = seed + 7919 * i
                    kill_tick = rng.randrange(1, ticks - 1)
                    snap_path = os.path.join(
                        tmp, f"{name}-{pname}-{i}.snap")
                    pairs.append(_run_pair(
                        cfg, lambda b=backend: b, preset, stale_frac,
                        ticks=ticks,
                        seed=run_seed, kill_tick=kill_tick,
                        snap_path=snap_path, device=device))
                    n_paired += 1
                ratios = np.asarray([p["usd_ratio"] for p in pairs])
                rows[pname] = {
                    "n_pairs": len(pairs),
                    "duplicate_patches_total": int(
                        sum(p["duplicate_patches"] for p in pairs)),
                    "lost_patches_total": int(
                        sum(p["lost_patches"] for p in pairs)),
                    "resume_bitwise_frac": round(
                        float(np.mean([p["resume_bitwise"]
                                       for p in pairs])), 4),
                    "ticks_to_reconverge_mean": round(float(np.mean(
                        [p["ticks_to_reconverge"] for p in pairs])), 4),
                    "ticks_to_reconverge_max": int(max(
                        p["ticks_to_reconverge"] for p in pairs)),
                    "usd_per_slo_hr_vs_baseline": round(
                        float(ratios.mean()), 6),
                    "usd_per_slo_hr_vs_baseline_se": round(
                        float(ratios.std(ddof=1) / np.sqrt(ratios.size))
                        if ratios.size >= 2 else 0.0, 6),
                    "reconcile_retries_mean": round(float(np.mean(
                        [p["reconcile_retries"] for p in pairs])), 3),
                    "actuation_failures_mean": round(float(np.mean(
                        [p["actuation_failures"] for p in pairs])), 3),
                    "degraded_ticks_mean": round(float(np.mean(
                        [p["degraded_ticks"] for p in pairs])), 3),
                    "kill_ticks": [p["kill_tick"] for p in pairs],
                    "chaos_injected": {
                        k: int(sum(p["chaos"][k] for p in pairs))
                        for k in ("timeouts", "transient_exits",
                                  "dropped", "rewrites")},
                }
                print(f"# recovery[{name}/{pname}]: "
                      f"bitwise={rows[pname]['resume_bitwise_frac']:.2f} "
                      f"dup={rows[pname]['duplicate_patches_total']} "
                      f"lost={rows[pname]['lost_patches_total']} "
                      f"usd_ratio="
                      f"{rows[pname]['usd_per_slo_hr_vs_baseline']:.4f}",
                      file=sys.stderr)
            out["cells"][name] = {
                "chaos": dataclasses.asdict(preset),
                "signal_stale_frac": stale_frac,
                "rows": rows,
            }
    finally:
        if owns_tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    out["n_paired_runs"] = n_paired
    out["invariants"] = {
        "duplicate_patches_total": int(sum(
            r["duplicate_patches_total"]
            for sec in out["cells"].values()
            for r in sec["rows"].values())),
        "lost_patches_total": int(sum(
            r["lost_patches_total"]
            for sec in out["cells"].values()
            for r in sec["rows"].values())),
        "resume_bitwise_frac": round(float(np.mean([
            r["resume_bitwise_frac"]
            for sec in out["cells"].values()
            for r in sec["rows"].values()])), 4),
    }
    return out
