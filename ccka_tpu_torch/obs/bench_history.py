"""Bench-history regression sentinel: the perf trajectory as ONE series.

The port's copy of `ccka_tpu/obs/bench_history.py`, line for line: on
the same records its history, diff and scaling curve are the JAX
module's, JSON and CSV alike. The records it reads are the JAX
package's (`BENCH_r*.json`, `MULTICHIP_r*.json`,
`data/lane_times.json`).

The repo's measured record is scattered across `BENCH_r*.json` (whose
shape changed by round: r01–r05 are run wrappers with a truncated
`tail` string, r08+ are stage records, r10+ carry provenance) and
`data/lane_times.json` (the tier-1 wall-clock rows the conftest hook
appends) — readable by a human with patience, unreadable by tooling.
This module loads ALL of it into one schema'd series and diffs
consecutive rounds with explicit thresholds, so "did round N regress
round N-1?" is a CI exit code (`ccka bench-diff`) instead of an
archaeology session.

Two regression classes:

- **trend gates** — consecutive-round comparisons on the same
  platform: tier-1 lane best wall-clock slowing by more than
  ``max_lane_slowdown``x, or a same-platform throughput headline
  dropping by more than ``max_headline_drop``. Cross-platform rows
  (the r5 TPU lane vs the r6 CPU lane) are never compared — a
  platform change is not a regression.
- **invariant gates** — absolute bounds a record carries about
  itself: the round-12 recovery invariants (zero duplicate/lost
  patches, bitwise resume), the round-13 overload isolation ratio
  (<= ``max_healthy_ratio``), the round-14 recorder overhead
  (< ``max_recorder_overhead`` of p50 tick latency), the round-15
  device-time observatory invariants (achieved roofline fraction in
  (0, ``max_achieved_fraction``], occupancy fractions summing to ~1,
  shard imbalance >= 1, observatory-on/off bitwise, measurement
  overhead within ``max_perf_overhead`` — and a PARTIAL perf record,
  one missing a declared mode's occupancy or attribution, is itself a
  regression), the round-18 decision-provenance invariants
  (ledger-on/off bitwise, ledger overhead within the same 5%-of-p50
  bound, objective-term shares summing to ~1 on every recorded row
  within ``max_share_err``, policy_divergence incidents attributable
  1:1 to verified dumps — partial decision records are regressions),
  and the lane budget (the round's BEST complete run
  must be under `tests/conftest._LANE_BUDGET_S` — single noisy
  re-runs don't fail the gate, a round that cannot get under it
  does.)

This module also renders the measured record as the weak-scaling
artifact ROADMAP item 1 promises (:func:`scaling_curve` /
:func:`write_scaling_csv`, behind `ccka scaling-curve`): every
multichip row across BENCH_r08+ plus the legacy MULTICHIP_r0x run
wrappers as one curve, with a per-round cluster-days/sec-per-chip
table beside it.

Host-side, stdlib-only (no torch, no jax): the sentinel must run in any
CI context, including one with no accelerator stack at all.
"""

from __future__ import annotations

import glob
import json
import os
import re

# A "complete" lane row: the session hook also records interrupted
# development runs (e.g. a 4.8s row with passed=0 in round 11); rows
# below this pass-count cannot be full tier-1 lanes and are excluded
# from the trend series. Rows with passed=None (the hand-seeded r5/r6
# rows predate the field) are KEPT and marked `passed_unknown` — a
# legacy row is not an interrupted run, and silently dropping the
# repo's only TPU lane evidence would contradict the never-silent
# contract.
_LANE_MIN_PASSED = 100

# Fallback lane budget for rows predating the over_budget stamp. The
# AUTHORITATIVE budget is tests/conftest._LANE_BUDGET_S — its session
# hook stamps `over_budget`/`budget_s` onto the rows it writes, and the
# gate below trusts the row's own stamp first, so a conftest budget
# change cannot silently diverge from this constant for stamped rows.
_LANE_BUDGET_S = 840.0

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")


def load_bench_history(root: str) -> dict:
    """All BENCH_r*.json + data/lane_times.json as one schema'd series.

    Returns {"records": [...], "lane": [...]} where each record row is
    {round, file, raw_keys, ...extracted metrics} and each lane row is
    {round, platform, best_wall_s, runs, best_over_budget}. Extraction
    is tolerant by design — the record shape changed every few rounds —
    but NEVER silent: a file that fails to parse lands in the series as
    {"round": n, "error": ...} so the diff can refuse to call a broken
    history clean."""
    records = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        m = _ROUND_RE.search(os.path.basename(path))
        if not m:
            continue
        rnd = int(m.group(1))
        row: dict = {"round": rnd, "file": os.path.basename(path)}
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            row["error"] = f"unreadable: {e}"
            records.append(row)
            continue
        row["raw_keys"] = sorted(doc)
        row.update(_extract_metrics(doc))
        records.append(row)

    lane = []
    lane_path = os.path.join(root, "data", "lane_times.json")
    try:
        with open(lane_path, encoding="utf-8") as fh:
            lane_rows = json.load(fh)
    except (OSError, json.JSONDecodeError):
        lane_rows = []
    by_round: dict[tuple, list] = {}
    for r in lane_rows:
        passed = r.get("passed")
        if passed is not None and passed < _LANE_MIN_PASSED:
            continue  # interrupted development run, not a full lane
        by_round.setdefault((r.get("round"), r.get("platform")),
                            []).append(r)
    for (rnd, platform), rows in sorted(by_round.items(),
                                        key=lambda kv: kv[0][0] or 0):
        best = min(rows, key=lambda r: r["wall_clock_s"])
        known = [int(r["passed"]) for r in rows
                 if r.get("passed") is not None]
        lane.append({
            "round": rnd,
            "platform": platform,
            "best_wall_s": float(best["wall_clock_s"]),
            "runs": len(rows),
            "best_over_budget": bool(best.get("over_budget", False)),
            # The budget the hook stamped (over-budget rows only) —
            # authoritative over this module's fallback constant.
            "budget_s": best.get("budget_s"),
            "passed_max": max(known) if known else None,
            "passed_unknown": not known,
            # Any row of the round recorded without CCKA_ROUND set:
            # the round label was inferred by the conftest hook, not
            # stated — surfaced so a guessed attribution can never
            # masquerade as a measured one (the stamp's whole point).
            "round_inferred": any(r.get("round_inferred")
                                  for r in rows),
        })
    return {"records": records, "lane": lane}


def _extract_metrics(doc: dict) -> dict:
    """Pull the comparable metrics a record carries, whatever its
    round-era shape. Unknown shapes extract nothing (the diff then has
    nothing to compare — recorded, not asserted)."""
    out: dict = {}
    prov = doc.get("provenance") or {}
    if prov.get("platform"):
        out["platform"] = prov["platform"]
    # Full-bench headline. The r01–r05 run wrappers nest the bench
    # JSON line under "parsed" (None when the run failed) — unwrap it,
    # or the repo's only measured TPU headline (r02) silently vanishes
    # from the series.
    head = doc
    if doc.get("metric") != "sim_cluster_days_per_sec_per_chip" \
            and isinstance(doc.get("parsed"), dict):
        head = doc["parsed"]
        dev = head.get("device")
        if "platform" not in out and isinstance(dev, str) and "/" in dev:
            out["platform"] = dev.rsplit("/", 1)[1]
    if head.get("metric") == "sim_cluster_days_per_sec_per_chip" \
            and isinstance(head.get("value"), (int, float)):
        out["headline_cluster_days_per_sec"] = float(head["value"])
    # Round-12 recovery invariants.
    inv = doc.get("invariants")
    if isinstance(inv, dict):
        for k in ("duplicate_patches_total", "lost_patches_total",
                  "resume_bitwise_frac", "healthy_usd_ratio_max",
                  "latency_p99_max_ms", "null_cell_ratio_max"):
            if k in inv:
                out[k] = inv[k]
    # Round-14 obs stage (also nested under "obs" in a full record).
    obs = doc if "recorder_overhead_frac" in doc else doc.get("obs", {})
    if isinstance(obs, dict) and "recorder_overhead_frac" in obs:
        out["recorder_overhead_frac"] = obs["recorder_overhead_frac"]
        if "bitwise_identical" in obs:
            out["obs_bitwise_identical"] = obs["bitwise_identical"]
    # Round-15 device-time observatory (stage record or nested "perf").
    perf = doc if isinstance(doc.get("modes"), dict) else doc.get("perf")
    if isinstance(perf, dict) and isinstance(perf.get("modes"), dict):
        out.update(_extract_perf(perf,
                                 full_stage=doc.get("stage")
                                 == "--perf-only"))
    # Round-16 streaming pipeline (stage record or nested "stream").
    stream = (doc if isinstance(doc.get("rows"), list)
              and doc.get("stage") == "--stream-only"
              else doc.get("stream"))
    if isinstance(stream, dict) and isinstance(stream.get("rows"), list):
        out.update(_extract_stream(stream,
                                   full_stage=doc.get("stage")
                                   == "--stream-only"))
    # Round-17 distillation-factory stage (stage record or nested
    # "factory").
    # A factory record missing its cells entirely must still reach the
    # gates — _extract_factory flags it partial ("no factory cells");
    # gating only well-shaped records would wave the most-degraded
    # record through.
    fac = (doc if doc.get("stage") == "--factory-only"
           else doc.get("factory"))
    if isinstance(fac, dict):
        out.update(_extract_factory(fac,
                                    full_stage=doc.get("stage")
                                    == "--factory-only"))
    # Round-18 decision-provenance stage (stage record or nested
    # "decisions").
    dec = (doc if doc.get("stage") == "--decisions-only"
           else doc.get("decisions"))
    if isinstance(dec, dict):
        out.update(_extract_decisions(dec))
    # Round-19 geo-arbitrage stage (stage record or nested "geo").
    geo = (doc if doc.get("stage") == "--geo-only" else doc.get("geo"))
    if isinstance(geo, dict):
        out.update(_extract_geo(geo))
    # Round-20 shadow-tournament stage (stage record or nested
    # "tournament").
    tour = (doc if doc.get("stage") == "--tournament-only"
            else doc.get("tournament"))
    if isinstance(tour, dict):
        out.update(_extract_tournament(tour))
    # Round-21 fleet-scale stage (stage record or nested
    # "fleet_scale").
    fs = (doc if doc.get("stage") == "--fleet-scale-only"
          else doc.get("fleet_scale"))
    if isinstance(fs, dict):
        out.update(_extract_fleet_scale(fs,
                                        full_stage=doc.get("stage")
                                        == "--fleet-scale-only"))
    # Round-22 traced scenario-axis stage (stage record or nested
    # "scenario_search").
    se = (doc if doc.get("stage") == "--search-only"
          else doc.get("scenario_search"))
    if isinstance(se, dict):
        out.update(_extract_search(se))
    # Round-23 continual-learning flywheel stage (stage record or
    # nested "flywheel").
    fl = (doc if doc.get("stage") == "--flywheel-only"
          else doc.get("flywheel"))
    if isinstance(fl, dict):
        out.update(_extract_flywheel(fl))
    return out


def _pareto_dominates(a, b) -> bool:
    """Strict Pareto dominance on minimized axes (stdlib mirror of
    regions/pareto.dominates — this module must run jax-free)."""
    return (all(x <= y for x, y in zip(a, b))
            and any(x < y for x, y in zip(a, b)))


def _extract_geo(geo: dict) -> dict:
    """The round-19 geo-arbitrage invariants a record states about
    itself: migration rates pinned to zero must
    leave the multiregion rollout bitwise identical to the pre-geo
    code path (the parity flag must be PRESENT and true — absent is
    partial, not green), every workload class must carry its Pareto
    rows, each recorded front must actually be mutually non-dominated
    (a 'front' hiding a dominated member is a corrupt scoreboard),
    migration mass must conserve within the record's own pinned gate,
    and the decision-ledger section must state the migration term was
    attributed with shares still summing to ~1. Partial records are
    regressions — the factory/perf/decisions discipline."""
    out: dict = {"geo_partial": [], "geo_front_violations": []}
    zp = geo.get("zero_migration_parity")
    if zp is None:
        out["geo_partial"].append(
            "missing the zero_migration_parity flag")
    else:
        out["geo_zero_migration_parity"] = bool(zp)
    if geo.get("dominance_found") is None:
        out["geo_partial"].append("missing the dominance_found flag")
    else:
        out["geo_dominance_found"] = bool(geo["dominance_found"])
    residual = geo.get("max_conservation_residual")
    gate = geo.get("conservation_gate_pods")
    if residual is None or gate is None:
        out["geo_partial"].append(
            "missing the conservation residual or its pinned gate")
    else:
        out["geo_conservation_ok"] = bool(
            float(residual) <= float(gate))
        out["geo_conservation_residual"] = float(residual)
    classes = geo.get("classes") or []
    if not classes:
        out["geo_partial"].append("no workload classes recorded")
    scenarios = geo.get("scenarios") or []
    if not scenarios:
        out["geo_partial"].append("no geo scenarios recorded")
    for scn in scenarios:
        if not isinstance(scn, dict):
            out["geo_partial"].append("scenario is not a record")
            continue
        sname = scn.get("scenario", "?")
        fronts = scn.get("pareto")
        if not isinstance(fronts, dict):
            out["geo_partial"].append(
                f"scenario {sname} missing its pareto section")
            continue
        for klass in classes:
            fr = fronts.get(klass)
            if not isinstance(fr, dict) \
                    or not isinstance(fr.get("points"), dict) \
                    or not isinstance(fr.get("front"), list):
                out["geo_partial"].append(
                    f"scenario {sname} class {klass} missing its "
                    "Pareto rows")
                continue
            pts = fr["points"]
            missing = [n for n in fr["front"] if n not in pts]
            if missing:
                out["geo_partial"].append(
                    f"scenario {sname} class {klass} front names "
                    f"{missing} with no recorded points")
                continue
            for i, a in enumerate(fr["front"]):
                for b in fr["front"]:
                    if a != b and _pareto_dominates(pts[b], pts[a]):
                        out["geo_front_violations"].append(
                            f"scenario {sname} class {klass}: "
                            f"{a!r} on the front is dominated by "
                            f"{b!r}")
    led = geo.get("ledger")
    if not isinstance(led, dict):
        out["geo_partial"].append("missing the ledger section")
    else:
        if led.get("migration_term_present") is None:
            out["geo_partial"].append(
                "ledger section missing migration_term_present")
        else:
            out["geo_migration_term_present"] = bool(
                led["migration_term_present"])
        if led.get("term_share_err_max") is None:
            out["geo_partial"].append(
                "ledger section missing term_share_err_max")
        else:
            out["geo_share_err"] = float(led["term_share_err_max"])
    return out


def _extract_perf(perf: dict, *, full_stage: bool) -> dict:
    """The round-15 perf-observatory invariants a record states about
    itself. ``full_stage`` (a dedicated ``--perf-only`` record, the
    BENCH_r15 path) additionally requires ALL FOUR megakernel modes and
    the 8-shard mesh section — a record that silently dropped a mode
    would otherwise pass every per-mode gate."""
    out: dict = {"perf_achieved": {}, "perf_occupancy_sum": {},
                 "perf_partial": []}
    modes = perf["modes"]
    if full_stage:
        for required in ("rule", "carbon", "neural", "plan"):
            if required not in modes:
                out["perf_partial"].append(f"mode {required!r} missing")
    bitwise_all = True
    for name, m in sorted(modes.items()):
        if not isinstance(m, dict):
            out["perf_partial"].append(f"mode {name!r} not a record")
            continue
        frac = m.get("achieved_roofline_fraction")
        occ = (m.get("occupancy") or {}).get("fractions")
        if frac is None:
            out["perf_partial"].append(
                f"mode {name!r} missing achieved_roofline_fraction")
        else:
            out["perf_achieved"][name] = float(frac)
        if not isinstance(occ, dict) or not occ:
            out["perf_partial"].append(
                f"mode {name!r} missing occupancy fractions")
        else:
            out["perf_occupancy_sum"][name] = float(sum(occ.values()))
        if m.get("bitwise_identical") is False:
            bitwise_all = False
    mesh = perf.get("mesh8")
    if isinstance(mesh, dict):
        if mesh.get("shard_imbalance") is None:
            out["perf_partial"].append("mesh8 missing shard_imbalance")
        else:
            out["perf_imbalance"] = float(mesh["shard_imbalance"])
        occ = (mesh.get("occupancy") or {}).get("fractions")
        if isinstance(occ, dict) and occ:
            out["perf_occupancy_sum"]["mesh8"] = float(sum(occ.values()))
    elif full_stage:
        out["perf_partial"].append("mesh8 section missing")
    obs = perf.get("observatory")
    if isinstance(obs, dict):
        if obs.get("overhead_frac") is not None:
            out["perf_overhead_frac"] = float(obs["overhead_frac"])
        if obs.get("bitwise_all") is False:
            bitwise_all = False
    out["perf_bitwise_all"] = bitwise_all
    return out


def _extract_stream(stream: dict, *, full_stage: bool) -> dict:
    """The round-16 streaming-pipeline invariants a record states about
    itself: blocked-vs-sync summaries bitwise, the
    double-buffered drive's attributed kernel-stage occupancy at least
    the synchronous baseline's, per-chip throughput ratio >= 1.0 (on an
    overlap-capable host — a single-core virtual host CANNOT overlap
    two device programs, so it is held to a non-regression floor
    instead, `_STREAM_RATIO_FLOOR`), the donation chain's two-buffer
    bound, and the chunked 10^4-cluster row's bounded-memory evidence.
    ``full_stage`` records additionally require the chunked row and the
    mesh section — a record that silently dropped either would pass
    every remaining gate."""
    out: dict = {"stream_partial": []}
    bitwise = bool(stream.get("bitwise_all", True))
    ratios = []
    kocc_pairs = []
    buffers = []
    for row in stream.get("rows", []):
        if not isinstance(row, dict):
            out["stream_partial"].append("row is not a record")
            continue
        for key in ("bitwise_pipelined_vs_sync",
                    "bitwise_blocked_vs_unblocked"):
            if row.get(key) is False:
                bitwise = False
            elif key not in row:
                # An ABSENT gate is not a passed gate: a record that
                # silently dropped its bitwise fields must read as
                # partial, not green (the same discipline as the
                # missing-occupancy check below).
                out["stream_partial"].append(
                    f"row batch={row.get('batch')} missing {key}")
        if row.get("throughput_ratio") is not None:
            ratios.append(float(row["throughput_ratio"]))
        sync_occ = (row.get("sync") or {}).get("occupancy_fractions")
        pipe_occ = (row.get("pipelined") or {}).get(
            "kernel_occupancy_fraction")
        if isinstance(sync_occ, dict) and pipe_occ is not None:
            kocc_pairs.append((float(sync_occ.get("kernel", 0.0)),
                               float(pipe_occ)))
        bufs = (row.get("pipelined") or {}).get("stream_buffers")
        if bufs is not None:
            buffers.append(int(bufs))
        if not isinstance(sync_occ, dict) or not sync_occ:
            out["stream_partial"].append(
                f"row batch={row.get('batch')} missing sync occupancy")
    if not stream.get("rows"):
        out["stream_partial"].append("no paired sweep rows")
    out["stream_bitwise_all"] = bitwise
    if ratios:
        out["stream_ratio_best"] = max(ratios)
    if kocc_pairs:
        # The best paired row decides the occupancy-gain gate (the
        # record reports every row, including hosts/geometries where
        # overlap cannot win — silent row-dropping is the failure mode
        # the partial gate catches).
        sync_k, pipe_k = max(kocc_pairs, key=lambda p: p[1] - p[0])
        out["stream_kocc_sync"] = sync_k
        out["stream_kocc_pipelined"] = pipe_k
    if buffers:
        out["stream_buffers_max"] = max(buffers)
    out["stream_overlap_capable"] = bool(
        stream.get("overlap_capable", True))
    chunked = stream.get("chunked")
    if isinstance(chunked, dict):
        if not chunked.get("live_block_bytes"):
            out["stream_partial"].append(
                "chunked row missing its live-block memory bound")
        if chunked.get("roofline_floor_s") is None:
            out["stream_partial"].append(
                "chunked row missing its roofline floor")
        if chunked.get("bitwise_pipelined_vs_sync") is False:
            out["stream_bitwise_all"] = False
        if chunked.get("batch"):
            out["stream_chunked_batch"] = int(chunked["batch"])
    elif full_stage:
        out["stream_partial"].append("chunked 10^4-cluster row missing")
    mesh = stream.get("mesh8")
    if isinstance(mesh, dict):
        if mesh.get("bitwise_mesh_vs_chunked") is False:
            out["stream_bitwise_all"] = False
        if mesh.get("throughput_ratio") is not None:
            out["stream_mesh_ratio"] = float(mesh["throughput_ratio"])
    elif full_stage:
        out["stream_partial"].append("mesh8 streaming section missing")
    return out


def _extract_factory(fac: dict, *, full_stage: bool) -> dict:
    """The round-17 distillation-factory invariants a record states
    about itself: the pairs/sec throughput ratio
    vs the naive per-pair lax loop must be RECORDED (a record that
    dropped its paired baseline would quietly stop making the claim the
    stage exists to make) and at least 1.0 — a factory slower than the
    loop it replaces is a regression by definition; the student-vs-
    teacher $/SLO-hr column must be recorded honestly (present and
    physically plausible) for every cell; PARTIAL records — a cell
    missing its throughput or its paired teacher-vs-rule column, a
    missing baseline, a missing playback roofline floor — are
    regressions. ``full_stage`` (a dedicated ``--factory-only`` record)
    additionally requires the student section and the first cell's
    occupancy ledger."""
    out: dict = {"factory_partial": []}
    cells = fac.get("cells") or []
    if not cells:
        out["factory_partial"].append("no factory cells")
    has_ledger = False
    for cell in cells:
        if not isinstance(cell, dict):
            out["factory_partial"].append("cell is not a record")
            continue
        tag = f"{cell.get('scenario')}.{cell.get('intensity')}"
        for key in ("pairs_per_sec", "plans_per_sec",
                    "playback_cluster_days_per_sec",
                    "teacher_vs_rule_usd_per_slo_hour"):
            if cell.get(key) is None:
                out["factory_partial"].append(
                    f"cell {tag} missing {key}")
        if isinstance(cell.get("playback_occupancy"), dict):
            has_ledger = True
    if fac.get("pairs_per_sec") is None:
        out["factory_partial"].append("missing factory pairs_per_sec")
    else:
        out["factory_pairs_per_sec"] = float(fac["pairs_per_sec"])
    baseline = fac.get("baseline")
    if not isinstance(baseline, dict) \
            or baseline.get("pairs_per_sec") is None:
        out["factory_partial"].append(
            "missing the paired naive-loop baseline")
    if fac.get("throughput_ratio_vs_baseline") is None:
        out["factory_partial"].append(
            "missing throughput_ratio_vs_baseline")
    else:
        out["factory_ratio"] = float(fac["throughput_ratio_vs_baseline"])
    if fac.get("playback_roofline_floor_s") is None:
        out["factory_partial"].append(
            "missing the playback roofline floor")
    student = fac.get("student")
    if isinstance(student, dict):
        ratio = student.get("student_vs_teacher_usd_per_slo_hour")
        if ratio is None:
            out["factory_partial"].append(
                "student section missing its vs-teacher ratio")
        else:
            out["factory_student_teacher"] = float(ratio)
        per_cell = student.get("per_cell") or []
        for row in per_cell:
            if isinstance(row, dict) and row.get(
                    "student_vs_teacher_usd_per_slo_hour") is None:
                out["factory_partial"].append(
                    f"student cell {row.get('scenario')}."
                    f"{row.get('intensity')} missing its ratio")
        # The column is per-CELL: a full-stage record whose student
        # board covers fewer cells than it ran dropped rows somewhere.
        if full_stage and len(per_cell) < len(cells):
            out["factory_partial"].append(
                f"student per_cell covers {len(per_cell)} of "
                f"{len(cells)} cells")
    elif full_stage:
        out["factory_partial"].append("student section missing")
    if full_stage and not has_ledger:
        out["factory_partial"].append(
            "no cell carries its playback occupancy ledger")
    return out


def _extract_decisions(dec: dict) -> dict:
    """The round-18 decision-provenance invariants a record states
    about itself: ledger-on/off runs bitwise in
    decisions AND patch streams, the ledger priced within the 5%-of-
    p50 budget, attribution shares summing to ~1 on every recorded
    row, and every policy_divergence incident attributable 1:1 to a
    checksum-verified dump. A PARTIAL record — a missing bitwise flag,
    a missing share-error field, no recorded rows, an unverified
    divergence dump — is itself a regression: the gate keys on what
    the record STATES, so a record that silently dropped a claim must
    read as degraded, not green (the factory/perf discipline)."""
    out: dict = {"decisions_partial": []}
    if dec.get("bitwise_identical") is None:
        out["decisions_partial"].append(
            "missing the ledger-on/off bitwise_identical flag")
    else:
        out["decisions_bitwise"] = bool(dec["bitwise_identical"])
    if dec.get("ledger_overhead_frac") is None:
        out["decisions_partial"].append(
            "missing ledger_overhead_frac")
    else:
        out["decisions_overhead_frac"] = float(
            dec["ledger_overhead_frac"])
    if dec.get("term_share_err_max") is None:
        out["decisions_partial"].append("missing term_share_err_max")
    else:
        out["decisions_share_err"] = float(dec["term_share_err_max"])
    if not dec.get("rows_total"):
        out["decisions_partial"].append(
            "no decision rows recorded — the ledger measured nothing")
    inc = dec.get("divergence_incidents")
    verified = dec.get("divergence_dumps_verified")
    if inc is None or verified is None:
        out["decisions_partial"].append(
            "missing the policy_divergence attribution section")
    else:
        out["decisions_divergence_incidents"] = int(inc)
        out["decisions_divergence_dumps_ok"] = bool(
            int(inc) >= 1 and int(verified) == int(inc)
            and not dec.get("divergence_dump_failures"))
    return out


def _extract_tournament(tour: dict) -> dict:
    """The round-20 shadow-tournament invariants a record states about
    itself: tournament-on/off runs bitwise in
    decisions AND patch streams (the flag must be PRESENT and true —
    absent is partial, not green), the host win-ledger priced within
    the same 5%-of-p50 bound at the record's K=4 roster, every board
    win rate (overall and per workload class) inside [0, 1], board
    rows 1:1 with the roster the record names, and the seeded
    challenger scenario holding its exactly-one-incident contract with
    a verified dump and HMAC-valid promotion audits. Partial records
    are regressions — the factory/perf/decisions/geo discipline."""
    out: dict = {"tournament_partial": [],
                 "tournament_rate_violations": []}
    if tour.get("bitwise_identical") is None:
        out["tournament_partial"].append(
            "missing the tournament-on/off bitwise_identical flag")
    else:
        out["tournament_bitwise"] = bool(tour["bitwise_identical"])
    if tour.get("ledger_overhead_frac") is None:
        out["tournament_partial"].append(
            "missing ledger_overhead_frac")
    else:
        out["tournament_overhead_frac"] = float(
            tour["ledger_overhead_frac"])
    roster = tour.get("roster")
    board = tour.get("board")
    if not isinstance(roster, list) or not roster:
        out["tournament_partial"].append(
            "missing the roster the record claims to have scored")
    if not isinstance(board, dict) or not board:
        out["tournament_partial"].append(
            "no board recorded — the tournament scored nothing")
    elif isinstance(roster, list) and roster:
        out["tournament_board_matches_roster"] = bool(
            list(board) == list(roster))
        for name, entry in board.items():
            if not isinstance(entry, dict):
                out["tournament_partial"].append(
                    f"board row {name!r} is not a record")
                continue
            rates = [("overall", entry.get("win_rate"))]
            rates += [(f"class {c}", (ce or {}).get("win_rate"))
                      for c, ce in (entry.get("classes") or {}).items()]
            for where, rate in rates:
                if rate is not None and not 0.0 <= float(rate) <= 1.0:
                    out["tournament_rate_violations"].append(
                        f"candidate {name!r} {where} win rate {rate} "
                        "outside [0, 1]")
            if not entry.get("classes"):
                out["tournament_partial"].append(
                    f"board row {name!r} missing its per-class split")
    ch = tour.get("challenger")
    if not isinstance(ch, dict):
        out["tournament_partial"].append(
            "missing the seeded challenger scenario section")
    else:
        inc = ch.get("incidents")
        dumps = ch.get("dumps_verified")
        audits = ch.get("audit_rows")
        valid = ch.get("audits_verified")
        if inc is None or dumps is None or audits is None \
                or valid is None:
            out["tournament_partial"].append(
                "challenger section missing its incident/dump/audit "
                "accounting")
        else:
            out["tournament_challenger_ok"] = bool(
                int(inc) == 1 and int(dumps) == 1 and int(audits) >= 1
                and int(valid) == int(audits)
                and not ch.get("dump_failures"))
    return out


def _extract_fleet_scale(fs: dict, *, full_stage: bool) -> dict:
    """The round-21 fleet-scale invariants a record states about
    itself: the vectorized-vs-object parity and
    chunked-dispatch parity flags PRESENT and true (absent is partial,
    not green), the N=4096 host-loop speedup recorded, every sweep
    cell the record's own sweep_n x scenarios spec names present, the
    paired healthy-tenant $/SLO-hr ratio EXACTLY 1.0 in every cell
    that carries one, and a monotone-sane p99 curve: per-tenant p99
    (p99/N) must FALL as the fleet grows — a vectorized host loop
    whose tail cost per tenant rises with N has lost the whole point.
    Partial records are regressions — the factory/perf/tournament
    discipline. A full `--fleet-scale-only` record must also reach the
    10^4-tenant point the round's title claims."""
    out: dict = {"fleet_scale_partial": [],
                 "fleet_scale_p99_violations": []}
    sp = fs.get("speedup")
    if not isinstance(sp, dict) or sp.get("ratio") is None:
        out["fleet_scale_partial"].append(
            "missing the vectorized-vs-object speedup pair")
    else:
        out["fleet_scale_speedup"] = float(sp["ratio"])
    for key, outk in (("parity", "fleet_scale_parity"),
                      ("chunk_parity", "fleet_scale_chunk_parity")):
        sec = fs.get(key)
        if not isinstance(sec, dict) \
                or sec.get("bitwise_identical") is None:
            out["fleet_scale_partial"].append(
                f"missing the {key} bitwise_identical flag")
        else:
            out[outk] = bool(sec["bitwise_identical"])
    cells = fs.get("cells")
    sweep = fs.get("sweep_n")
    scenarios = fs.get("scenarios")
    if not isinstance(cells, dict) or not cells:
        out["fleet_scale_partial"].append("no sweep cells recorded")
        return out
    if not isinstance(sweep, list) or not sweep \
            or not isinstance(scenarios, list) or not scenarios:
        out["fleet_scale_partial"].append(
            "missing the sweep_n/scenarios coverage spec")
        return out
    missing = [f"n{int(n)}/{s}" for n in sweep for s in scenarios
               if f"n{int(n)}/{s}" not in cells]
    if missing:
        out["fleet_scale_partial"].append(
            f"sweep cells missing: {', '.join(missing[:6])}")
    if full_stage and max(int(n) for n in sweep) < _FLEET_MAX_N:
        out["fleet_scale_partial"].append(
            f"stage record never reached N={_FLEET_MAX_N} — the "
            "tail-latency record is about the 10^4-tenant point")
    ratio_cells = [c for c in cells.values() if isinstance(c, dict)
                   and "healthy_usd_ratio_max" in c]
    if not ratio_cells:
        out["fleet_scale_partial"].append(
            "no cell carries the paired healthy-tenant ratio")
    else:
        out["fleet_scale_healthy_exact"] = bool(all(
            c["healthy_usd_ratio_max"] == 1.0
            and c.get("healthy_usd_ratio_mean") == 1.0
            for c in ratio_cells))
    # p99 curve sanity, per scenario over increasing N.
    for scen in scenarios:
        series = []
        for n in sorted(int(x) for x in sweep):
            cell = cells.get(f"n{n}/{scen}")
            lat = (cell or {}).get("latency_ms")
            if not isinstance(lat, dict):
                continue
            p50, p99 = lat.get("p50"), lat.get("p99")
            mx = lat.get("max")
            if None in (p50, p99, mx):
                out["fleet_scale_partial"].append(
                    f"cell n{n}/{scen} missing latency percentiles")
                continue
            if not 0.0 <= p50 <= p99 <= mx:
                out["fleet_scale_p99_violations"].append(
                    f"n{n}/{scen}: percentile ordering broken "
                    f"(p50 {p50} / p99 {p99} / max {mx})")
                continue
            series.append((n, float(p99)))
        # Small-N cells are fixed-overhead / single-slow-tick noise (one
        # 100ms hiccup at N=16 swamps the per-tenant quotient), so the
        # monotone check only starts where the loop body dominates.
        series = [(n, p) for n, p in series if n >= _FLEET_P99_MIN_N]
        for (n0, p0), (n1, p1) in zip(series, series[1:]):
            if p1 / n1 > (p0 / n0) * _FLEET_P99_PER_TENANT_SLACK:
                out["fleet_scale_p99_violations"].append(
                    f"{scen}: per-tenant p99 RISES from "
                    f"{p0 / n0 * 1e3:.1f}us at N={n0} to "
                    f"{p1 / n1 * 1e3:.1f}us at N={n1} — the curve is "
                    "no longer monotone-sane")
    return out


def _extract_search(se: dict) -> dict:
    """The round-22 traced scenario-axis invariants a record states
    about itself: the traced-vs-recompile-loop
    speedup recorded and at its >=10x floor, ZERO recompiles across the
    timed ``set_params`` swap window (the compiled-once claim, counted
    by watch_jit + the axis trace cache), the S=1 bitwise-parity flags
    PRESENT and true (absent is partial, not green — the stream AND the
    summary), the N-cell traced-vs-loop allclose cross-check, and the
    minted worst case STRICTLY exceeding the policy's worst hand-named
    cell. Partial or unreadable search records are regressions — the
    factory/perf/fleet-scale discipline."""
    out: dict = {"search_partial": []}
    sp = se.get("speedup")
    if not isinstance(sp, dict) or sp.get("ratio") is None:
        out["search_partial"].append(
            "missing the traced-vs-recompile-loop speedup pair")
    else:
        out["search_speedup"] = float(sp["ratio"])
    tr = se.get("traced")
    if not isinstance(tr, dict) \
            or tr.get("recompiles_during_swaps") is None:
        out["search_partial"].append(
            "missing the swap-window recompile count")
    else:
        out["search_recompiles"] = int(tr["recompiles_during_swaps"])
    par = se.get("parity")
    if not isinstance(par, dict):
        out["search_partial"].append("no parity section recorded")
    else:
        for key, outk in (("s1_stream_bitwise", "search_s1_stream"),
                          ("s1_summary_bitwise", "search_s1_summary"),
                          ("ncell_allclose", "search_ncell_allclose")):
            if par.get(key) is None:
                out["search_partial"].append(
                    f"missing the parity {key} flag")
            else:
                out[outk] = bool(par[key])
    srch = se.get("search")
    minted = (srch or {}).get("minted") if isinstance(srch, dict) else None
    if not isinstance(srch, dict) or not isinstance(minted, dict) \
            or minted.get("value") is None \
            or srch.get("hand_worst") is None \
            or srch.get("dominates") is None:
        out["search_partial"].append(
            "missing the minted-vs-hand-named dominance evidence")
    else:
        out["search_dominates"] = bool(srch["dominates"])
        # Numeric cross-check where the sign is unambiguous (every
        # objective but slo_attainment degrades UPWARD): a record whose
        # flag says "dominates" while its own numbers say otherwise is
        # doctored or corrupt.
        if srch.get("objective") != "slo_attainment" \
                and out["search_dominates"] \
                and not minted["value"] > srch["hand_worst"]:
            out["search_dominates"] = False
            out["search_partial"].append(
                "dominance flag contradicts the record's own minted/"
                "hand_worst numbers")
    return out


def _extract_flywheel(fl: dict) -> dict:
    """The round-23 flywheel invariants a record states about itself:
    every recorded promotion carries PASSING
    gate evidence (a promoted generation with missing/failed gates is
    how an ungated swap would look), the paired mean $/SLO-hr ratio on
    the mined weakness cells is strictly < 1, no workload class
    regressed beyond the class tolerance, the provenance/rollback/
    determinism flags are PRESENT and true (absent is partial, not
    green — the factory/search discipline)."""
    out: dict = {"flywheel_partial": [], "flywheel_bad_promotions": [],
                 "flywheel_class_regressions": []}
    gens = fl.get("generations")
    if not isinstance(gens, list) or not gens:
        out["flywheel_partial"].append("no generation records")
        gens = []
    out["flywheel_promotions"] = int(fl.get("promotions") or 0)
    for g in gens:
        if not isinstance(g, dict):
            out["flywheel_partial"].append("malformed generation row")
            continue
        tag = f"gen-{g.get('generation', '?')}"
        if g.get("promoted"):
            gates = g.get("gates")
            ratio = g.get("mean_ratio")
            if not g.get("eligible") or not isinstance(gates, dict) \
                    or not gates or not all(gates.values()):
                out["flywheel_bad_promotions"].append(
                    f"{tag} promoted without passing gate evidence")
            if not isinstance(ratio, (int, float)) or ratio >= 1.0:
                out["flywheel_bad_promotions"].append(
                    f"{tag} promoted without a strict paired $/SLO-hr "
                    f"improvement on its mined cells (ratio {ratio})")
        worst = g.get("worst_class_rel_delta")
        if isinstance(worst, dict):
            for cls, v in sorted(worst.items()):
                if isinstance(v, (int, float)) \
                        and v > _FLYWHEEL_CLASS_TOL:
                    out["flywheel_class_regressions"].append(
                        f"{tag} regressed workload class {cls} by "
                        f"{v:+.4f} (tolerance {_FLYWHEEL_CLASS_TOL})")
        elif g.get("promoted"):
            out["flywheel_partial"].append(
                f"{tag} promoted without per-class regression deltas")
    for key, outk in (("provenance_ok", "flywheel_provenance_ok"),
                      ("rollback_ok", "flywheel_rollback_ok"),
                      ("deterministic_ok", "flywheel_deterministic_ok"),
                      ("flywheel_gate_ok", "flywheel_gate_ok")):
        if fl.get(key) is None:
            out["flywheel_partial"].append(f"missing the {key} flag")
        else:
            out[outk] = bool(fl[key])
    return out


# Round-22 traced scenario-axis gate: the acceptance floor on
# traced-axis scenario-cells/sec over the per-config recompile loop.
_SEARCH_SPEEDUP_FLOOR = 10.0

# Round-23 flywheel gate: per-workload-class relative regression
# tolerance a promoted challenger must stay inside (stdlib mirror of
# train/flywheel.CLASS_TOLERANCE — this module must run jax-free).
_FLYWHEEL_CLASS_TOL = 0.05

# A single-core virtual host cannot overlap generation with the kernel
# (there is no second core to run it on): its pipelined drive is held
# to this non-regression floor instead of the >= 1.0 overlap gate.
_STREAM_RATIO_FLOOR = 0.85

# Round-21 fleet-scale gates: the record's headline speedup floor
# and the full-stage tenant-count the title
# claims; per-tenant p99 may wobble between container generations but
# must FALL with N beyond this slack.
_FLEET_SPEEDUP_FLOOR = 10.0
_FLEET_MAX_N = 10240
_FLEET_P99_PER_TENANT_SLACK = 1.25
_FLEET_P99_MIN_N = 256

# Plausibility bound on the factory's student-vs-teacher $/SLO-hr
# ratio: a paired ratio orders of magnitude off means a broken pairing
# or a corrupt record, not a bad student.
_FACTORY_STUDENT_RATIO_MAX = 100.0


def bench_diff(history: dict, *,
               max_lane_slowdown: float = 1.5,
               lane_budget_s: float = _LANE_BUDGET_S,
               max_headline_drop: float = 0.5,
               max_healthy_ratio: float = 1.05,
               max_recorder_overhead: float = 0.05,
               max_achieved_fraction: float = 1.25,
               max_occupancy_sum_err: float = 0.02,
               max_perf_overhead: float = 0.05,
               max_share_err: float = 0.02) -> dict:
    """Diff the history; returns {"comparisons": [...], "regressions":
    [...], "ok": bool}. Empty regressions = exit 0 for the CLI.

    ``max_lane_slowdown`` is deliberately loose (1.5x): it exists to
    catch STRUCTURAL regressions (a new test doubling the lane), not
    host-speed noise between container generations — the budget gate
    is the hard wall."""
    comparisons: list[dict] = []
    regressions: list[dict] = []

    # Unreadable records are themselves a regression: a sentinel that
    # shrugs at a corrupt history would pass exactly when it matters.
    for rec in history.get("records", []):
        if "error" in rec:
            regressions.append({
                "kind": "unreadable_record", "round": rec["round"],
                "detail": rec["error"]})

    # Lane trend + budget gates: consecutive rounds WITHIN each
    # platform's own series (zipping the mixed list and skipping
    # cross-platform pairs would silently drop genuine same-platform
    # comparisons whenever platforms interleave — e.g. one TPU round
    # between two CPU rounds would disconnect the CPU trend).
    lane = [r for r in history.get("lane", []) if r.get("round")]
    by_platform: dict[str, list] = {}
    for r in lane:
        by_platform.setdefault(r["platform"], []).append(r)
    for series in by_platform.values():
        for prev, cur in zip(series, series[1:]):
            ratio = cur["best_wall_s"] / max(prev["best_wall_s"], 1e-9)
            comp = {"kind": "lane_wall_s",
                    "platform": cur["platform"],
                    "rounds": [prev["round"], cur["round"]],
                    "prev": prev["best_wall_s"],
                    "cur": cur["best_wall_s"],
                    "ratio": round(ratio, 3)}
            comparisons.append(comp)
            if ratio > max_lane_slowdown:
                regressions.append(dict(
                    comp, threshold=max_lane_slowdown,
                    detail="tier-1 lane slowed past the trend gate"))
    for r in lane:
        # The row's own over_budget stamp (written by the conftest
        # hook against the AUTHORITATIVE budget) decides; a numeric
        # fallback covers hook-era rows that somehow lost the stamp.
        # Rows predating BOTH the hook and the budget (the hand-seeded
        # r5 TPU row, 1050s on a pre-budget round) are in the series
        # but not budget-gated: judging them against a budget that did
        # not exist would fail the real history retroactively.
        budget = r.get("budget_s") or lane_budget_s
        if r["best_over_budget"] or (
                not r["passed_unknown"] and r["best_wall_s"] > budget):
            regressions.append({
                "kind": "lane_over_budget", "round": r["round"],
                "best_wall_s": r["best_wall_s"],
                "budget_s": budget,
                "detail": "the round's BEST complete lane run exceeds "
                          "the pinned budget — mark duplicative tests "
                          "slow (ROADMAP lane-time rule)"})

    # Headline trend: same grouping discipline — consecutive records
    # within each platform's own series.
    heads_by_platform: dict[str, list] = {}
    for r in history.get("records", []):
        if "headline_cluster_days_per_sec" in r:
            heads_by_platform.setdefault(
                r.get("platform", "?"), []).append(r)
    for series in heads_by_platform.values():
        for prev, cur in zip(series, series[1:]):
            ratio = (cur["headline_cluster_days_per_sec"]
                     / max(prev["headline_cluster_days_per_sec"], 1e-9))
            comp = {"kind": "headline",
                    "platform": cur.get("platform", "?"),
                    "rounds": [prev["round"], cur["round"]],
                    "prev": prev["headline_cluster_days_per_sec"],
                    "cur": cur["headline_cluster_days_per_sec"],
                    "ratio": round(ratio, 3)}
            comparisons.append(comp)
            if ratio < 1.0 - max_headline_drop:
                regressions.append(dict(
                    comp, threshold=1.0 - max_headline_drop,
                    detail="throughput headline dropped past the gate"))

    # Invariant gates: absolute bounds the records state about
    # themselves — these ARE the acceptance criteria of their rounds,
    # so a later record violating one is a regression by definition.
    for rec in history.get("records", []):
        rnd = rec["round"]
        if rec.get("duplicate_patches_total", 0) != 0 \
                or rec.get("lost_patches_total", 0) != 0:
            regressions.append({
                "kind": "recovery_invariant", "round": rnd,
                "detail": "duplicate/lost patches non-zero"})
        if rec.get("resume_bitwise_frac", 1.0) != 1.0:
            regressions.append({
                "kind": "recovery_invariant", "round": rnd,
                "detail": "resume no longer bitwise"})
        if rec.get("healthy_usd_ratio_max", 0.0) > max_healthy_ratio:
            regressions.append({
                "kind": "overload_invariant", "round": rnd,
                "value": rec["healthy_usd_ratio_max"],
                "threshold": max_healthy_ratio,
                "detail": "healthy-tenant isolation ratio exceeded"})
        if rec.get("recorder_overhead_frac", 0.0) > max_recorder_overhead:
            regressions.append({
                "kind": "obs_invariant", "round": rnd,
                "value": rec["recorder_overhead_frac"],
                "threshold": max_recorder_overhead,
                "detail": "flight-recorder overhead exceeded the "
                          "5%-of-p50 bound"})
        if rec.get("obs_bitwise_identical") is False:
            regressions.append({
                "kind": "obs_invariant", "round": rnd,
                "detail": "recorder-on/off runs no longer bitwise"})
        # Round-15 device-time observatory invariants: achieved
        # roofline fractions must be physically plausible, occupancy
        # fractions must account for the measured pipeline, shard
        # imbalance is >= 1 by definition, and the observatory must
        # neither steer decisions nor cost more than its budget. A
        # PARTIAL record (a declared mode with no occupancy or no
        # attribution) is itself a regression — the measurement
        # substrate existing is the round's acceptance criterion.
        for what in rec.get("perf_partial", []):
            regressions.append({
                "kind": "perf_invariant", "round": rnd,
                "detail": f"partial perf record: {what}"})
        for mode, frac in rec.get("perf_achieved", {}).items():
            if not 0.0 < frac <= max_achieved_fraction:
                regressions.append({
                    "kind": "perf_invariant", "round": rnd,
                    "mode": mode, "value": frac,
                    "threshold": max_achieved_fraction,
                    "detail": "achieved roofline fraction outside "
                              f"(0, {max_achieved_fraction}] — the byte "
                              "count or bandwidth probe is wrong"})
        for mode, total in rec.get("perf_occupancy_sum", {}).items():
            if abs(total - 1.0) > max_occupancy_sum_err:
                regressions.append({
                    "kind": "perf_invariant", "round": rnd,
                    "mode": mode, "value": total,
                    "threshold": max_occupancy_sum_err,
                    "detail": "occupancy fractions do not sum to ~1 — "
                              "a stage went unmeasured or the record "
                              "is corrupt"})
        if rec.get("perf_imbalance") is not None \
                and rec["perf_imbalance"] < 1.0 - 1e-6:
            regressions.append({
                "kind": "perf_invariant", "round": rnd,
                "value": rec["perf_imbalance"],
                "detail": "shard imbalance below 1 (max/mean cannot "
                          "be) — the record is corrupt"})
        if rec.get("perf_bitwise_all") is False:
            regressions.append({
                "kind": "perf_invariant", "round": rnd,
                "detail": "observatory-on/off decision streams no "
                          "longer bitwise identical"})
        if rec.get("perf_overhead_frac", 0.0) > max_perf_overhead:
            regressions.append({
                "kind": "perf_invariant", "round": rnd,
                "value": rec["perf_overhead_frac"],
                "threshold": max_perf_overhead,
                "detail": "observatory measurement overhead exceeded "
                          "the 5%-of-kernel-stage bound"})
        # Round-16 streaming-pipeline invariants: bitwise
        # gates are unconditional; the throughput/occupancy gates hold
        # at >= 1.0 (and pipelined kernel occupancy >= sync) only when
        # the host could physically overlap — a single-core virtual
        # host is held to the non-regression floor.
        for what in rec.get("stream_partial", []):
            regressions.append({
                "kind": "stream_invariant", "round": rnd,
                "detail": f"partial streaming record: {what}"})
        if rec.get("stream_bitwise_all") is False:
            regressions.append({
                "kind": "stream_invariant", "round": rnd,
                "detail": "blocked/pipelined/sync streaming summaries "
                          "no longer bitwise identical"})
        if rec.get("stream_buffers_max", 0) > 2:
            regressions.append({
                "kind": "stream_invariant", "round": rnd,
                "value": rec["stream_buffers_max"],
                "detail": "streaming donation chain held more than the "
                          "two stream buffers per chip it promises"})
        ratio = rec.get("stream_ratio_best")
        if ratio is not None:
            capable = rec.get("stream_overlap_capable", True)
            floor = 1.0 if capable else _STREAM_RATIO_FLOOR
            if ratio < floor:
                regressions.append({
                    "kind": "stream_invariant", "round": rnd,
                    "value": ratio, "threshold": floor,
                    "detail": ("double-buffered drive slower than the "
                               "synchronous baseline"
                               + ("" if capable else
                                  " past the single-core floor"))})
        if rec.get("stream_kocc_pipelined") is not None \
                and rec.get("stream_overlap_capable", True) \
                and rec["stream_kocc_pipelined"] \
                < rec.get("stream_kocc_sync", 0.0):
            regressions.append({
                "kind": "stream_invariant", "round": rnd,
                "value": rec["stream_kocc_pipelined"],
                "threshold": rec.get("stream_kocc_sync"),
                "detail": "pipelined kernel-stage occupancy fell below "
                          "the synchronous baseline's"})
        # Round-17 distillation-factory invariants: the
        # paired throughput ratio must exist and hold >= 1.0 (a factory
        # slower than the per-pair loop it replaces is a regression by
        # definition — the >= 5x number is the round's headline, not a
        # standing gate: future hosts may be slower without the CODE
        # having regressed), the student-vs-teacher column must be
        # plausible, and partial records are regressions.
        for what in rec.get("factory_partial", []):
            regressions.append({
                "kind": "factory_invariant", "round": rnd,
                "detail": f"partial factory record: {what}"})
        if rec.get("factory_ratio") is not None \
                and rec["factory_ratio"] < 1.0:
            regressions.append({
                "kind": "factory_invariant", "round": rnd,
                "value": rec["factory_ratio"], "threshold": 1.0,
                "detail": "factory throughput fell below the naive "
                          "per-pair lax loop it exists to replace"})
        st = rec.get("factory_student_teacher")
        if st is not None and not 0.0 < st <= _FACTORY_STUDENT_RATIO_MAX:
            regressions.append({
                "kind": "factory_invariant", "round": rnd,
                "value": st,
                "threshold": _FACTORY_STUDENT_RATIO_MAX,
                "detail": "student-vs-teacher $/SLO-hr ratio outside "
                          "the plausible band — broken pairing or a "
                          "corrupt record"})
        # Round-18 decision-provenance invariants: the
        # ledger must neither steer (bitwise) nor overspend (5% of
        # p50), attribution must account for the whole objective on
        # every row, and a divergence spike must be attributable to
        # its checksummed dump. Partial records are regressions.
        for what in rec.get("decisions_partial", []):
            regressions.append({
                "kind": "decisions_invariant", "round": rnd,
                "detail": f"partial decision record: {what}"})
        if rec.get("decisions_bitwise") is False:
            regressions.append({
                "kind": "decisions_invariant", "round": rnd,
                "detail": "ledger-on/off decision+patch streams no "
                          "longer bitwise identical"})
        if rec.get("decisions_overhead_frac", 0.0) \
                > max_recorder_overhead:
            regressions.append({
                "kind": "decisions_invariant", "round": rnd,
                "value": rec["decisions_overhead_frac"],
                "threshold": max_recorder_overhead,
                "detail": "decision-ledger overhead exceeded the "
                          "5%-of-p50 bound"})
        if rec.get("decisions_share_err", 0.0) > max_share_err:
            regressions.append({
                "kind": "decisions_invariant", "round": rnd,
                "value": rec["decisions_share_err"],
                "threshold": max_share_err,
                "detail": "objective-term shares no longer sum to ~1 "
                          "on every recorded row — a term went "
                          "unattributed or the record is corrupt"})
        if rec.get("decisions_divergence_dumps_ok") is False:
            regressions.append({
                "kind": "decisions_invariant", "round": rnd,
                "value": rec.get("decisions_divergence_incidents"),
                "detail": "policy_divergence incidents no longer "
                          "attributable 1:1 to verified recorder "
                          "dumps (or none fired on the divergent "
                          "backend)"})
        # Round-19 geo-arbitrage invariants: zero-rate
        # migration must be a bitwise no-op, recorded fronts must be
        # mutually non-dominated, migration mass must conserve within
        # the record's own pinned gate, and the migration term must be
        # attributed in the ledger with shares still ~1. Partial
        # records are regressions.
        for what in rec.get("geo_partial", []):
            regressions.append({
                "kind": "geo_invariant", "round": rnd,
                "detail": f"partial geo record: {what}"})
        if rec.get("geo_zero_migration_parity") is False:
            regressions.append({
                "kind": "geo_invariant", "round": rnd,
                "detail": "zero-rate migration no longer bitwise "
                          "identical to the pre-geo multiregion "
                          "rollout"})
        for what in rec.get("geo_front_violations", []):
            regressions.append({
                "kind": "geo_invariant", "round": rnd,
                "detail": f"dominated Pareto front: {what}"})
        if rec.get("geo_conservation_ok") is False:
            regressions.append({
                "kind": "geo_invariant", "round": rnd,
                "value": rec.get("geo_conservation_residual"),
                "detail": "migration mass no longer conserved within "
                          "the record's pinned residual gate — pods "
                          "created or destroyed in transit"})
        if rec.get("geo_migration_term_present") is False:
            regressions.append({
                "kind": "geo_invariant", "round": rnd,
                "detail": "migration term absent from the decision "
                          "ledger's attribution rows"})
        if rec.get("geo_share_err", 0.0) > max_share_err:
            regressions.append({
                "kind": "geo_invariant", "round": rnd,
                "value": rec["geo_share_err"],
                "threshold": max_share_err,
                "detail": "objective-term shares (with the migration "
                          "term) no longer sum to ~1 on the geo "
                          "ledger rows"})
        # Round-20 shadow-tournament invariants: the
        # tournament must neither steer (bitwise) nor overspend (the
        # same 5%-of-p50 bound, at the record's K=4 roster), the board
        # must cover the roster 1:1 with every win rate in [0,1], and
        # the seeded challenger scenario must hold its exactly-one-
        # incident contract with verified dump + signed audits.
        # Partial records are regressions.
        for what in rec.get("tournament_partial", []):
            regressions.append({
                "kind": "tournament_invariant", "round": rnd,
                "detail": f"partial tournament record: {what}"})
        if rec.get("tournament_bitwise") is False:
            regressions.append({
                "kind": "tournament_invariant", "round": rnd,
                "detail": "tournament-on/off decision+patch streams "
                          "no longer bitwise identical"})
        if rec.get("tournament_overhead_frac", 0.0) \
                > max_recorder_overhead:
            regressions.append({
                "kind": "tournament_invariant", "round": rnd,
                "value": rec["tournament_overhead_frac"],
                "threshold": max_recorder_overhead,
                "detail": "tournament win-ledger overhead exceeded "
                          "the 5%-of-p50 bound at the record's K"})
        if rec.get("tournament_board_matches_roster") is False:
            regressions.append({
                "kind": "tournament_invariant", "round": rnd,
                "detail": "board rows no longer 1:1 with the roster "
                          "the record names — a candidate went "
                          "unscored or a phantom row appeared"})
        for what in rec.get("tournament_rate_violations", []):
            regressions.append({
                "kind": "tournament_invariant", "round": rnd,
                "detail": f"implausible win rate: {what}"})
        if rec.get("tournament_challenger_ok") is False:
            regressions.append({
                "kind": "tournament_invariant", "round": rnd,
                "detail": "the seeded challenger scenario no longer "
                          "yields exactly one challenger_sustained_win "
                          "with a verified dump and HMAC-valid "
                          "promotion audits"})

        # Round-21 fleet-scale invariants: the vectorized
        # host loop must stay bitwise the object loop (and chunked
        # dispatch bitwise unchunked), the N=4096 speedup must hold
        # its >=10x floor, the paired healthy-tenant ratio must be
        # EXACTLY 1.0 in every cell, and per-tenant p99 must fall as
        # the fleet grows. Partial records are regressions.
        for what in rec.get("fleet_scale_partial", []):
            regressions.append({
                "kind": "fleet_scale_invariant", "round": rnd,
                "detail": f"partial fleet-scale record: {what}"})
        if rec.get("fleet_scale_parity") is False:
            regressions.append({
                "kind": "fleet_scale_invariant", "round": rnd,
                "detail": "vectorized host loop no longer bitwise the "
                          "object loop (decisions, patch streams, or "
                          "report counters diverged)"})
        if rec.get("fleet_scale_chunk_parity") is False:
            regressions.append({
                "kind": "fleet_scale_invariant", "round": rnd,
                "detail": "chunked tenant-axis dispatch no longer "
                          "bitwise the unchunked dispatch"})
        if rec.get("fleet_scale_speedup", _FLEET_SPEEDUP_FLOOR) \
                < _FLEET_SPEEDUP_FLOOR:
            regressions.append({
                "kind": "fleet_scale_invariant", "round": rnd,
                "value": rec["fleet_scale_speedup"],
                "threshold": _FLEET_SPEEDUP_FLOOR,
                "detail": "vectorized-vs-object host-loop speedup "
                          "fell below the 10x record floor"})
        if rec.get("fleet_scale_healthy_exact") is False:
            regressions.append({
                "kind": "fleet_scale_invariant", "round": rnd,
                "detail": "paired healthy-tenant $/SLO-hr ratio no "
                          "longer EXACTLY 1.0 in every fleet-scale "
                          "cell — bulkhead isolation leaked at scale"})
        for what in rec.get("fleet_scale_p99_violations", []):
            regressions.append({
                "kind": "fleet_scale_invariant", "round": rnd,
                "detail": what})

        # Round-22 traced scenario-axis invariants: the
        # >=10x traced-vs-recompile-loop speedup, zero recompiles
        # across set_params swaps, S=1 bitwise parity flags true, the
        # N-cell allclose cross-check, and the minted worst case
        # strictly beating the hand-named library. Partial records are
        # regressions.
        for what in rec.get("search_partial", []):
            regressions.append({
                "kind": "search_invariant", "round": rnd,
                "detail": f"partial scenario-search record: {what}"})
        if rec.get("search_speedup", _SEARCH_SPEEDUP_FLOOR) \
                < _SEARCH_SPEEDUP_FLOOR:
            regressions.append({
                "kind": "search_invariant", "round": rnd,
                "value": rec["search_speedup"],
                "threshold": _SEARCH_SPEEDUP_FLOOR,
                "detail": "traced-axis scenario-cells/sec fell below "
                          "10x the per-config recompile loop"})
        if rec.get("search_recompiles", 0) != 0:
            regressions.append({
                "kind": "search_invariant", "round": rnd,
                "value": rec["search_recompiles"],
                "detail": "the timed set_params swap window recompiled "
                          "— scenario params leaked back into "
                          "compile-time config"})
        if rec.get("search_s1_stream") is False:
            regressions.append({
                "kind": "search_invariant", "round": rnd,
                "detail": "S=1 traced stream no longer bitwise the "
                          "config-baked generation path"})
        if rec.get("search_s1_summary") is False:
            regressions.append({
                "kind": "search_invariant", "round": rnd,
                "detail": "S=1 traced kernel summary no longer bitwise "
                          "the config-baked path's"})
        if rec.get("search_ncell_allclose") is False:
            regressions.append({
                "kind": "search_invariant", "round": rnd,
                "detail": "N-cell traced batch diverged from the "
                          "per-config loop beyond ulp tolerance"})
        if rec.get("search_dominates") is False:
            regressions.append({
                "kind": "search_invariant", "round": rnd,
                "detail": "minted worst case no longer strictly "
                          "exceeds the policy's worst hand-named "
                          "scenario cell"})

        # Round-23 continual-learning flywheel invariants: a promotion
        # recorded without passing gate evidence, a missing/partial
        # provenance record, a workload class regressed beyond
        # tolerance, a broken rollback or a non-deterministic seeded
        # rerun. Partial records are regressions.
        for what in rec.get("flywheel_partial", []):
            regressions.append({
                "kind": "flywheel_invariant", "round": rnd,
                "detail": f"partial flywheel record: {what}"})
        for what in rec.get("flywheel_bad_promotions", []):
            regressions.append({
                "kind": "flywheel_invariant", "round": rnd,
                "detail": what})
        for what in rec.get("flywheel_class_regressions", []):
            regressions.append({
                "kind": "flywheel_invariant", "round": rnd,
                "detail": what})
        if rec.get("flywheel_gate_ok") is False:
            regressions.append({
                "kind": "flywheel_invariant", "round": rnd,
                "detail": "the flywheel gate battery no longer passes "
                          "on the recorded generations"})
        if rec.get("flywheel_provenance_ok") is False:
            regressions.append({
                "kind": "flywheel_invariant", "round": rnd,
                "detail": "a generation's checksummed provenance "
                          "record failed verification"})
        if rec.get("flywheel_rollback_ok") is False:
            regressions.append({
                "kind": "flywheel_invariant", "round": rnd,
                "detail": "post-promotion divergence rollback did not "
                          "restore the parent checkpoint bitwise"})
        if rec.get("flywheel_deterministic_ok") is False:
            regressions.append({
                "kind": "flywheel_invariant", "round": rnd,
                "detail": "the seeded flywheel rerun no longer "
                          "reproduces the same curriculum and "
                          "checkpoint digests"})
    return {"comparisons": comparisons, "regressions": regressions,
            "ok": not regressions}


# ---- the weak-scaling curve artifact (ROADMAP item 1) ---------------------


_MULTI_RE = re.compile(r"MULTICHIP_r(\d+)\.json$")

# CSV column order for write_scaling_csv — one row per measured (or
# legacy-skipped) multichip point plus the per-round headline rows.
SCALING_CSV_COLUMNS = (
    "round", "file", "source", "platform", "virtual", "devices",
    "per_device_batch", "steps", "cluster_days_per_sec_per_device",
    "cluster_days_per_sec_aggregate", "weak_scaling_efficiency",
    "pipeline", "engine", "note",
)


def _multichip_points(rnd: int, fname: str, section: dict) -> list[dict]:
    rows = []
    prov = section.get("provenance") or {}
    base = {
        "round": rnd, "file": fname, "source": "multichip",
        "platform": section.get("platform") or prov.get("platform"),
        "virtual": bool(section.get("virtual_cpu_mesh",
                                    section.get("virtual", False))),
        "steps": section.get("steps"),
        "engine": section.get("engine"),
    }
    for _key, r in sorted((section.get("weak_scaling") or {}).items()):
        rows.append(dict(
            base, devices=r.get("devices"),
            per_device_batch=r.get("per_device_batch"),
            cluster_days_per_sec_per_device=r.get(
                "cluster_days_per_sec_per_device"),
            cluster_days_per_sec_aggregate=r.get(
                "cluster_days_per_sec_aggregate"),
            weak_scaling_efficiency=r.get("weak_scaling_efficiency")))
    pb = section.get("plan_playback")
    if isinstance(pb, dict):
        rows.append(dict(
            base, source="multichip_plan_playback",
            engine=pb.get("engine", base["engine"]),
            devices=pb.get("devices"),
            per_device_batch=pb.get("per_device_batch"),
            steps=pb.get("steps", base["steps"]),
            cluster_days_per_sec_per_device=pb.get(
                "cluster_days_per_sec_per_device"),
            cluster_days_per_sec_aggregate=pb.get(
                "cluster_days_per_sec_aggregate")))
    return rows


def _stream_points(rnd: int, fname: str, stream: dict) -> list[dict]:
    """Round-16 streaming rows as curve points — BLOCKED rows labeled
    (the ``pipeline`` column distinguishes the synchronous baseline
    from the double-buffered drive on every paired sweep row), never
    skipped: a curve that hid the sync side would hide exactly the
    comparison the streaming record exists to make."""
    base = {
        "round": rnd, "file": fname,
        "platform": stream.get("platform"),
        "virtual": bool(stream.get("virtual", False)),
    }
    points = []
    for row in stream.get("rows", []):
        if not isinstance(row, dict):
            continue
        for pipeline, side in (("sync", row.get("sync")),
                               ("double-buffered",
                                row.get("pipelined"))):
            if not isinstance(side, dict):
                continue
            points.append(dict(
                base, source="stream_single_chip", devices=1,
                per_device_batch=row.get("batch"),
                steps=row.get("steps"), pipeline=pipeline,
                engine=side.get("engine"),
                cluster_days_per_sec_per_device=side.get(
                    "cluster_days_per_sec"),
                cluster_days_per_sec_aggregate=side.get(
                    "cluster_days_per_sec")))
    mesh = stream.get("mesh8")
    if isinstance(mesh, dict):
        for pipeline, side in (("sync", mesh.get("sync")),
                               ("double-buffered",
                                mesh.get("pipelined"))):
            if not isinstance(side, dict):
                continue
            agg = side.get("cluster_days_per_sec_aggregate")
            n = mesh.get("shards") or 8
            points.append(dict(
                base, source="stream_mesh", devices=n,
                platform=mesh.get("platform", base["platform"]),
                virtual=bool(mesh.get("virtual", base["virtual"])),
                per_device_batch=mesh.get("per_shard_batch"),
                steps=mesh.get("steps"), pipeline=pipeline,
                engine=mesh.get("engine"),
                cluster_days_per_sec_per_device=(
                    round(agg / n, 2) if agg else None),
                cluster_days_per_sec_aggregate=agg))
    chunked = stream.get("chunked")
    if isinstance(chunked, dict):
        points.append(dict(
            base, source="stream_chunked", devices=1,
            per_device_batch=chunked.get("batch"),
            steps=chunked.get("steps"), pipeline="double-buffered",
            engine=chunked.get("engine"),
            cluster_days_per_sec_per_device=chunked.get(
                "cluster_days_per_sec_aggregate"),
            cluster_days_per_sec_aggregate=chunked.get(
                "cluster_days_per_sec_aggregate"),
            note=(f"{chunked.get('chunks')} chunks x "
                  f"{chunked.get('chunk')} clusters, "
                  f"{chunked.get('live_block_mib')} MiB live blocks")))
    return points


def _factory_points(rnd: int, fname: str, fac: dict) -> list[dict]:
    """Round-17 factory-throughput rows as curve points: each cell's
    plan-playback rate (the labeling engine IS the streaming plan
    kernel, so these extend the playback series), with the pairs/sec
    and the paired naive-loop baseline in the note — labeled, never
    folded into the kernel-only series."""
    base = {
        "round": rnd, "file": fname, "source": "factory_playback",
        "platform": fac.get("platform"),
        "virtual": bool(fac.get("virtual", False)),
        "devices": 1, "pipeline": "factory double-buffered playback",
        "engine": fac.get("engine"),
    }
    points = []
    for cell in fac.get("cells", []):
        if not isinstance(cell, dict):
            continue
        points.append(dict(
            base,
            per_device_batch=cell.get("pairs"),
            steps=cell.get("steps"),
            cluster_days_per_sec_per_device=cell.get(
                "playback_cluster_days_per_sec"),
            cluster_days_per_sec_aggregate=cell.get(
                "playback_cluster_days_per_sec"),
            note=(f"{cell.get('scenario')}.{cell.get('intensity')}: "
                  f"{cell.get('pairs_per_sec')} pairs/s "
                  f"(naive baseline "
                  f"{(fac.get('baseline') or {}).get('pairs_per_sec')}"
                  f" pairs/s)")))
    return points


def _fleet_scale_points(rnd: int, fname: str, fs: dict) -> list[dict]:
    """Round-21 fleet-scale cells as curve points on a TENANT axis:
    ``per_device_batch`` carries the tenant count (the host loop's
    scaling dimension — one device, N tenants), the rate columns stay
    empty (a tail-latency record has no cluster-days/sec), and the
    note carries the numbers the curve is about: p99 tick latency,
    host-loop µs/tenant, sheds. The CLI's note fallback renders these
    rows; they are never folded into the kernel-rate series."""
    prov = fs.get("provenance") or {}
    base = {
        "round": rnd, "file": fname, "source": "fleet_scale",
        "platform": prov.get("platform"), "virtual": False,
        "devices": 1,
        "pipeline": "vectorized host loop (chunked tenant-axis "
                    "dispatch)",
        "engine": fs.get("engine"),
    }
    points = []
    for key, cell in sorted(fs.get("cells", {}).items()):
        if not isinstance(cell, dict):
            continue
        lat = cell.get("latency_ms") or {}
        chunk = cell.get("dispatch_chunk")
        points.append(dict(
            base,
            per_device_batch=cell.get("n_tenants"),
            steps=fs.get("ticks_per_run"),
            note=(f"{key}: p99 {lat.get('p99')}ms "
                  f"(max {lat.get('max')}ms), "
                  f"{cell.get('host_loop_us_per_tenant')}us/tenant, "
                  f"shed {cell.get('sheds_total')}"
                  + (f", chunk {chunk}" if chunk else ""))))
    sp = fs.get("speedup")
    if isinstance(sp, dict) and sp.get("ratio") is not None:
        points.append(dict(
            base,
            per_device_batch=sp.get("n_tenants"),
            steps=sp.get("ticks"),
            note=(f"speedup: object "
                  f"{sp.get('object_us_per_tenant')}us/tenant vs "
                  f"vectorized {sp.get('vectorized_us_per_tenant')}"
                  f"us/tenant -> {sp.get('ratio')}x")))
    return points


def scaling_curve(root: str) -> dict:
    """The measured multichip record as ONE weak-scaling series:
    {"points": [...], "per_round": [...]}.

    Points come from every BENCH_r*.json multichip section (the r08+
    weak-scaling sweeps and plan-playback rows, whether the record is a
    stage record or a full sweep) plus the legacy MULTICHIP_r0x run
    wrappers (rounds 1–5 recorded only a skip marker — included as
    explicitly-skipped rows, because a curve that silently starts at
    round 8 would hide that the first five rounds measured nothing).
    The per-round table is cluster-days/sec-per-chip per round from the
    headline records and the round-15 perf stage's single-chip row,
    platform-labeled so a CPU row can never masquerade as a TPU one."""
    points: list[dict] = []
    per_round: list[dict] = []
    for path in sorted(glob.glob(os.path.join(root, "MULTICHIP_r*.json"))):
        m = _MULTI_RE.search(os.path.basename(path))
        if not m:
            continue
        rnd = int(m.group(1))
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            points.append({"round": rnd,
                           "file": os.path.basename(path),
                           "source": "multichip_legacy",
                           "note": f"unreadable: {e}"})
            continue
        points.append({
            "round": rnd, "file": os.path.basename(path),
            "source": "multichip_legacy",
            "devices": doc.get("n_devices"),
            "note": ("driver wrapper, stage skipped — no measured rate"
                     if doc.get("skipped") else "driver wrapper"),
        })
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        m = _ROUND_RE.search(os.path.basename(path))
        if not m:
            continue
        rnd = int(m.group(1))
        fname = os.path.basename(path)
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue  # load_bench_history already reports unreadables
        section = doc.get("multichip")
        if isinstance(section, dict):
            points.extend(_multichip_points(rnd, fname, section))
        pb9 = doc.get("multichip_plan_playback")
        if isinstance(pb9, dict):
            # The r09 stage record nests the row under "row" with mesh/
            # provenance beside it; later records inline the row.
            row = pb9.get("row") if isinstance(pb9.get("row"), dict) \
                else pb9
            points.extend(_multichip_points(
                rnd, fname,
                {"plan_playback": row,
                 "virtual": pb9.get("virtual_cpu_mesh", False),
                 "steps": row.get("steps"),
                 "platform": (pb9.get("provenance") or {})
                 .get("platform")}))
        prov = doc.get("provenance") or {}
        # Same legacy unwrap as _extract_metrics: the r01–r05 wrappers
        # nest the headline under "parsed".
        head = doc
        platform = prov.get("platform")
        if doc.get("metric") != "sim_cluster_days_per_sec_per_chip" \
                and isinstance(doc.get("parsed"), dict):
            head = doc["parsed"]
            dev = head.get("device")
            if platform is None and isinstance(dev, str) and "/" in dev:
                platform = dev.rsplit("/", 1)[1]
        if head.get("metric") == "sim_cluster_days_per_sec_per_chip" \
                and isinstance(head.get("value"), (int, float)):
            per_round.append({
                "round": rnd, "file": fname, "source": "headline",
                "platform": platform,
                "cluster_days_per_sec_per_chip": float(head["value"]),
                "best_batch": head.get("best_batch"),
                "best_mode": head.get("best_mode"),
            })
        perf = doc if isinstance(doc.get("modes"), dict) \
            else doc.get("perf")
        if isinstance(perf, dict) \
                and isinstance(perf.get("single_chip"), dict):
            sc = perf["single_chip"]
            if isinstance(sc.get("cluster_days_per_sec"), (int, float)):
                per_round.append({
                    "round": rnd, "file": fname,
                    "source": "perf_single_chip",
                    "platform": perf.get("platform"),
                    "virtual": perf.get("virtual"),
                    "cluster_days_per_sec_per_chip": float(
                        sc["cluster_days_per_sec"]),
                    "engine": sc.get("engine"),
                })
        fac = (doc if doc.get("stage") == "--factory-only"
               else doc.get("factory"))
        if isinstance(fac, dict) and isinstance(fac.get("cells"), list):
            points.extend(_factory_points(rnd, fname, fac))
        stream = (doc if doc.get("stage") == "--stream-only"
                  else doc.get("stream"))
        if isinstance(stream, dict) \
                and isinstance(stream.get("rows"), list):
            points.extend(_stream_points(rnd, fname, stream))
            sc = stream.get("single_chip")
            if isinstance(sc, dict) and isinstance(
                    sc.get("cluster_days_per_sec"), (int, float)):
                per_round.append({
                    "round": rnd, "file": fname,
                    "source": "stream_single_chip",
                    "platform": stream.get("platform"),
                    "virtual": stream.get("virtual"),
                    "cluster_days_per_sec_per_chip": float(
                        sc["cluster_days_per_sec"]),
                    "engine": sc.get("engine"),
                })
        fs = (doc if doc.get("stage") == "--fleet-scale-only"
              else doc.get("fleet_scale"))
        if isinstance(fs, dict) and isinstance(fs.get("cells"), dict):
            points.extend(_fleet_scale_points(rnd, fname, fs))
    points.sort(key=lambda r: (r["round"], r.get("devices") or 0,
                               r.get("source", "")))
    per_round.sort(key=lambda r: (r["round"], r["source"]))
    return {"points": points, "per_round": per_round}


def write_scaling_csv(curve: dict, path: str) -> str:
    """The curve as a flat CSV (the publishable artifact): multichip
    points first, then the per-round headline rows with
    ``source=headline``/``perf_single_chip`` and the per-chip rate in
    the per-device column."""
    import csv

    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as fh:
        w = csv.DictWriter(fh, fieldnames=SCALING_CSV_COLUMNS,
                           extrasaction="ignore")
        w.writeheader()
        for row in curve.get("points", []):
            w.writerow(row)
        for row in curve.get("per_round", []):
            w.writerow(dict(
                row, devices=1,
                cluster_days_per_sec_per_device=row.get(
                    "cluster_days_per_sec_per_chip"),
                engine=row.get("engine"),
                note=row.get("best_mode")))
    return path
