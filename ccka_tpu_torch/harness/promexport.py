"""Prometheus exposition of controller telemetry — the missing fabric half.

The PyTorch port's form of `ccka_tpu/harness/promexport.py`: a copy, with the same series names the
dashboards read.

The reference's metrics fabric is scrape -> SigV4 remote-write -> AMP
(`06_opencost.sh:318-341`); the dashboards then query AMP. Round 2 shipped
the dashboards (`harness/dashboard.py`) and a durable JSONL stream
(`harness/telemetry.py`) but nothing *served* the `ccka_*` series the
panels query — on a live stack every panel was empty. This module is
the exposition side:

- :data:`SERIES` — the registry mapping every exported gauge to its
  TickReport field. The dashboard's panel expressions are written against
  exactly this vocabulary; `tests/test_telemetry.py` pins the parity both
  ways, so a panel can never reference an unexported series again.
- :func:`render_exposition` — Prometheus text format 0.0.4 for one tick.
- :class:`MetricsExporter` — holds the latest TickReport and publishes it:
  a `/metrics` HTTP endpoint (daemon thread, stdlib http.server — scrape
  target for any Prometheus/ADOT agent) and/or a node-exporter
  textfile-collector `.prom` file (written atomically each tick).

Gauges-not-counters: each tick fully re-states the fleet's instantaneous
rates (the controller's 30s cadence IS the scrape interval), matching how
kube-state-metrics — the reference's sole scrape target — models cluster
state.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping

# series name -> (TickReport field spec, help text). Booleans export as
# 0/1. A spec may be dotted into the per-phase timing dict the span
# tracer fills (`TickReport.timings_ms`): "timings_ms.a+b" sums the
# named phases, "timings_ms.*" sums them all — see `resolve_field`.
SERIES: dict[str, tuple[str, str]] = {
    "ccka_cost_usd_hr": ("cost_usd_hr", "Estimated fleet spend rate, $/hr"),
    "ccka_carbon_g_hr": ("carbon_g_hr", "Estimated emission rate, gCO2e/hr"),
    "ccka_slo_ok": ("slo_ok", "1 if this tick met the SLO gate, else 0"),
    "ccka_usd_per_kreq": ("usd_per_kreq", "Dollars per 1k served requests"),
    "ccka_g_co2_per_kreq": ("g_co2_per_kreq",
                            "gCO2e per 1k served requests"),
    "ccka_waste_frac": ("waste_frac",
                        "Unused fraction of fleet pod capacity"),
    "ccka_nodes_spot": ("nodes_spot", "Karpenter-owned spot nodes"),
    "ccka_nodes_od": ("nodes_od", "Karpenter-owned on-demand nodes"),
    "ccka_latency_p95_ms": ("latency_p95_ms",
                            "App p95 latency proxy, milliseconds"),
    "ccka_pending_pods": ("pending_pods", "Unschedulable pod backlog"),
    "ccka_is_peak": ("is_peak", "1 during configured peak hours"),
    "ccka_interruption_warnings": (
        "interruption_warnings",
        "Spot interruption/rebalance warnings consumed this tick"),
    "ccka_nodes_drained": (
        "nodes_drained", "Nodes cordoned+drained for interruption warnings"),
    # Degraded-mode + fault-event series (ccka_tpu/faults; ARCHITECTURE
    # §12): the controller's stale-signal state machine and the fault
    # model's provisioning counters, on the wire next to the KPIs they
    # explain. The _total counter is controller-cumulative (each tick
    # re-states the running total, kube-state-metrics style).
    "ccka_degraded": (
        "degraded_level",
        "Degraded-mode level: 0 ok, 1 hold-last-action, 2 rule-fallback"),
    "ccka_degraded_ticks_total": (
        "degraded_ticks_total",
        "Cumulative ticks spent in a degraded mode this session"),
    "ccka_signal_stale": (
        "signal_stale",
        "1 if this tick's signal scrape was stale (retries exhausted)"),
    "ccka_nodes_denied": (
        "denied_nodes",
        "Spot provisioning denied this tick (fault model), nodes"),
    "ccka_nodes_delayed": (
        "delayed_nodes",
        "Provisioning arrivals held back this tick (fault model), nodes"),
    # Workload-family series (ccka_tpu/workloads): the per-family queue
    # estimate and session-cumulative SLO accounting, next to the fleet
    # KPIs they trade against. The _total counters re-state the running
    # total each tick (kube-state-metrics style).
    "ccka_inference_queue_depth": (
        "inference_queue_depth",
        "Inference work queued after this tick (pod-equivalents)"),
    "ccka_inference_slo_violations_total": (
        "inference_slo_violations_total",
        "Cumulative inference SLO-violation ticks this session"),
    "ccka_batch_deadline_misses_total": (
        "batch_deadline_misses_total",
        "Cumulative batch work missing its deadline this session"),
    # Crash-safety series (ARCHITECTURE §14): the reconciler's
    # convergence counters, the actuation failure budget, and the
    # snapshot/resume health of the loop itself. The _total counters are
    # session-cumulative (kube-state-metrics style) and survive
    # snapshot/resume — a resumed controller re-states the dead one's
    # running totals instead of resetting the wire to zero.
    "ccka_reconcile_retries_total": (
        "reconcile_retries_total",
        "Cumulative reconciler re-apply attempts this session"),
    "ccka_reconcile_diverged": (
        "reconcile_diverged",
        "Pools still diverged from intent after this tick's "
        "reconciliation (0 = converged)"),
    "ccka_actuation_failures_total": (
        "actuation_failures_total",
        "Cumulative failed applies + failed read-backs this session"),
    "ccka_snapshot_age_ticks": (
        "snapshot_age_ticks",
        "Ticks since the last durable snapshot write (0 = fresh)"),
    "ccka_resumes_total": (
        "resumes_total",
        "Times this logical run was resumed from a snapshot"),
    # Multi-tenant service series (ARCHITECTURE §15): the
    # overload-control surfaces of `harness/service.py`. These resolve
    # from a ServiceTickReport (the fleet service's per-tick record);
    # single-cluster TickReports skip them. The breaker gauge sums the
    # per-tenant levels (0 closed, 1 half-open, 2 open) via the dotted
    # dict spec, so one number states the fleet's breaker pressure.
    "ccka_tenant_breaker_state": (
        "breaker_states.*",
        "Sum of per-tenant circuit-breaker levels "
        "(0 closed, 1 half-open, 2 open)"),
    "ccka_ticks_shed_total": (
        "sheds_total",
        "Cumulative tenant decides shed by admission backpressure "
        "this session"),
    "ccka_admission_queue_depth": (
        "admission_queue_depth",
        "Tenant decides wanting admission this tick (pre-cap)"),
    "ccka_tick_latency_ms": (
        "tick_latency_ms",
        "Service tick latency (admission+decide+fanout), milliseconds"),
    # Incident-grade obs series (`ccka_tpu/obs`): the SLO
    # burn-rate engine's fast window, the incident-active flag
    # (two-window burn OR a fresh trigger stamp), and the flight
    # recorder's session dump counter. Service-only: the fleet service
    # carries the burn engine; a single-cluster controller's scrape
    # legitimately omits them.
    "ccka_slo_burn_rate": (
        "slo_burn_rate",
        "Fast-window fleet SLO burn rate (violating tenant-ticks per "
        "tenant-tick)"),
    "ccka_incident_active": (
        "incident_active",
        "1 while the burn-rate engine is burning or an incident "
        "trigger fired within the fast window"),
    "ccka_recorder_dumps_total": (
        "recorder_dumps_total",
        "Cumulative checksummed flight-recorder dumps this session"),
    # Device-time observatory series (obs/costmodel +
    # obs/occupancy): the compile registry's dispatch counter and the
    # observatory's last published pipeline measurement — achieved
    # roofline fraction, kernel-stage occupancy, and the mesh's
    # max/mean shard imbalance. Service-only: the fleet service's obs
    # block fills them; a single-cluster controller's scrape
    # legitimately omits them, and absent measurements SKIP rather
    # than export fake zeros.
    "ccka_program_dispatches_total": (
        "program_dispatches_total",
        "Cumulative watched-program device dispatches this session"),
    "ccka_achieved_roofline_fraction": (
        "achieved_roofline_fraction",
        "Achieved fraction of the memory roofline for the last "
        "attributed kernel-stage measurement"),
    "ccka_pipeline_occupancy": (
        "pipeline_occupancy.kernel",
        "Kernel-stage fraction of the last measured packed-pipeline "
        "occupancy ledger"),
    "ccka_shard_imbalance": (
        "shard_imbalance",
        "Max/mean per-shard kernel time across the mesh "
        "(1.0 = perfectly balanced)"),
    # Decision-provenance series (obs/decisions.py): the
    # windowed shadow-disagreement rate, the cost-term share of the
    # fleet's step-objective attribution (dotted term spec into the
    # per-term share dict), and the tick's projected chosen-minus-
    # rule-shadow SLO delta. Service-only, and skipped (never fake
    # zeros) when the decision ledger is off.
    "ccka_policy_divergence_rate": (
        "policy_divergence_rate",
        "Fraction of decides whose action departed from the rule "
        "shadow beyond obs.divergence_threshold over the trailing "
        "obs.decision_window ticks"),
    "ccka_objective_term_share": (
        "objective_term_shares.cost",
        "Cost-term share of the fleet's per-tick objective "
        "attribution (terms sum to 1; carbon/SLO shares ride the "
        "same dict)"),
    "ccka_shadow_slo_delta": (
        "shadow_slo_delta",
        "Chosen-minus-rule-shadow SLO-ok tenant count this tick "
        "(projected on identical observed inputs)"),
    # Shadow-tournament series (obs/tournament.py): the
    # summed windowed win rate over every roster candidate (the
    # challenger-pressure gauge — 0 means nothing on the roster is
    # beating the primary anywhere) and the current board leader's
    # roster index. Service-only, skipped (never fake zeros) when no
    # tournament ledger runs.
    "ccka_policy_candidate_win_rate": (
        "candidate_win_rate.*",
        "Summed windowed win rate over the tournament roster's "
        "candidates vs the live primary (per-candidate and per-class "
        "splits ride the board JSONL)"),
    "ccka_tournament_leader": (
        "tournament_leader",
        "Roster index of the candidate currently leading the shadow "
        "tournament's windowed board"),
    # Geo-arbitrage series (regions/geo.py publish/read
    # snapshot): the mean applied inter-region migration rate of the
    # last geo rollout and the sum of the per-region carbon
    # intensities its lanes saw. Service-only, skipped (never fake
    # zeros) before any geo rollout has published.
    "ccka_region_migration_rate": (
        "region_migration_rate.mean",
        "Mean applied off-diagonal inter-region migration rate of the "
        "last published geo rollout (0 = no mass moving)"),
    "ccka_region_carbon_intensity": (
        "region_carbon_intensity.*",
        "Sum of per-region grid carbon intensities (g/kWh) the last "
        "published geo rollout's lanes saw"),
    # Fleet-scale host-loop series (the vectorized admission
    # machine): real host microseconds per tenant spent in the
    # admission + accounting windows (virtual scrape delays excluded
    # by the offset-subtracting gauge) and the tenants that entered
    # the scrape/dispatch phase this tick. Service-only, and skipped
    # (never fake zeros) on older reports that don't carry the
    # fields.
    "ccka_host_loop_us_per_tenant": (
        "host_loop_us_per_tenant",
        "Real host-loop microseconds per tenant this tick (admission "
        "machine + masked accounting; scrape waits and device "
        "dispatch excluded)"),
    "ccka_active_tenants": (
        "active_tenants",
        "Tenants admitted into the scrape/dispatch phase this tick "
        "(post cadence/bulkhead/cap)"),
    "ccka_applied": ("applied", "1 if every patch applied this tick"),
    "ccka_verified": ("verified", "1 if read-back matched intent"),
    "ccka_tick": ("t", "Controller tick counter"),
    # Per-stage tick timing, sourced from the span tracer's fenced phase
    # spans (obs/trace.py via StageTimer): the scrape→decide→act loop's
    # structured timing, now on the wire and not only in JSONL.
    "ccka_tick_scrape_ms": (
        "timings_ms.scrape+slo_scrape",
        "Signal + SLO scrape time this tick, milliseconds"),
    "ccka_tick_decide_ms": (
        "timings_ms.decide",
        "Policy decide time this tick (device-fenced), milliseconds"),
    "ccka_tick_act_ms": (
        "timings_ms.render+apply+verify",
        "Render + apply + verify time this tick, milliseconds"),
    "ccka_tick_total_ms": (
        "timings_ms.*", "Total instrumented tick time, milliseconds"),
}

# Series that resolve only from the fleet service's ServiceTickReport
# (`harness/service.py`): a single-cluster controller's scrape
# legitimately omits them (resolve_field -> None skips the series), and
# the telemetry parity test checks them against a service tick instead.
SERVICE_ONLY_SERIES = frozenset({
    "ccka_tenant_breaker_state", "ccka_ticks_shed_total",
    "ccka_admission_queue_depth", "ccka_tick_latency_ms",
    "ccka_slo_burn_rate", "ccka_incident_active",
    "ccka_recorder_dumps_total",
    "ccka_program_dispatches_total", "ccka_achieved_roofline_fraction",
    "ccka_pipeline_occupancy", "ccka_shard_imbalance",
    "ccka_policy_divergence_rate", "ccka_objective_term_share",
    "ccka_shadow_slo_delta",
    "ccka_region_migration_rate", "ccka_region_carbon_intensity",
    "ccka_policy_candidate_win_rate", "ccka_tournament_leader",
    "ccka_host_loop_us_per_tenant", "ccka_active_tenants",
})

_LABEL = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")


def exported_series_names() -> set[str]:
    return set(SERIES)


def referenced_series(expr: str) -> set[str]:
    """The `ccka_*` tokens a PromQL expression reads (for parity tests)."""
    return {tok for tok in _LABEL.findall(expr) if tok.startswith("ccka_")}


def resolve_field(rec: Mapping, spec: str):
    """A SERIES field spec against one tick record: a plain TickReport
    field, or a dotted reach into a sub-dict — "timings_ms.a+b" sums the
    named phases (absent phases count 0), "timings_ms.*" sums all. An
    absent/empty sub-dict resolves to None so the series is skipped, not
    exported as a fake 0."""
    if "." not in spec:
        return rec.get(spec)
    base, _, sub = spec.partition(".")
    d = rec.get(base)
    if not isinstance(d, Mapping) or not d:
        return None
    if sub == "*":
        return sum(float(v) for v in d.values())
    return sum(float(d.get(k, 0.0)) for k in sub.split("+"))


def _escape_label_value(value: str) -> str:
    """Escape per the text exposition format: backslash, double-quote and
    newline must be escaped inside label values or scrapers reject the
    whole exposition."""
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def render_exposition(report, *, cluster: str = "") -> str:
    """One TickReport (or its dict) as Prometheus text format 0.0.4."""
    rec: Mapping = report if isinstance(report, Mapping) else asdict(report)
    label = (f'{{cluster="{_escape_label_value(cluster)}"}}'
             if cluster else "")
    lines = []
    for name, (field, help_text) in SERIES.items():
        value = resolve_field(rec, field)
        if value is None:
            continue
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{label} {float(value):g}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Publishes the latest tick as Prometheus gauges.

    ``port``: serve GET /metrics on 127.0.0.1:port (0 picks a free port —
    read it back from ``.port``). ``textfile``: additionally write a
    `.prom` file atomically each update (node-exporter textfile collector).
    Both are optional; with neither this is an in-memory holder (tests).
    """

    def __init__(self, *, port: int | None = None, textfile: str = "",
                 cluster: str = ""):
        self.cluster = cluster
        self.textfile = textfile
        self._latest: dict | None = None
        self._lock = threading.Lock()
        self._httpd = None
        self.port = None
        if port is not None:
            exporter = self

            class Handler(BaseHTTPRequestHandler):
                def do_GET(self):  # noqa: N802 (stdlib API)
                    if self.path.rstrip("/") not in ("", "/metrics"):
                        self.send_error(404)
                        return
                    body = exporter.exposition().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def log_message(self, *args):  # silence per-scrape stderr
                    pass

            self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="ccka-metrics")
            self._thread.start()

    def update(self, report) -> None:
        rec = report if isinstance(report, Mapping) else asdict(report)
        with self._lock:
            self._latest = dict(rec)
        if self.textfile:
            self._write_textfile()

    def exposition(self) -> str:
        with self._lock:
            rec = self._latest
        if rec is None:
            return "# no ticks yet\n"
        return render_exposition(rec, cluster=self.cluster)

    def _write_textfile(self) -> None:
        """Atomic replace: the textfile collector must never read a torn
        half-written file (same discipline as checkpoint writes)."""
        body = self.exposition()
        d = os.path.dirname(os.path.abspath(self.textfile)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".prom.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(body)
            os.replace(tmp, self.textfile)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
