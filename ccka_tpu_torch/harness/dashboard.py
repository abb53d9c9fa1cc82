"""Dashboard rendering — the demo_40 observability stage as manifests.

The PyTorch port's form of `ccka_tpu/harness/dashboard.py`: host code, the
same manifests byte for byte.

The reference deploys a namespace-local Grafana and provisions it with an
AMP datasource ConfigMap (`demo_40_watch_config.sh:51-72,75-138`), then
port-forwards dashboards for the operator (`demo_40_watch_observe.sh`).
The proposal names the dashboards it wanted: "SLO burn, $/1k req,
gCO2e/1k req, waste%, Spot exposure" (proposal PDF p.5) — none were built.

This module renders both halves as declarative objects:

- :func:`render_datasource_configmap` — the Grafana datasource provisioning
  ConfigMap pointed at any Prometheus-compatible endpoint (the SigV4-proxy
  AMP URL in the reference's case);
- :func:`render_dashboard` — a Grafana dashboard JSON with exactly the
  proposal's panels, fed by the controller's exported metric names (the
  telemetry JSONL fields double as the metric vocabulary).

Both apply through any ActuationSink (`kubectl apply -f` equivalents), so
`ccka dashboard --live` is the whole demo_40 configure stage.
"""

from __future__ import annotations

import json

from ccka_tpu_torch.actuation.guardrails import (
    HARDENED_CONTAINER_SECURITY_CONTEXT,
    hardened_pod_security_context,
)

_PANEL_DEFS = (
    # (title, expr, unit) — expr uses the controller's exported series
    # names, served by `harness.promexport` (`ccka run --metrics-port` /
    # --metrics-textfile); `tests/test_telemetry.py::TestPromExport` pins
    # panel-expr <-> exported-series parity both ways.
    ("Cost rate", "ccka_cost_usd_hr", "currencyUSD"),
    ("Carbon rate", "ccka_carbon_g_hr", "massg"),
    ("SLO burn", "1 - ccka_slo_ok", "percentunit"),
    ("$ per 1k requests", "ccka_usd_per_kreq", "currencyUSD"),
    ("gCO2e per 1k requests", "ccka_g_co2_per_kreq", "massg"),
    ("Waste %", "ccka_waste_frac", "percentunit"),
    ("Spot exposure", "ccka_nodes_spot / clamp_min(ccka_nodes_spot + "
     "ccka_nodes_od, 1)", "percentunit"),
    ("p95 latency", "ccka_latency_p95_ms", "ms"),
    ("Pending pods", "ccka_pending_pods", "short"),
    # Controller self-observation (the obs subsystem): per-stage tick
    # timing from the span tracer, so a slow scrape endpoint or a
    # recompiling decide shows up on the SAME board as the KPIs it skews.
    ("Tick time by stage", "ccka_tick_scrape_ms + ccka_tick_decide_ms + "
     "ccka_tick_act_ms", "ms"),
    ("Tick total", "ccka_tick_total_ms", "ms"),
    # Robustness panels (ccka_tpu/faults): the degraded-mode state
    # machine and fault events, next to the KPIs they explain — an
    # operator must see "rule-fallback since 14:02" on the same board
    # as the cost spike it prevented from being worse.
    ("Degraded mode", "ccka_degraded", "short"),
    ("Stale scrapes", "ccka_signal_stale", "short"),
    ("Degraded ticks (session)", "ccka_degraded_ticks_total", "short"),
    ("Fault events", "ccka_nodes_denied + ccka_nodes_delayed + "
     "ccka_nodes_drained", "short"),
    # Crash-safety panels (ARCHITECTURE §14): reconciler
    # convergence pressure, actuation failure budget, and the snapshot/
    # resume health of the control loop itself — an operator must see
    # "3 pools diverged, snapshot 40 ticks old" BEFORE restarting the
    # daemon, not find out after.
    ("Reconcile retries (session)", "ccka_reconcile_retries_total",
     "short"),
    ("Actuation divergence", "ccka_reconcile_diverged", "short"),
    ("Actuation failures (session)", "ccka_actuation_failures_total",
     "short"),
    ("Snapshot age", "ccka_snapshot_age_ticks", "short"),
    ("Resumes (session)", "ccka_resumes_total", "short"),
    # Multi-tenant service panels (ARCHITECTURE §15): the
    # overload-control surfaces — an operator must see "4 breakers
    # open, shedding, 180ms ticks" on the SAME board as the fleet KPIs
    # the bulkheads are protecting.
    ("Breaker pressure", "ccka_tenant_breaker_state", "short"),
    ("Decides shed (session)", "ccka_ticks_shed_total", "short"),
    ("Admission queue depth", "ccka_admission_queue_depth", "short"),
    ("Service tick latency", "ccka_tick_latency_ms", "ms"),
    # Incident panels (ccka_tpu/obs): the burn-rate view and
    # the incident/recorder state — the operator sees "SLO budget
    # burning, incident active, 3 captures taken" on the SAME board as
    # the breaker pressure that explains it.
    ("SLO burn rate", "ccka_slo_burn_rate", "percentunit"),
    ("Incident active", "ccka_incident_active", "short"),
    ("Recorder dumps (session)", "ccka_recorder_dumps_total", "short"),
    # Device-time observatory panels (obs/costmodel +
    # obs/occupancy): where device time goes and how close to the
    # roofline the measured kernel stage runs — the operator sees
    # "kernel 60% occupied, 0.9 of roofline, shard 3 lagging" on the
    # SAME board as the fleet KPIs that throughput serves.
    ("Program dispatches (session)", "ccka_program_dispatches_total",
     "short"),
    ("Achieved roofline", "ccka_achieved_roofline_fraction",
     "percentunit"),
    ("Kernel occupancy", "ccka_pipeline_occupancy", "percentunit"),
    ("Shard imbalance", "ccka_shard_imbalance", "short"),
    # Decision-provenance panels (obs/decisions.py): how far
    # the flagship departs from the rule shadow, which objective term
    # is buying the decisions, and what the departure is projected to
    # cost in SLO — the "why" next to the KPIs it explains.
    ("Policy divergence", "ccka_policy_divergence_rate", "percentunit"),
    ("Objective cost share", "ccka_objective_term_share", "percentunit"),
    ("Shadow SLO delta", "ccka_shadow_slo_delta", "short"),
    # Workload-family panels (ccka_tpu/workloads): per-family queue
    # pressure and the session's SLO accounting, on the same board as
    # the fleet cost/SLO panels the families trade against.
    ("Inference queue", "ccka_inference_queue_depth", "short"),
    ("Inference SLO violations (session)",
     "ccka_inference_slo_violations_total", "short"),
    ("Batch deadline misses (session)",
     "ccka_batch_deadline_misses_total", "short"),
    # Geo-arbitrage panel (ccka_tpu/regions): how much work
    # is moving between regions and how dirty the regional grids are —
    # the migration rate next to the carbon intensity it arbitrages.
    ("Geo migration vs grid carbon",
     "ccka_region_migration_rate + ccka_region_carbon_intensity / 1000",
     "short"),
    # Shadow-tournament panels (obs/tournament.py): how hard
    # the roster is pressing on the live primary (summed windowed win
    # rate) and which candidate currently leads the board — the
    # operator's cue to go read `ccka tournament explain`.
    ("Tournament challenger pressure",
     "ccka_policy_candidate_win_rate", "short"),
    ("Tournament leader", "ccka_tournament_leader", "short"),
    # Fleet-scale panels (harness/fleetscale.py): the host
    # loop's real cost per tenant and the admitted-tenant count, on the
    # same board as the shed/latency panels they explain — the operator
    # sees "10k tenants, 0.1us each" next to the queue-depth spike.
    ("Host loop cost per tenant", "ccka_host_loop_us_per_tenant",
     "short"),
    ("Active tenants", "ccka_active_tenants", "short"),
)


def render_dashboard(title: str = "CCKA autoscaler") -> dict:
    """Grafana dashboard JSON: the proposal's planned panels, realized."""
    panels = []
    for i, (name, expr, unit) in enumerate(_PANEL_DEFS):
        panels.append({
            "id": i + 1,
            "title": name,
            "type": "timeseries",
            "gridPos": {"h": 8, "w": 8, "x": (i % 3) * 8,
                        "y": (i // 3) * 8},
            "fieldConfig": {"defaults": {"unit": unit}},
            "targets": [{"expr": expr, "refId": "A"}],
        })
    return {
        "title": title,
        "uid": "ccka-autoscaler",
        "timezone": "utc",
        "refresh": "30s",  # the scrape cadence, 06_opencost.sh:323
        "panels": panels,
        "schemaVersion": 39,
    }


def render_datasource_configmap(prometheus_url: str,
                                namespace: str = "nov-22") -> dict:
    """Grafana datasource provisioning ConfigMap —
    `demo_40_watch_config.sh:51-72` with the AMP-via-SigV4-proxy URL
    generalized to any Prometheus-compatible endpoint."""
    datasource = {
        "apiVersion": 1,
        "datasources": [{
            "name": "ccka-prometheus",
            "type": "prometheus",
            "access": "proxy",
            "url": prometheus_url,
            "isDefault": True,
            "jsonData": {"timeInterval": "30s"},
        }],
    }
    return {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "ccka-grafana-datasource",
                     "namespace": namespace,
                     "labels": {"grafana_datasource": "1"}},
        "data": {"ccka-datasource.yaml": json.dumps(datasource, indent=2)},
    }


def render_dashboard_configmap(prometheus_url: str,
                               namespace: str = "nov-22") -> list[dict]:
    """Both provisioning objects: datasource + dashboard ConfigMaps (the
    dashboard rides the standard `grafana_dashboard: "1"` sidecar label)."""
    return [
        render_datasource_configmap(prometheus_url, namespace),
        {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "ccka-grafana-dashboard",
                         "namespace": namespace,
                         "labels": {"grafana_dashboard": "1"}},
            "data": {"ccka-dashboard.json":
                     json.dumps(render_dashboard(), indent=2)},
        },
    ]


GRAFANA_IMAGE = "grafana/grafana:10.4.2"  # demo_40_watch_config.sh:94


def render_grafana_admin_secret(namespace: str = "nov-22",
                                password: str | None = None) -> dict:
    """Grafana admin Secret (`demo_40_watch_config.sh:36-48`). A random
    password is generated unless supplied (supply one for golden tests);
    stringData keeps the manifest reviewable in dry-run output."""
    if password is None:
        import secrets
        password = secrets.token_urlsafe(12)
    return {
        "apiVersion": "v1", "kind": "Secret",
        "metadata": {"name": "ccka-grafana-admin", "namespace": namespace,
                     "labels": {"app": "ccka-grafana"}},
        "type": "Opaque",
        "stringData": {"admin-user": "admin", "admin-password": password},
    }


def render_grafana_deployment(namespace: str = "nov-22") -> list[dict]:
    """Namespace-local Grafana Deployment + Service + dashboard-provider
    ConfigMap (`demo_40_watch_config.sh:75-138`), redesigned to pass this
    framework's own guardrails:

    - every container carries requests+limits (the `require-requests-limits`
      ClusterPolicy in `actuation/guardrails.py` would reject the
      reference's Grafana pod, which has none);
    - non-root + no privilege escalation + dropped caps, like the burst
      workload's hardened pod spec;
    - unlike the reference (datasources only), the committed dashboard is
      provisioned too, via a file provider — no manual import step.
    """
    provider = {
        "apiVersion": 1,
        "providers": [{
            "name": "ccka",
            "type": "file",
            "options": {"path": "/var/lib/grafana/dashboards"},
        }],
    }
    provider_cm = {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "ccka-grafana-dashboard-provider",
                     "namespace": namespace,
                     "labels": {"app": "ccka-grafana"}},
        "data": {"provider.yaml": json.dumps(provider, indent=2)},
    }
    secret_env = [
        {"name": f"GF_SECURITY_ADMIN_{k.upper()}",
         "valueFrom": {"secretKeyRef": {"name": "ccka-grafana-admin",
                                        "key": f"admin-{k}"}}}
        for k in ("user", "password")]
    deployment = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "ccka-grafana", "namespace": namespace,
                     "labels": {"app": "ccka-grafana"}},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"app": "ccka-grafana"}},
            "template": {
                "metadata": {"labels": {"app": "ccka-grafana"}},
                "spec": {
                    # Shared hardening (actuation/guardrails.py) with the
                    # grafana image's baked-in uid.
                    "securityContext": hardened_pod_security_context(
                        uid=472),
                    "containers": [{
                        "name": "grafana",
                        "image": GRAFANA_IMAGE,
                        "imagePullPolicy": "IfNotPresent",
                        "ports": [{"containerPort": 3000, "name": "http"}],
                        "env": secret_env + [
                            {"name": "GF_AUTH_ANONYMOUS_ENABLED",
                             "value": "false"},
                        ],
                        "resources": {
                            "requests": {"cpu": "100m", "memory": "128Mi"},
                            "limits": {"cpu": "500m", "memory": "256Mi"},
                        },
                        "securityContext": dict(
                            HARDENED_CONTAINER_SECURITY_CONTEXT),
                        "readinessProbe": {
                            "httpGet": {"path": "/login", "port": 3000},
                            "initialDelaySeconds": 5, "periodSeconds": 5},
                        "livenessProbe": {
                            "httpGet": {"path": "/api/health", "port": 3000},
                            "initialDelaySeconds": 10, "periodSeconds": 10},
                        "volumeMounts": [
                            {"name": "datasources",
                             "mountPath":
                                 "/etc/grafana/provisioning/datasources"},
                            {"name": "dashboard-provider",
                             "mountPath":
                                 "/etc/grafana/provisioning/dashboards"},
                            {"name": "dashboards",
                             "mountPath": "/var/lib/grafana/dashboards"},
                        ],
                    }],
                    "volumes": [
                        {"name": "datasources",
                         "configMap": {"name": "ccka-grafana-datasource"}},
                        {"name": "dashboard-provider",
                         "configMap":
                             {"name": "ccka-grafana-dashboard-provider"}},
                        {"name": "dashboards",
                         "configMap": {"name": "ccka-grafana-dashboard"}},
                    ],
                },
            },
        },
    }
    service = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "ccka-grafana", "namespace": namespace,
                     "labels": {"app": "ccka-grafana"}},
        "spec": {
            "selector": {"app": "ccka-grafana"},
            "ports": [{"name": "http", "port": 3000, "targetPort": 3000}],
        },
    }
    return [provider_cm, deployment, service]


def render_observability_stack(prometheus_url: str,
                               namespace: str = "nov-22",
                               *, admin_password: str | None = None
                               ) -> list[dict]:
    """The WHOLE demo_40 configure stage as manifests, apply-ordered:
    provisioning ConfigMaps, admin Secret, then Deployment + Service."""
    return (render_dashboard_configmap(prometheus_url, namespace)
            + [render_grafana_admin_secret(namespace, admin_password)]
            + render_grafana_deployment(namespace))
