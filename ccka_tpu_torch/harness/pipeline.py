"""Metrics-pipeline rendering — the reference's collector deployment as
declarative manifests.

The PyTorch port's form of `ccka_tpu/harness/pipeline.py`: host code, the
same manifests byte for byte.

The reference's largest script closes its metrics loop with two deployed
halves this framework previously only *consumed* or *exported*:

- an ADOT collector that scrapes kube-state-metrics and remote-writes to
  AMP through SigV4 (`06_opencost.sh:277-387`: RBAC for
  Kubernetes SD, a ConfigMap carrying the OTel pipeline
  ``prometheus receiver → sigv4auth → prometheusremotewrite``, and a
  hardened Deployment);
- an aws-sigv4-proxy Deployment + Service fronting the AMP query API so
  Prometheus-API clients (Grafana, the demo observes) can read without
  SigV4-signing themselves (`06_opencost.sh:204-264`).

This module renders both halves the way `harness/dashboard.py` renders
the demo_40 Grafana stack: pure functions returning manifest dicts that
apply through any ActuationSink, so ``ccka pipeline --live`` is the
whole deploy stage and dry-run prints reviewable kubectl-equivalents.

Framework-first differences from the reference (not a port):

- the scrape pool includes the CONTROLLER's own exposition
  (`harness/promexport.py` serves the ``ccka_*`` series the dashboards
  chart) alongside kube-state-metrics — the reference never scraped its
  own decision loop;
- the remote-write target is ANY Prometheus-compatible endpoint; SigV4
  auth is an option (``region=...``), not an assumption, so the same
  pipeline lands on AMP, Mimir, Thanos or a plain Prometheus;
- every pod passes this framework's own Kyverno guardrails
  (`actuation/guardrails.py`): requests+limits on all containers,
  non-root, no privilege escalation, dropped capabilities — the
  reference's pods carry these too (`06_opencost.sh:227-236`), and the
  parity is kept.
"""

from __future__ import annotations

import json

from ccka_tpu_torch.actuation.guardrails import (
    HARDENED_CONTAINER_SECURITY_CONTEXT,
    hardened_pod_security_context,
)

# Image pins mirror the reference's choices (06_opencost.sh:237,358) —
# pinned rather than :latest so the rendered manifests are reproducible.
COLLECTOR_IMAGE = "public.ecr.aws/aws-observability/aws-otel-collector:v0.40.0"
SIGV4_PROXY_IMAGE = "public.ecr.aws/aws-observability/aws-sigv4-proxy:1.8"

# nobody:nobody with fsGroup — the reference's NONROOT_UID analog.
_HARDENED_POD = hardened_pod_security_context(uid=65534, gid=65534,
                                              fs_group=65534)
_HARDENED_CONTAINER = HARDENED_CONTAINER_SECURITY_CONTEXT


def default_scrape_targets(namespace: str) -> list[dict]:
    """The framework's scrape pool: the controller's own ``ccka_*``
    exposition plus kube-state-metrics (the reference's one known-good
    target, `06_opencost.sh:322-326`)."""
    return [
        {"job_name": "ccka-controller",
         "static_configs": [{"targets": [
             f"ccka-controller.{namespace}.svc.cluster.local:9464"]}]},
        {"job_name": "ksm-static",
         "static_configs": [{"targets": [
             f"kube-state-metrics.{namespace}.svc.cluster.local:8080"]}]},
    ]


def render_collector_config(remote_write_url: str,
                            scrape_configs: list[dict],
                            *, region: str = "",
                            scrape_interval: str = "30s") -> dict:
    """The OTel collector pipeline document
    (`06_opencost.sh:316-341`): prometheus receiver over the scrape
    pool → prometheusremotewrite exporter, with the sigv4auth extension
    threaded in exactly when a ``region`` is given."""
    exporter: dict = {"endpoint": remote_write_url}
    service: dict = {"pipelines": {"metrics": {
        "receivers": ["prometheus"],
        "exporters": ["prometheusremotewrite"],
    }}}
    config: dict = {
        "receivers": {"prometheus": {"config": {
            "global": {"scrape_interval": scrape_interval},
            "scrape_configs": scrape_configs,
        }}},
        "exporters": {"prometheusremotewrite": exporter},
        "service": service,
    }
    if region:
        exporter["auth"] = {"authenticator": "sigv4auth"}
        config["extensions"] = {"sigv4auth": {"region": region}}
        service["extensions"] = ["sigv4auth"]
    return config


def render_collector_rbac(namespace: str) -> list[dict]:
    """ClusterRole + binding for Kubernetes service discovery
    (`06_opencost.sh:277-301`) — read-only on the SD surfaces."""
    return [
        {"apiVersion": "rbac.authorization.k8s.io/v1",
         "kind": "ClusterRole",
         "metadata": {"name": "ccka-collector-k8ssd"},
         "rules": [{"apiGroups": [""],
                    "resources": ["nodes", "nodes/proxy", "services",
                                  "endpoints", "pods", "namespaces"],
                    "verbs": ["get", "list", "watch"]}]},
        {"apiVersion": "rbac.authorization.k8s.io/v1",
         "kind": "ClusterRoleBinding",
         "metadata": {"name": "ccka-collector-k8ssd-binding"},
         "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                     "kind": "ClusterRole",
                     "name": "ccka-collector-k8ssd"},
         "subjects": [{"kind": "ServiceAccount",
                       "name": "ccka-collector",
                       "namespace": namespace}]},
    ]


def render_collector_deployment(remote_write_url: str,
                                namespace: str,
                                *, region: str = "",
                                writer_role_arn: str = "",
                                scrape_configs: list[dict] | None = None
                                ) -> list[dict]:
    """ServiceAccount + config ConfigMap + Deployment for the collector
    (`06_opencost.sh:302-387`), hardened to pass the framework's own
    admission guardrails."""
    if scrape_configs is None:
        scrape_configs = default_scrape_targets(namespace)
    sa: dict = {
        "apiVersion": "v1", "kind": "ServiceAccount",
        "metadata": {"name": "ccka-collector", "namespace": namespace},
    }
    if writer_role_arn:
        # IRSA: the pod identity the remote-write SigV4 signs with.
        sa["metadata"]["annotations"] = {
            "eks.amazonaws.com/role-arn": writer_role_arn}
    config_cm = {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "ccka-collector-config",
                     "namespace": namespace},
        "data": {"collector.yaml": json.dumps(
            render_collector_config(remote_write_url, scrape_configs,
                                    region=region), indent=2)},
    }
    deployment = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "ccka-collector", "namespace": namespace,
                     "labels": {"app": "ccka-collector"}},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"app": "ccka-collector"}},
            "template": {
                "metadata": {"labels": {"app": "ccka-collector"}},
                "spec": {
                    "serviceAccountName": "ccka-collector",
                    "terminationGracePeriodSeconds": 10,
                    "securityContext": dict(_HARDENED_POD),
                    "containers": [{
                        "name": "collector",
                        "image": COLLECTOR_IMAGE,
                        "imagePullPolicy": "IfNotPresent",
                        "args": ["--config=/conf/collector.yaml"],
                        "securityContext": dict(_HARDENED_CONTAINER),
                        "volumeMounts": [{"name": "conf",
                                          "mountPath": "/conf"}],
                        "resources": {
                            "requests": {"cpu": "200m",
                                         "memory": "256Mi"},
                            "limits": {"cpu": "1", "memory": "512Mi"},
                        },
                    }],
                    "volumes": [{
                        "name": "conf",
                        "configMap": {
                            "name": "ccka-collector-config",
                            "items": [{"key": "collector.yaml",
                                       "path": "collector.yaml"}]},
                    }],
                },
            },
        },
    }
    return [sa, config_cm, deployment]


def render_query_proxy(namespace: str,
                       *, region: str,
                       host: str = "",
                       query_role_arn: str = "",
                       port: int = 8005) -> list[dict]:
    """The SigV4 query proxy (`06_opencost.sh:204-264`): ServiceAccount
    (IRSA query role) + Deployment + Service. ``host`` defaults to the
    AMP workspace API for ``region``; the Service is what Grafana's
    datasource (and `ccka watch`'s port-forward plan) point at."""
    host = host or f"aps-workspaces.{region}.amazonaws.com"
    sa: dict = {
        "apiVersion": "v1", "kind": "ServiceAccount",
        "metadata": {"name": "ccka-query-proxy", "namespace": namespace},
    }
    if query_role_arn:
        sa["metadata"]["annotations"] = {
            "eks.amazonaws.com/role-arn": query_role_arn}
    deployment = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "ccka-query-proxy", "namespace": namespace,
                     "labels": {"app": "ccka-query-proxy"}},
        "spec": {
            "replicas": 1,
            "strategy": {"type": "Recreate"},
            "selector": {"matchLabels": {"app": "ccka-query-proxy"}},
            "template": {
                "metadata": {"labels": {"app": "ccka-query-proxy"}},
                "spec": {
                    "serviceAccountName": "ccka-query-proxy",
                    "terminationGracePeriodSeconds": 10,
                    "securityContext": dict(_HARDENED_POD),
                    "containers": [{
                        "name": "sigv4-proxy",
                        "image": SIGV4_PROXY_IMAGE,
                        "imagePullPolicy": "IfNotPresent",
                        "args": ["--name=aps", f"--region={region}",
                                 f"--host={host}", f"--port=:{port}"],
                        "ports": [{"containerPort": port}],
                        "securityContext": dict(_HARDENED_CONTAINER),
                        "resources": {
                            "requests": {"cpu": "100m",
                                         "memory": "128Mi"},
                            "limits": {"cpu": "500m",
                                       "memory": "256Mi"},
                        },
                    }],
                },
            },
        },
    }
    service = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "ccka-query-proxy", "namespace": namespace},
        "spec": {
            "selector": {"app": "ccka-query-proxy"},
            "ports": [{"name": "http", "port": port, "targetPort": port,
                       "protocol": "TCP"}],
        },
    }
    return [sa, deployment, service]


def render_metrics_pipeline(remote_write_url: str,
                            namespace: str,
                            *, region: str = "",
                            writer_role_arn: str = "",
                            query_role_arn: str = "",
                            proxy: bool = False,
                            scrape_configs: list[dict] | None = None
                            ) -> list[dict]:
    """The whole deploy stage, apply-ordered: RBAC, collector stack,
    and (when ``proxy``) the SigV4 query proxy. ``proxy`` requires a
    ``region`` — the proxy exists only to SigV4-sign."""
    if proxy and not region:
        raise ValueError("the query proxy is SigV4-specific: pass "
                         "region= to render it")
    docs = render_collector_rbac(namespace)
    docs += render_collector_deployment(
        remote_write_url, namespace, region=region,
        writer_role_arn=writer_role_arn, scrape_configs=scrape_configs)
    if proxy:
        docs += render_query_proxy(namespace, region=region,
                                   query_role_arn=query_role_arn)
    return docs
