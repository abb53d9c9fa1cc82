"""Burst workload generator — the demo_30 load driver, manifest-native.

The PyTorch port's form of `ccka_tpu/actuation/burst.py`: host code, the
same manifests and kubectl streams byte for byte.

The reference's load generator (`demo_30_burst_configure.sh`) creates
COUNT=12 Deployments × REPLICAS=5 nginx pods (`:7-8`), alternating
odd→spot / even→on-demand nodeSelectors with a `critical` toleration on the
even ones (`:59-70,104-106`), non-root hardened containers with probes and
200m/128Mi requests, 500m/256Mi limits (`:110-140`) — sized to overflow the
3×m6i.large base capacity and force Karpenter scale-out. Its observe side
(`demo_30_burst_observe.sh`) tabulates Pending-pod scheduling diagnostics
from the PodScheduled condition (`:20-28`).

Here the same workload is rendered as manifest dicts and applied through
any :class:`~ccka_tpu_torch.actuation.sink.ActuationSink` (dry-run or kubectl),
with the RBAC preamble (`demo_30:14-54`) and the PDB from the setup stage
(`demo_10_setup_configure.sh:46-57`); the Pending-pod table is a pure
function over pod statuses so it is unit-testable without a cluster.
"""

from __future__ import annotations

from typing import Sequence

from ccka_tpu_torch.actuation.sink import ActuationSink, ApplyResult
from ccka_tpu_torch.config import WorkloadConfig

DEFAULT_NAMESPACE = "nov-22"   # demo_00_env.sh:9-10
BURST_GROUP = "scale-burst"    # demo_10_setup_configure.sh:17

# Limit/request ratios from the reference pod spec
# (`demo_30_burst_configure.sh:135-140`: 200m/128Mi → 500m/256Mi).
_CPU_LIMIT_RATIO = 2.5
_MEM_LIMIT_RATIO = 2.0


def _cpu_str(cores: float) -> str:
    return f"{int(round(cores * 1000))}m"


def _mem_str(gib: float) -> str:
    return f"{int(round(gib * 1024))}Mi"


def render_burst_rbac(namespace: str = DEFAULT_NAMESPACE) -> list[dict]:
    """ServiceAccount + Role + RoleBinding for the burst driver.

    Mirrors `demo_30_burst_configure.sh:21-54` / `demo_10_setup_configure.sh:
    12-44`: SA `scale-burst`, Role `scale-writer` with full verbs on
    deployments/services and get-list-watch-delete on pods.
    """
    return [
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": namespace}},
        {"apiVersion": "v1", "kind": "ServiceAccount",
         "metadata": {"name": "scale-burst", "namespace": namespace}},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
         "metadata": {"name": "scale-writer", "namespace": namespace},
         "rules": [
             {"apiGroups": ["apps"], "resources": ["deployments"],
              "verbs": ["create", "get", "list", "watch", "update",
                        "patch", "delete"]},
             {"apiGroups": [""], "resources": ["services"],
              "verbs": ["create", "get", "list", "watch", "update",
                        "patch", "delete"]},
             {"apiGroups": [""], "resources": ["pods"],
              "verbs": ["get", "list", "watch", "delete"]},
         ]},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
         "metadata": {"name": "scale-writer-binding", "namespace": namespace},
         "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                     "kind": "Role", "name": "scale-writer"},
         "subjects": [{"kind": "ServiceAccount", "name": "scale-burst",
                       "namespace": namespace}]},
    ]


def render_burst_pdb(workload: WorkloadConfig,
                     namespace: str = DEFAULT_NAMESPACE) -> dict:
    """PDB over the burst group — `demo_10_setup_configure.sh:46-57`
    (minAvailable 50%, the eviction floor the simulator's consolidation
    model enforces as ``pdb_min_available``)."""
    pct = int(round(workload.pdb_min_available * 100))
    return {
        "apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
        "metadata": {"name": "burst-pdb", "namespace": namespace},
        "spec": {"minAvailable": f"{pct}%",
                 "selector": {"matchLabels": {"group": BURST_GROUP}}},
    }


def render_burst_deployments(workload: WorkloadConfig,
                             namespace: str = DEFAULT_NAMESPACE,
                             *, count: int | None = None,
                             replicas: int | None = None) -> list[dict]:
    """The COUNT×REPLICAS Deployment set, odd→spot / even→on-demand.

    Faithful to `demo_30_burst_configure.sh:56-141`: 1-indexed names
    `burst-web-$i`; odd deployments pin `karpenter.sh/capacity-type: spot`
    with no tolerations, even pin `on-demand` and tolerate the
    `critical=true:NoSchedule` taint; hardened nginx-unprivileged
    containers with probes; requests from the workload config, limits at
    the reference's ratios.
    """
    count = workload.deployments if count is None else count
    replicas = workload.replicas if replicas is None else replicas
    req_cpu, req_mem = workload.pod_cpu_request, workload.pod_mem_request_gib

    docs = []
    for i in range(1, count + 1):
        spot = i % 2 == 1
        cap = "spot" if spot else "on-demand"
        tolerations = [] if spot else [
            {"key": "critical", "operator": "Equal", "value": "true",
             "effect": "NoSchedule"}]
        docs.append({
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {
                "name": f"burst-web-{i}", "namespace": namespace,
                "labels": {"group": BURST_GROUP, "capacity": cap},
            },
            "spec": {
                "replicas": replicas,
                "selector": {"matchLabels": {"app": f"burst-web-{i}"}},
                "template": {
                    "metadata": {"labels": {"app": f"burst-web-{i}",
                                            "group": BURST_GROUP}},
                    "spec": {
                        "serviceAccountName": "scale-burst",
                        "nodeSelector": {"karpenter.sh/capacity-type": cap},
                        "tolerations": tolerations,
                        "securityContext": {"runAsNonRoot": True,
                                            "runAsUser": 101,
                                            "seccompProfile":
                                                {"type": "RuntimeDefault"}},
                        "containers": [{
                            "name": "web",
                            "image": "nginxinc/nginx-unprivileged:1.27",
                            "ports": [{"containerPort": 8080}],
                            "readinessProbe": {
                                "httpGet": {"path": "/", "port": 8080},
                                "initialDelaySeconds": 2,
                                "periodSeconds": 5},
                            "livenessProbe": {
                                "httpGet": {"path": "/", "port": 8080},
                                "initialDelaySeconds": 5,
                                "periodSeconds": 10},
                            "securityContext": {
                                "allowPrivilegeEscalation": False,
                                "capabilities": {"drop": ["ALL"]}},
                            "resources": {
                                "requests": {"cpu": _cpu_str(req_cpu),
                                             "memory": _mem_str(req_mem)},
                                "limits": {
                                    "cpu": _cpu_str(req_cpu * _CPU_LIMIT_RATIO),
                                    "memory": _mem_str(
                                        req_mem * _MEM_LIMIT_RATIO)}},
                        }],
                    },
                },
            },
        })
    return docs


def apply_burst(workload: WorkloadConfig, sink: ActuationSink,
                namespace: str = DEFAULT_NAMESPACE,
                *, count: int | None = None,
                replicas: int | None = None) -> list[ApplyResult]:
    """RBAC preamble, PDB, then the deployment loop — demo_30's sequence,
    through the sink's apply+read-back discipline."""
    docs = render_burst_rbac(namespace)
    docs.append(render_burst_pdb(workload, namespace))
    docs += render_burst_deployments(workload, namespace,
                                     count=count, replicas=replicas)
    return sink.apply_manifests(docs)


def delete_burst(sink: ActuationSink,
                 namespace: str = DEFAULT_NAMESPACE) -> bool:
    """Remove the burst deployments + PDB by the group label — the targeted
    subset of demo_50's teardown (`demo_50_cleanup_configure.sh:20-24`
    deletes the whole namespace; this keeps RBAC for the next run)."""
    ok = sink.delete_object("deployment", selector=f"group={BURST_GROUP}",
                            namespace=namespace)
    ok = sink.delete_object("poddisruptionbudget", "burst-pdb",
                            namespace=namespace) and ok
    return ok


def burst_status(sink: ActuationSink,
                 namespace: str = DEFAULT_NAMESPACE) -> dict:
    """Deployment readiness summary from the sink's read-back — the
    `demo_30_burst_observe.sh:10-11` table, machine-readable. Lists by the
    group label (never by probing sequential names, which would undercount
    after a gap — a failed apply or a mid-run delete)."""
    rows = []
    for doc in sink.list_objects("Deployment",
                                 selector=f"group={BURST_GROUP}",
                                 namespace=namespace):
        spec = doc.get("spec", {})
        status = doc.get("status", {})
        rows.append({
            "name": doc["metadata"]["name"],
            "capacity": doc["metadata"].get("labels", {}).get("capacity", ""),
            "replicas": spec.get("replicas", 0),
            "ready": status.get("readyReplicas", 0),
        })
    n_spot = sum(1 for r in rows if r["capacity"] == "spot")
    return {
        "deployments": rows,
        "count": len(rows),
        "count_spot": n_spot,
        "count_on_demand": len(rows) - n_spot,
        "desired_pods": sum(r["replicas"] for r in rows),
        "ready_pods": sum(r["ready"] for r in rows),
    }


def pending_pod_diagnostics(pods: Sequence[dict]) -> list[dict]:
    """Pending-pod scheduling table — `demo_30_burst_observe.sh:20-28`.

    The reference pipes `kubectl get pods -o json` through jq to extract
    each Pending pod's PodScheduled condition reason/message (the
    "Insufficient cpu / no nodes match selector" evidence Karpenter acts
    on). Input: pod objects (as from `kubectl get pods -o json`'s items);
    output: one row per Pending pod.
    """
    rows = []
    for pod in pods:
        status = pod.get("status", {})
        if status.get("phase") != "Pending":
            continue
        reason, message = "", ""
        for cond in status.get("conditions", []):
            if cond.get("type") == "PodScheduled" and (
                    cond.get("status") == "False"):
                reason = cond.get("reason", "")
                message = cond.get("message", "")
        rows.append({
            "name": pod.get("metadata", {}).get("name", ""),
            "node_selector": (pod.get("spec", {})
                              .get("nodeSelector", {})
                              .get("karpenter.sh/capacity-type", "")),
            "reason": reason,
            "message": message,
        })
    return rows
