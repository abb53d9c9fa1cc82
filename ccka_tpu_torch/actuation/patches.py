"""Render canonical Actions into Kubernetes mutation payloads.

The PyTorch port's form of `ccka_tpu/actuation/patches.py`. It takes the
port's ``Action`` (tensors on any device, one cluster's leaves) and renders
the same bytes as the JAX package for the same action values.

The emitted NodePool patch JSON is byte-compatible with what the reference's
bash writes (the oracle format per SURVEY.md §4):

- disruption merge patches: `demo_20_offpeak_configure.sh:59-60`
  (`{"spec":{"disruption":{"consolidationPolicy":"WhenEmptyOrUnderutilized"}}}`
  and `{"spec":{"disruption":{"consolidationPolicy":"WhenEmpty",
  "consolidateAfter":"60s"}}}`), `demo_21_peak_configure.sh:56-57` (120s);
- requirements JSON patches: `write_req_patch`
  (`demo_20_offpeak_configure.sh:64-81` with op:replace,
  `demo_21_peak_configure.sh:60-77` with op:add) — a single op at
  `{path_prefix}/requirements` whose value is
  `[{"key":"topology.kubernetes.io/zone","operator":"In","values":[...]},
    {"key":"karpenter.sh/capacity-type","operator":"In","values":[...]}]`.

HPA and KEDA renderers realize the capabilities the reference names but
never creates (§2.3: prometheus-adapter installed yet no HPA object,
`03_monitoring.sh:17-19`; KEDA SQS env stub, `.env:10-12`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ccka_tpu_torch.config import ClusterConfig, WorkloadConfig
from ccka_tpu_torch.sim.types import CT_OD, CT_SPOT, Action

PRIMARY_PATH = "/spec/template/spec"    # demo_20:86
FALLBACK_PATH = "/spec/template"        # demo_20:87

# Rendered names by capacity-type index; tied to the sim constants so a
# reorder there cannot silently desynchronize the wire format.
_CT_NAMES = ("spot", "on-demand")
assert _CT_NAMES.index("spot") == CT_SPOT
assert _CT_NAMES.index("on-demand") == CT_OD


@dataclass(frozen=True)
class NodePoolPatchSet:
    """One pool's mutation: a disruption merge patch + requirements JSON
    patch (primary and fallback path variants, demo_20:84-127)."""

    pool: str
    disruption_merge: dict
    requirements_json: list        # at PRIMARY_PATH
    requirements_json_fallback: list  # at FALLBACK_PATH


def _host(x) -> np.ndarray:
    """An action leaf as a host array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _threshold(x, cut: float = 0.5) -> np.ndarray:
    return _host(x) > cut


def render_nodepool_patches(action: Action, cluster: ClusterConfig,
                            *, op: str = "replace") -> list[NodePoolPatchSet]:
    """Discretize a (feasible) Action into per-pool Karpenter patches.

    ``op`` mirrors the reference's profile difference: off-peak uses
    op:replace (`demo_20:69`), peak op:add (`demo_21:65`).
    """
    if op not in ("replace", "add"):
        raise ValueError(f"bad patch op {op!r}")
    zone_mask = _threshold(action.zone_weight)            # [P, Z]
    ct_mask = _threshold(action.ct_allow)                 # [P, T_CT]
    aggr = _threshold(action.consolidation_aggr)          # [P]
    after = _host(action.consolidate_after_s)            # [P]

    out = []
    for i, pool in enumerate(cluster.pools):
        if aggr[i]:
            # demo_20:59 — WhenEmptyOrUnderutilized, no consolidateAfter.
            merge = {"spec": {"disruption": {
                "consolidationPolicy": "WhenEmptyOrUnderutilized"}}}
        else:
            merge = {"spec": {"disruption": {
                "consolidationPolicy": "WhenEmpty",
                "consolidateAfter": f"{int(round(float(after[i])))}s"}}}

        zones = [z for j, z in enumerate(cluster.zones) if zone_mask[i, j]]
        if not zones:  # unsatisfiable requirement — guarded upstream too
            zones = list(cluster.zones)
        # Reference writes spot before on-demand (demo_20:75). The rendered
        # set is always intersected with the pool's intrinsic capacity types:
        # the SLO pool can never be patched to offer spot, no matter what an
        # (unprojected) action requests — the Kyverno critical-workload
        # guarantee enforced at the last exit (`04_kyverno.sh:47-75`).
        cts = [name for k, name in enumerate(_CT_NAMES)
               if ct_mask[i, k] and name in pool.capacity_types]
        if not cts:
            cts = [name for name in _CT_NAMES if name in pool.capacity_types]
        requirements = [
            {"key": "topology.kubernetes.io/zone", "operator": "In",
             "values": zones},
            {"key": "karpenter.sh/capacity-type", "operator": "In",
             "values": cts},
        ]
        out.append(NodePoolPatchSet(
            pool=pool.name,
            disruption_merge=merge,
            requirements_json=[{
                "op": op, "path": f"{PRIMARY_PATH}/requirements",
                "value": requirements}],
            requirements_json_fallback=[{
                "op": op, "path": f"{FALLBACK_PATH}/requirements",
                "value": requirements}],
        ))
    return out


def render_region_nodepool_patches(
        action: Action, cluster: ClusterConfig,
        *, op: str = "replace") -> dict[str, list[NodePoolPatchSet]]:
    """Multi-region actuation: one patchset list per region.

    A Karpenter NodePool is a per-cluster object, and a cluster lives in one
    region — so a multi-region fleet (BASELINE config #4) runs one Karpenter
    per regional cluster, and the global action is split by intersecting its
    selected zone set with each region's zones. A region whose intersection
    is empty gets its full zone set (same guard as the single-region
    renderer: an empty `In` requirement would make the pool unsatisfiable,
    which is an outage, not a preference).

    For the single-region topology this returns ``{region: patches}``
    identical to :func:`render_nodepool_patches`.
    """
    base = render_nodepool_patches(action, cluster, op=op)
    if not cluster.regions:
        return {cluster.region: base}

    def _scoped(patch_ops: list, region_zones: tuple) -> list:
        ops = []
        for p in patch_ops:
            reqs = []
            for req in p["value"]:
                if req["key"] == "topology.kubernetes.io/zone":
                    zones = [z for z in req["values"] if z in region_zones]
                    reqs.append({**req, "values": zones or list(region_zones)})
                else:
                    reqs.append(req)
            ops.append({**p, "value": reqs})
        return ops

    out: dict[str, list[NodePoolPatchSet]] = {}
    for r in cluster.regions:
        out[r.name] = [NodePoolPatchSet(
            pool=ps.pool,
            disruption_merge=ps.disruption_merge,
            requirements_json=_scoped(ps.requirements_json, r.zones),
            requirements_json_fallback=_scoped(
                ps.requirements_json_fallback, r.zones),
        ) for ps in base]
    return out


def render_hpa_manifests(action: Action, cluster: ClusterConfig,
                         workload: WorkloadConfig,
                         namespace: str = "nov-22") -> list[dict]:
    """HorizontalPodAutoscaler objects per workload class.

    Closes §2.3: the reference installs prometheus-adapter
    (`03_monitoring.sh:17-19`) precisely to feed HPA custom metrics, yet
    creates no HPA. One HPA per burst deployment group, with the policy's
    hpa_scale folded into the replica ceiling. Namespace default matches
    the demo (`demo_00_env.sh:9-10`).
    """
    scale = np.clip(_host(action.hpa_scale), 0.1, 4.0)
    per_class = workload.total_pods // 2
    manifests = []
    for c, cls_name in enumerate(("burst-spot", "burst-od")):
        target = max(1, int(round(per_class * float(scale[c]))))
        manifests.append({
            "apiVersion": "autoscaling/v2",
            "kind": "HorizontalPodAutoscaler",
            "metadata": {"name": f"hpa-{cls_name}", "namespace": namespace},
            "spec": {
                "scaleTargetRef": {"apiVersion": "apps/v1",
                                   "kind": "Deployment",
                                   "name": cls_name},
                "minReplicas": max(1, target // 4),
                "maxReplicas": target,
                "metrics": [{
                    "type": "Resource",
                    "resource": {"name": "cpu",
                                 "target": {"type": "Utilization",
                                            "averageUtilization": 70}},
                }],
            },
        })
    return manifests


def render_keda_scaledobject(action: Action, queue_name: str,
                             account_id: str,
                             namespace: str = "nov-22",
                             region: str = "us-east-2") -> dict:
    """KEDA ScaledObject for SQS-driven scaling.

    Realizes the reference's `.env:10-12` stub (`CREATE_SQS`,
    `SQS_QUEUE_NAME` with no ScaledObject or KEDA install anywhere).
    ``account_id`` is the AWS account owning the queue (required — a
    placeholder URL would render the scaler permanently inactive).
    Queue-length target tightens as the policy scales up (hpa_scale mean).
    """
    if not account_id:
        raise ValueError("render_keda_scaledobject requires the AWS "
                         "account id owning the SQS queue")
    scale = float(np.mean(np.clip(_host(action.hpa_scale), 0.1, 4.0)))
    queue_len = max(1, int(round(10.0 / scale)))
    return {
        "apiVersion": "keda.sh/v1alpha1",
        "kind": "ScaledObject",
        "metadata": {"name": f"scaled-{queue_name}", "namespace": namespace},
        "spec": {
            "scaleTargetRef": {"name": "burst-queue-worker"},
            "minReplicaCount": 0,
            "maxReplicaCount": 100,
            "triggers": [{
                "type": "aws-sqs-queue",
                "metadata": {
                    "queueURL": f"https://sqs.{region}.amazonaws.com/"
                                f"{account_id}/{queue_name}",
                    "queueLength": str(queue_len),
                    "awsRegion": region,
                },
            }],
        },
    }
