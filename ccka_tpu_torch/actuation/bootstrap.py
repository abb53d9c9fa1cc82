"""NodePool / EC2NodeClass bootstrap and teardown — the reference's missing
`demo_01`.

The PyTorch port's form of `ccka_tpu/actuation/bootstrap.py`: host code, the
same manifests and kubectl streams byte for byte.

SURVEY.md §2.1 marks `demo_01_nodepool_configure.sh` **Missing**: it is a
byte-identical copy of `demo_00_env.sh`, and *no script in the reference
creates the NodePools or the EC2NodeClass* even though every demo consumes
them (`demo_18_preroll_check.sh:42-55`) and cleanup deletes them
(`demo_50_cleanup_configure.sh:27-45`). The manifests here are designed from
the shapes those consumers expect:

- NodePool names/labels: `demo_00_env.sh:18-19` (`spot-preferred`,
  `on-demand-slo`), `demo_10_setup_configure.sh:59-62`
  (`autoscale.strategy=cost|slo`, `carbon.simulated=low|medium`);
- requirements layout: the jsonpath the profiles patch and re-read
  (`demo_20_offpeak_configure.sh:64-81,102`) — zone + capacity-type `In`
  requirements under `/spec/template/spec`;
- neutral disruption: `WhenEmpty/30s` (`demo_19_reset_policies.sh:22-29`,
  asserted by preroll `demo_18:42-55`);
- EC2NodeClass name `default-ec2`: `demo_50_cleanup_configure.sh:43-44`
  (the reference is internally inconsistent — `demo_30_burst_observe.sh:47`
  probes `default-class`; cleanup's name is taken as canonical since it is
  the one that must match for teardown to work);
- node IAM role naming: `05_karpenter.sh:33-53` (`KarpenterNodeRole-<cluster>`).

Teardown follows demo_50's hard-won ordering: NodePools first (stops new
provisioning), NodeClaims with finalizer-scrub rescue, then the optional
NodeClass wipe.
"""

from __future__ import annotations

from ccka_tpu_torch.actuation.sink import ActuationSink, ApplyResult
from ccka_tpu_torch.config import ClusterConfig, FrameworkConfig, PoolSpec

NODECLASS_NAME = "default-ec2"   # demo_50_cleanup_configure.sh:43-44
_STRATEGY_CARBON = {"cost": "low", "slo": "medium"}  # demo_10:59-62


def render_nodepool_manifest(cluster: ClusterConfig,
                             pool: PoolSpec) -> dict:
    """A Karpenter v1 NodePool CR in its neutral (preroll-passing) state."""
    zones = list(cluster.zones)
    cts = [ct for ct in ("spot", "on-demand") if ct in pool.capacity_types]
    # CPU limit caps the pool at max_nodes instances of the configured type.
    cpu_limit = int(pool.max_nodes * cluster.node_type.vcpu)
    return {
        "apiVersion": "karpenter.sh/v1",
        "kind": "NodePool",
        "metadata": {
            "name": pool.name,
            "labels": {
                "autoscale.strategy": pool.strategy,
                "carbon.simulated": _STRATEGY_CARBON[pool.strategy],
            },
        },
        "spec": {
            "template": {
                "spec": {
                    "requirements": [
                        {"key": "topology.kubernetes.io/zone",
                         "operator": "In", "values": zones},
                        {"key": "karpenter.sh/capacity-type",
                         "operator": "In", "values": cts},
                        {"key": "node.kubernetes.io/instance-type",
                         "operator": "In",
                         "values": [cluster.node_type.name]},
                    ],
                    "nodeClassRef": {
                        "group": "karpenter.k8s.aws",
                        "kind": "EC2NodeClass",
                        "name": NODECLASS_NAME,
                    },
                    "expireAfter": "720h",
                },
            },
            "disruption": {
                "consolidationPolicy": "WhenEmpty",
                "consolidateAfter": "30s",
            },
            "limits": {"cpu": str(cpu_limit)},
        },
    }


def karpenter_node_role(cluster: ClusterConfig) -> str:
    """Node IAM role name, `05_karpenter.sh:33-53` convention — the single
    encoding shared by the EC2NodeClass, the aws-auth mapping and the
    preroll gate (divergence would launch nodes under one role while
    mapping another)."""
    return f"KarpenterNodeRole-{cluster.name}"


def render_ec2nodeclass_manifest(cluster: ClusterConfig) -> dict:
    """The EC2NodeClass every NodePool references; discovery by the
    standard `karpenter.sh/discovery=<cluster>` tag convention."""
    discovery = {"karpenter.sh/discovery": cluster.name}
    return {
        "apiVersion": "karpenter.k8s.aws/v1",
        "kind": "EC2NodeClass",
        "metadata": {"name": NODECLASS_NAME},
        "spec": {
            "amiSelectorTerms": [{"alias": "al2023@latest"}],
            "role": karpenter_node_role(cluster),  # 05_karpenter:33
            "subnetSelectorTerms": [{"tags": discovery}],
            "securityGroupSelectorTerms": [{"tags": discovery}],
        },
    }


def bootstrap(cfg: FrameworkConfig, sink: ActuationSink) -> list[ApplyResult]:
    """Create (idempotently — apply semantics) the NodeClass then every
    NodePool; each apply is read back before the next proceeds."""
    results = [sink.apply_manifest(render_ec2nodeclass_manifest(cfg.cluster))]
    if not results[0].ok:
        return results  # pools would dangle without their NodeClass
    for pool in cfg.cluster.pools:
        results.append(
            sink.apply_manifest(render_nodepool_manifest(cfg.cluster, pool)))
    return results


def mapped_role_arns(map_roles: str) -> list[str]:
    """All rolearn values in a mapRoles blob — the one parser shared by
    the mapping writer and the preroll gate, so the two can never disagree
    about the same ConfigMap. Tolerant of every encoding
    aws-iam-authenticator accepts: block-style YAML (what demo_15 and
    this module write), flow mappings (``- {rolearn: ..., username: ...}``)
    and JSON strings (``"rolearn": "arn:..."``)."""
    import re

    # "," is excluded from the value class: IAM technically allows it in
    # role names, but in flow mappings it is the entry delimiter — and a
    # comma'd role name in aws-auth is unheard of.
    return [m.group(1) for m in re.finditer(
        r"rolearn[\"']?\s*:\s*[\"']?([A-Za-z0-9:/._+=@-]+)", map_roles)]


def role_mapped(map_roles: str, *, role_arn: str | None = None,
                role_name: str | None = None) -> bool:
    """True iff a rolearn entry matches exactly. ``role_arn`` compares the
    full ARN; ``role_name`` compares the ARN's trailing role segment
    (for callers like preroll that don't know the account id). Exact
    matching, never substrings — a prefix collision (cluster ``demo1`` vs
    ``KarpenterNodeRole-demo10``) or the role name appearing in a
    username/groups value must not count as mapped."""
    for arn in mapped_role_arns(map_roles):
        if role_arn is not None and arn == role_arn:
            return True
        if role_name is not None and arn.rsplit("/", 1)[-1] == role_name:
            return True
    return False


def _role_mapping_block(role_arn: str) -> str:
    """One mapRoles entry, the exact block demo_15 patches in (`:55-63`)."""
    return ("- rolearn: " + role_arn + "\n"
            "  username: system:node:{{EC2PrivateDNSName}}\n"
            "  groups:\n"
            "    - system:bootstrappers\n"
            "    - system:nodes\n")


def ensure_node_role_mapping(cfg: FrameworkConfig, sink: ActuationSink,
                             *, account_id: str) -> ApplyResult:
    """Map the Karpenter node role into aws-auth — `demo_15_map_karp_nodes.sh`.

    Without this mapping, Karpenter provisions EC2 instances that can never
    join the cluster (the failure mode demo_15 exists to prevent, `:5-12`).
    Same discipline as the reference's ConfigMap fallback path (`:49-72`):
    grep-check the mapRoles blob for the role, append the mapping block if
    absent, re-apply, verify by read-back. Idempotent — a present mapping
    is a no-op success, like the reference's early exit (`:33-36`).
    """
    if not account_id:
        return ApplyResult("configmap/aws-auth", ok=False,
                           used_fallback=False,
                           detail="account_id required to form the role ARN")
    role = karpenter_node_role(cfg.cluster)
    role_arn = f"arn:aws:iam::{account_id}:role/{role}"
    cm = sink.get_object("configmap", "aws-auth", namespace="kube-system")
    if not cm:
        return ApplyResult("configmap/aws-auth", ok=False,
                           used_fallback=False,
                           detail="aws-auth ConfigMap not found (is this an "
                                  "EKS cluster with kubectl access?)")
    data = dict(cm.get("data", {}))
    map_roles = data.get("mapRoles", "") or ""
    if role_mapped(map_roles, role_arn=role_arn):  # demo_15:33-36 early exit
        return ApplyResult("configmap/aws-auth", ok=True,
                           used_fallback=False, detail="already mapped")
    sep = "" if (not map_roles or map_roles.endswith("\n")) else "\n"
    data["mapRoles"] = map_roles + sep + _role_mapping_block(role_arn)
    updated = {**cm, "data": data}
    updated.setdefault("metadata", {}).setdefault("name", "aws-auth")
    updated["metadata"].setdefault("namespace", "kube-system")
    result = sink.apply_manifest(updated)
    if not result.ok:
        return result
    # demo_15:80-85 verify: read back and grep again.
    back = sink.get_object("configmap", "aws-auth", namespace="kube-system")
    if not role_mapped(back.get("data", {}).get("mapRoles", "") or "",
                       role_arn=role_arn):
        return ApplyResult("configmap/aws-auth", ok=False,
                           used_fallback=False,
                           detail="mapping not present after apply")
    return ApplyResult("configmap/aws-auth", ok=True, used_fallback=False,
                       detail=f"mapped {role}")


def cleanup(cfg: FrameworkConfig, sink: ActuationSink, *,
            wipe_nodeclass: bool = False,
            namespace: str = "nov-22") -> list[tuple[str, bool]]:
    """Teardown in demo_50's order (`demo_50_cleanup_configure.sh:17-45`):

    1. demo namespace (burst workloads, PDB — demo_50:20-24);
    2. NodePools FIRST, stopping further provisioning (demo_50:27-28);
    3. NodeClaims no-wait with finalizer-scrub rescue (demo_50:31-35);
    4. optional EC2NodeClass wipe (WIPE_NODECLASS analog, demo_50:42-45).
    """
    out: list[tuple[str, bool]] = []
    out.append((f"namespace/{namespace}",
                sink.delete_object("namespace", namespace)))
    for pool in cfg.cluster.pools:
        out.append((f"nodepool/{pool.name}",
                    sink.delete_object("nodepool", pool.name)))
    for pool in cfg.cluster.pools:
        # NodeClaim names are Karpenter-generated; reach them via their
        # `karpenter.sh/nodepool` label (the same selector demo_50:38-39
        # uses for the nodes themselves).
        out.append((f"nodeclaims[{pool.name}]",
                    sink.delete_object(
                        "nodeclaims",
                        selector=f"karpenter.sh/nodepool={pool.name}")))
    if wipe_nodeclass:
        out.append((f"ec2nodeclass/{NODECLASS_NAME}",
                    sink.delete_object("ec2nodeclass", NODECLASS_NAME)))
    return out
