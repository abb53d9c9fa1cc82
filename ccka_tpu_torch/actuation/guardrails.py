"""Kyverno admission guardrails — the `04_kyverno.sh` ClusterPolicies.

The PyTorch port's form of `ccka_tpu/actuation/guardrails.py`: host code,
the same ClusterPolicies byte for byte.

The reference installs Kyverno and applies two custom ClusterPolicies
(`04_kyverno.sh:24-75`): `require-requests-limits` (every container must
carry cpu/memory requests *and* limits, enforce mode, `:24-42`) and
`critical-no-spot-without-pdb` (pods labeled `critical=true` may never
tolerate `karpenter.sh/capacity-type=spot`; the karpenter/kyverno/
kube-system namespaces are excluded, `:47-75`).

The same semantics live in two other layers of this framework — the
differentiable feasibility projection (`policy/constraints.py`) keeps
learned actions admission-valid, and the burst generator emits compliant
pod specs (`actuation/burst.py`). This module renders the *cluster-side*
enforcement itself, so a live deployment carries the identical last-line
guardrails the reference had: defense in depth, not just
valid-by-construction clients.
"""

from __future__ import annotations

from ccka_tpu_torch.actuation.sink import ActuationSink, ApplyResult

EXCLUDED_NAMESPACES = ("karpenter", "kyverno", "kube-system")  # 04:66-69

# The hardened pod/container conventions every workload this framework
# renders must satisfy — its OWN guardrails above plus the reference's
# non-root discipline (`06_opencost.sh:227-236`). ONE definition shared
# by the dashboard and metrics-pipeline renderers so a future tightening
# (e.g. readOnlyRootFilesystem) cannot drift between stacks.
HARDENED_CONTAINER_SECURITY_CONTEXT = {
    "allowPrivilegeEscalation": False,
    "capabilities": {"drop": ["ALL"]},
}


def hardened_pod_security_context(uid: int = 65534,
                                  gid: int | None = None,
                                  fs_group: int | None = None) -> dict:
    """Non-root pod securityContext (uid defaults to nobody; images with
    a baked-in user — Grafana's 472 — pass theirs)."""
    ctx: dict = {
        "runAsNonRoot": True,
        "runAsUser": uid,
        "seccompProfile": {"type": "RuntimeDefault"},
    }
    if gid is not None:
        ctx["runAsGroup"] = gid
    if fs_group is not None:
        ctx["fsGroup"] = fs_group
    return ctx


def render_require_requests_limits() -> dict:
    """`require-requests-limits` (`04_kyverno.sh:24-42`): all containers
    must declare cpu/memory requests and limits, enforced at admission."""
    return {
        "apiVersion": "kyverno.io/v1",
        "kind": "ClusterPolicy",
        "metadata": {"name": "require-requests-limits"},
        "spec": {
            "validationFailureAction": "Enforce",
            "background": True,
            "rules": [{
                "name": "validate-resources",
                "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
                "validate": {
                    "message": "CPU and memory requests and limits are "
                               "required for all containers.",
                    "pattern": {"spec": {"containers": [{
                        "resources": {
                            "requests": {"memory": "?*", "cpu": "?*"},
                            "limits": {"memory": "?*", "cpu": "?*"},
                        },
                    }]}},
                },
            }],
        },
    }


def render_critical_no_spot() -> dict:
    """`critical-no-spot-without-pdb` (`04_kyverno.sh:47-75`): pods labeled
    `critical=true` may never tolerate the spot capacity-type taint —
    the invariant the SLO pool's capacity-type set exists to uphold."""
    return {
        "apiVersion": "kyverno.io/v1",
        "kind": "ClusterPolicy",
        "metadata": {"name": "critical-no-spot-without-pdb"},
        "spec": {
            "validationFailureAction": "Enforce",
            "background": True,
            "rules": [{
                "name": "deny-spot-toleration-for-critical",
                "match": {"any": [{"resources": {
                    "kinds": ["Pod"],
                    "selector": {"matchLabels": {"critical": "true"}},
                }}]},
                "exclude": {"any": [{"resources": {
                    "namespaces": list(EXCLUDED_NAMESPACES)}}]},
                "validate": {
                    "message": "Pods labeled critical=true must not "
                               "tolerate karpenter.sh/capacity-type=spot.",
                    "deny": {"conditions": {"any": [{
                        "key": "{{ request.object.spec.tolerations[?key=="
                               "'karpenter.sh/capacity-type' && value=="
                               "'spot'] | length(@) }}",
                        "operator": "GreaterThan",
                        "value": 0,
                    }]}},
                },
            }],
        },
    }


def render_guardrails() -> list[dict]:
    return [render_require_requests_limits(), render_critical_no_spot()]


def apply_guardrails(sink: ActuationSink) -> list[ApplyResult]:
    """Apply both ClusterPolicies with read-back (the reference applies
    them with plain `kubectl apply` under `set -e`, `04_kyverno.sh:24`)."""
    return sink.apply_manifests(render_guardrails())
