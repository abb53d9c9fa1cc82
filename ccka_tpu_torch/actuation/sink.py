"""Actuation sinks: where rendered patches are applied.

The PyTorch port's form of `ccka_tpu/actuation/sink.py`: a copy: host code, no tensors.

Reproduces the reference's apply-and-verify discipline
(`demo_20_offpeak_configure.sh:84-127`): patch at the primary schema path,
read back via jsonpath, and on an empty read-back retry at the fallback path;
failures dump state for debugging. Two sinks share that logic:

- :class:`DryRunSink` — the `kubectl`-shaped test double the reference never
  had (SURVEY.md §4 "Implication"): records every command, simulates a
  NodePool store, and can replay what *would* have been run;
- :class:`KubectlSink` — shells out to real kubectl. The subprocess runner
  is injectable so live behavior is testable without a cluster.
"""

from __future__ import annotations

import json
import shlex
import subprocess
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Sequence

from ccka_tpu_torch.actuation.patches import (
    FALLBACK_PATH,
    PRIMARY_PATH,
    NodePoolPatchSet,
)

# runner(argv) -> (returncode, stdout)
Runner = Callable[[Sequence[str]], tuple[int, str]]


# Memoized probe results, keyed weakly per runner object: the fleet
# fan-out calls apply_all on many sinks every tick, and re-running
# `inspect.signature` per call site was measurable host work in that hot
# path. Weak keys keep dead runners (closures swapped out by tests) from
# pinning cache rows; unweakreffable callables just re-probe.
_BUDGET_PROBE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _accepts_budget(fn) -> bool:
    """Whether a runner accepts the widened-budget kwargs
    (``timeout_s``/``deadline_s``). Probed ONCE per runner object (see
    cache above) — probing at call time via catch-TypeError would re-run
    a side-effecting kubectl command when a custom runner raises
    TypeError after launching it. Requires BOTH names (or ``**kwargs``):
    a runner taking only one would TypeError on the paired call."""
    try:
        return _BUDGET_PROBE_CACHE[fn]
    except (KeyError, TypeError):
        pass
    import inspect
    try:
        params = inspect.signature(fn).parameters.values()
        names = {p.name for p in params}
        result = ({"timeout_s", "deadline_s"} <= names
                  or any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params))
    except (TypeError, ValueError):
        result = False
    try:
        _BUDGET_PROBE_CACHE[fn] = result
    except TypeError:
        pass                     # unweakreffable callable: probe each time
    return result


@dataclass(frozen=True)
class PatchCommand:
    """One kubectl-equivalent mutation, recorded for audit/replay."""

    resource: str         # e.g. "nodepool"
    name: str
    patch_type: str       # "merge" | "json"
    patch: object         # dict (merge) or list (json)

    def kubectl_argv(self) -> list[str]:
        return ["kubectl", "patch", self.resource, self.name,
                f"--type={self.patch_type}", "-p", json.dumps(self.patch)]

    def render(self) -> str:
        return shlex.join(self.kubectl_argv())


@dataclass(frozen=True)
class ManifestCommand:
    """A whole-object mutation: `kubectl apply -f` / `kubectl delete` /
    node lifecycle verbs (`cordon`/`drain` — the spot-interruption
    response path the reference disabled with Karpenter's
    ``settings.interruptionQueue=""``, `05_karpenter.sh:136`).

    ``selector`` (label selector) replaces ``name`` for bulk deletes —
    e.g. NodeClaims, whose names are Karpenter-generated and only reachable
    via their `karpenter.sh/nodepool` label."""

    action: str           # "apply" | "delete" | "scrub-finalizers"
                          # | "cordon" | "drain"
    kind: str
    name: str = ""
    namespace: str = ""
    doc: object = None    # full manifest for "apply"
    selector: str = ""    # label selector (delete only), e.g. "k=v"
    grace_s: int = 30     # pod grace period for "drain"

    def kubectl_argv(self) -> list[str]:
        ns = ["-n", self.namespace] if self.namespace else []
        if self.action == "apply":
            return ["kubectl", "apply", *ns, "-f", "-"]
        if self.action == "scrub-finalizers":
            return ["kubectl", "patch", self.kind, self.name, *ns,
                    "--type=merge", "-p",
                    json.dumps({"metadata": {"finalizers": []}})]
        if self.action == "cordon":
            return ["kubectl", "cordon", self.name]
        if self.action == "drain":
            # --force covers bare pods the burst generator never creates
            # but an operator might; the grace period stays inside the
            # 120s spot interruption notice window.
            return ["kubectl", "drain", self.name, "--ignore-daemonsets",
                    "--delete-emptydir-data", "--force",
                    f"--grace-period={self.grace_s}",
                    f"--timeout={max(self.grace_s * 2, 60)}s"]
        target = (["-l", self.selector] if self.selector else [self.name])
        return ["kubectl", "delete", self.kind, *target, *ns,
                "--ignore-not-found", "--wait=false"]

    def render(self) -> str:
        line = shlex.join(self.kubectl_argv())
        if self.action == "apply":
            line += " <<'EOF'\n" + json.dumps(self.doc, indent=2) + "\nEOF"
        return line


@dataclass
class ApplyResult:
    pool: str
    ok: bool
    used_fallback: bool
    detail: str = ""


class ActuationSink:
    """Base: apply a pool's patch set with read-back + fallback."""

    def apply_nodepool(self, ps: NodePoolPatchSet) -> ApplyResult:
        # The disruption merge patch is load-bearing: the reference runs it
        # under `set -e` (demo_20:59-60), so a rejection aborts the profile.
        if not self._patch(PatchCommand("nodepool", ps.pool, "merge",
                                        ps.disruption_merge)):
            return ApplyResult(ps.pool, ok=False, used_fallback=False,
                               detail="disruption merge patch rejected: "
                                      + self._dump(ps.pool)[:500])
        # Requirements patch failures are tolerated here; the read-back +
        # fallback below decides (demo_20:96-98).
        self._patch(PatchCommand("nodepool", ps.pool, "json",
                                 ps.requirements_json))
        if self._readback_ok(ps.pool, PRIMARY_PATH):
            return ApplyResult(ps.pool, ok=True, used_fallback=False)
        # demo_20:109-120 — retry at the legacy schema path.
        self._patch(PatchCommand("nodepool", ps.pool, "json",
                                 ps.requirements_json_fallback))
        if self._readback_ok(ps.pool, FALLBACK_PATH):
            return ApplyResult(ps.pool, ok=True, used_fallback=True)
        return ApplyResult(ps.pool, ok=False, used_fallback=True,
                           detail=self._dump(ps.pool))

    def apply_all(self, patchsets: Sequence[NodePoolPatchSet]) -> list[ApplyResult]:
        return [self.apply_nodepool(ps) for ps in patchsets]

    def observed_state(self, pool: str) -> dict:
        """Skeptical read-back for observers: what the cluster actually
        holds now — {"consolidationPolicy": str, "consolidateAfter": str,
        "capacity_types": [..], "zones": [..]} with missing keys absent.
        The observe-script analog (`demo_20_offpeak_observe.sh:8-27`)."""
        raise NotImplementedError

    # -- generic manifests (kubectl apply/delete equivalents) ---------------
    #
    # Closes the reference's §2.3 half-gap: HPA/KEDA objects were *rendered*
    # once but had no apply path (prometheus-adapter installed yet no
    # HPA object, `03_monitoring.sh:17-19`; KEDA stub `.env:10-12`).

    def apply_manifest(self, doc: dict) -> ApplyResult:
        """`kubectl apply -f` + skeptical read-back via :meth:`get_object`."""
        kind = doc.get("kind", "")
        meta = doc.get("metadata", {})
        name = meta.get("name", "")
        ns = meta.get("namespace", "")
        ident = f"{kind}/{name}"
        if not kind or not name:
            return ApplyResult(ident, ok=False, used_fallback=False,
                               detail="manifest missing kind or name")
        if not self._apply(ManifestCommand("apply", kind, name, ns, doc)):
            return ApplyResult(ident, ok=False, used_fallback=False,
                               detail="apply rejected")
        if not self.get_object(kind, name, namespace=ns):
            return ApplyResult(ident, ok=False, used_fallback=False,
                               detail="read-back empty after apply")
        return ApplyResult(ident, ok=True, used_fallback=False)

    def apply_manifests(self, docs: Sequence[dict]) -> list[ApplyResult]:
        return [self.apply_manifest(d) for d in docs]

    def delete_object(self, kind: str, name: str = "", *,
                      namespace: str = "", selector: str = "",
                      scrub_finalizers: bool = False,
                      grace_s: float = 5.0,
                      sleep_fn: Callable[[float], None] | None = None
                      ) -> bool:
        """`kubectl delete --ignore-not-found` by name or label selector.

        With ``scrub_finalizers``, the demo_50 finalizer-scrub rescue
        (`demo_50_cleanup_configure.sh:32-35`) fires only for an object
        observed STUCK: still present ``grace_s`` seconds after the async
        delete — never immediately, which would strip finalizers (e.g.
        `karpenter.sh/termination`) off healthily-terminating objects.
        Selector deletes skip the scrub (no single object to patch)."""
        ok = self._apply(ManifestCommand("delete", kind, name, namespace,
                                         selector=selector))
        if scrub_finalizers and name and self.get_object(
                kind, name, namespace=namespace):
            (sleep_fn or time.sleep)(grace_s)
            if self.get_object(kind, name, namespace=namespace):
                self._apply(ManifestCommand("scrub-finalizers", kind, name,
                                            namespace))
                ok = self._apply(ManifestCommand("delete", kind, name,
                                                 namespace))
        return ok

    def drain_node(self, name: str, *, grace_s: int = 30) -> bool:
        """Cordon then drain — the interruption-warning response the
        reference's disabled interruptionQueue would have provided
        (`05_karpenter.sh:136`). Cordon first so the scheduler stops
        placing pods the drain would immediately evict; the displaced
        pods go Pending, and Karpenter reprovisions under the active
        NodePool requirements (the reprovision half of the sequence)."""
        ok = self._apply(ManifestCommand("cordon", "node", name))
        return self._apply(ManifestCommand("drain", "node", name,
                                           grace_s=grace_s)) and ok

    def get_object(self, kind: str, name: str, *,
                   namespace: str = "") -> dict:
        """Full-object read-back; {} when absent."""
        raise NotImplementedError

    def list_objects(self, kind: str, *, selector: str = "",
                     namespace: str = "") -> list[dict]:
        """`kubectl get <kind> -l <selector> -o json` — all matching
        objects (the burst observer's listing verb,
        `demo_30_burst_observe.sh:10-16`)."""
        raise NotImplementedError

    # -- backend hooks ------------------------------------------------------

    def _patch(self, cmd: PatchCommand) -> bool:
        """Apply one mutation; returns False if the backend rejected it."""
        raise NotImplementedError

    def _apply(self, cmd: ManifestCommand) -> bool:
        """Execute one manifest-level command."""
        raise NotImplementedError

    def _readback_ok(self, pool: str, path_prefix: str) -> bool:
        raise NotImplementedError

    def _dump(self, pool: str) -> str:
        return ""


class DryRunSink(ActuationSink):
    """Records commands and simulates a NodePool store.

    ``schema_path`` lets tests force the fallback branch, mirroring clusters
    whose NodePool CRD uses the legacy template layout.
    """

    def __init__(self, *, schema_path: str = PRIMARY_PATH, echo: bool = False):
        self.commands: list = []          # PatchCommand | ManifestCommand
        self.store: dict[str, dict] = {}  # NodePool patch-level store
        self.objects: dict[tuple, dict] = {}  # (kind, ns, name) -> manifest
        self.schema_path = schema_path
        self.echo = echo

    def _patch(self, cmd: PatchCommand) -> bool:
        self.commands.append(cmd)
        if self.echo:
            print(cmd.render())
        entry = self.store.setdefault(cmd.name, {})
        if cmd.patch_type == "merge":
            _deep_merge(entry, cmd.patch)
        else:
            for oper in cmd.patch:  # single-op patches from patches.py
                # Exact-path acceptance: a legacy-schema store rejects
                # patches addressed at the modern path and vice versa
                # (prefix matching would wrongly accept both, since the
                # primary path nests under the fallback path).
                if oper["path"] == self.schema_path + "/requirements":
                    entry["requirements_at"] = oper["path"]
                    entry["requirements"] = oper["value"]
        return True

    def _apply(self, cmd: ManifestCommand) -> bool:
        self.commands.append(cmd)
        if self.echo:
            print(cmd.render())
        key = (cmd.kind.lower(), cmd.namespace, cmd.name)
        if cmd.action == "apply":
            self.objects[key] = cmd.doc
            if cmd.kind.lower() == "nodepool":
                # Seed the patch-level store so subsequent NodePool patch/
                # observe flows see the bootstrapped object (the round-trip
                # bootstrap -> preroll -> reset the reference never had).
                spec = cmd.doc.get("spec", {})
                entry = self.store.setdefault(cmd.name, {})
                entry["spec"] = {"disruption": dict(spec.get("disruption", {}))}
                reqs = (spec.get("template", {}).get("spec", {})
                        .get("requirements", []))
                if reqs:
                    entry["requirements"] = reqs
                    entry["requirements_at"] = (
                        self.schema_path + "/requirements")
        elif cmd.action == "delete":
            if cmd.selector and "=" in cmd.selector:
                # Label-selector delete (`kubectl delete -l k=v`), as the
                # burst teardown and NodeClaim cleanup use.
                sk, sv = cmd.selector.split("=", 1)
                doomed = [
                    k for k, doc in self.objects.items()
                    if k[0] == cmd.kind.lower()
                    and (not cmd.namespace or k[1] == cmd.namespace)
                    and doc.get("metadata", {}).get("labels", {}).get(sk) == sv
                ]
                for k in doomed:
                    self.objects.pop(k, None)
            else:
                self.objects.pop(key, None)
            if cmd.kind.lower() == "nodepool":
                self.store.pop(cmd.name, None)
        elif cmd.action in ("cordon", "drain"):
            # Simulated node lifecycle: cordon marks unschedulable, drain
            # additionally evicts (recorded as an annotation — the node
            # object survives; Karpenter terminates it asynchronously).
            node = self.objects.get(("node", "", cmd.name))
            if node is None:
                return False          # draining an unknown node fails
            node.setdefault("spec", {})["unschedulable"] = True
            if cmd.action == "drain":
                node.setdefault("metadata", {}).setdefault(
                    "annotations", {})["ccka.io/drained"] = "true"
        # scrub-finalizers is a no-op on the simulated store.
        return True

    def get_object(self, kind: str, name: str, *,
                   namespace: str = "") -> dict:
        return self.objects.get((kind.lower(), namespace, name), {})

    def list_objects(self, kind: str, *, selector: str = "",
                     namespace: str = "") -> list[dict]:
        sk, sv = (selector.split("=", 1) if "=" in selector else ("", ""))
        out = []
        for (k, ns, _name), doc in sorted(self.objects.items()):
            if k != kind.lower():
                continue
            if namespace and ns != namespace:
                continue
            if sk and doc.get("metadata", {}).get("labels", {}).get(sk) != sv:
                continue
            out.append(doc)
        return out

    def _readback_ok(self, pool: str, path_prefix: str) -> bool:
        entry = self.store.get(pool, {})
        at = entry.get("requirements_at", "")
        return at == path_prefix + "/requirements" and bool(
            entry.get("requirements"))

    def _dump(self, pool: str) -> str:
        return json.dumps(self.store.get(pool, {}), indent=2)

    def observed_state(self, pool: str) -> dict:
        entry = self.store.get(pool, {})
        out: dict = {}
        disruption = entry.get("spec", {}).get("disruption", {})
        out.update({k: v for k, v in disruption.items()
                    if k in ("consolidationPolicy", "consolidateAfter")})
        for req in entry.get("requirements", []):
            if req.get("key") == "karpenter.sh/capacity-type":
                out["capacity_types"] = list(req.get("values", []))
            if req.get("key") == "topology.kubernetes.io/zone":
                out["zones"] = list(req.get("values", []))
        return out

    def rendered(self) -> list[str]:
        return [c.render() for c in self.commands]


class KubectlSink(ActuationSink):
    """Live sink: every mutation goes through `kubectl patch`, read-back
    through `kubectl get -o jsonpath` — the same verbs, flags and jsonpath
    expressions as the reference (`demo_20:96,102,117`)."""

    def __init__(self, runner: Runner | None = None):
        self.runner = runner or _subprocess_runner

    @property
    def runner(self) -> Runner:
        return self._runner

    @runner.setter
    def runner(self, fn: Runner) -> None:
        # Re-probed on assignment (not per call): tests swap .runner
        # after construction, and a stale capability bit would hand the
        # new runner kwargs it cannot take.
        self._runner = fn
        self._runner_takes_budget = _accepts_budget(fn)

    def _patch(self, cmd: PatchCommand) -> bool:
        rc, _ = self.runner(cmd.kubectl_argv())
        return rc == 0

    def _apply(self, cmd: ManifestCommand) -> bool:
        if cmd.action == "apply":
            # The runner interface is argv-only (no stdin), so the manifest
            # travels via a temp file — kubectl accepts JSON at -f.
            import os
            import tempfile
            fd, path = tempfile.mkstemp(suffix=".json")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(cmd.doc, f)
                ns = ["-n", cmd.namespace] if cmd.namespace else []
                rc, _ = self.runner(["kubectl", "apply", *ns, "-f", path])
            finally:
                os.unlink(path)
            return rc == 0
        if cmd.action == "drain":
            # A drain legitimately runs up to its own --timeout (2x the
            # pod grace period); the default runner's 30s attempt cap
            # would SIGKILL it mid-eviction. Widen the budget to the
            # command's declared timeout (+ slack) when the runner
            # supports it (injected argv-only test runners don't).
            budget = max(cmd.grace_s * 2, 60) + 15.0
            if self._runner_takes_budget:
                rc, _ = self.runner(cmd.kubectl_argv(), timeout_s=budget,
                                    deadline_s=budget + 10.0)
            else:
                rc, _ = self.runner(cmd.kubectl_argv())
            return rc == 0
        rc, _ = self.runner(cmd.kubectl_argv())
        return rc == 0

    def get_object(self, kind: str, name: str, *,
                   namespace: str = "") -> dict:
        ns = ["-n", namespace] if namespace else []
        rc, out = self.runner(["kubectl", "get", kind, name, *ns,
                               "-o", "json"])
        if rc != 0:
            return {}
        try:
            return json.loads(out)
        except json.JSONDecodeError:
            return {}

    def list_objects(self, kind: str, *, selector: str = "",
                     namespace: str = "") -> list[dict]:
        ns = ["-n", namespace] if namespace else []
        sel = ["-l", selector] if selector else []
        rc, out = self.runner(["kubectl", "get", kind, *sel, *ns,
                               "-o", "json"])
        if rc != 0:
            return []
        try:
            doc = json.loads(out)
        except json.JSONDecodeError:
            return []
        return list(doc.get("items", []))

    def _readback_ok(self, pool: str, path_prefix: str) -> bool:
        # demo_20:102: jsonpath over requirements key/operator/values.
        dotted = path_prefix.lstrip("/").replace("/", ".")
        jp = (f"{{range .{dotted}.requirements[*]}}{{.key}}={{.operator}}:"
              f"{{range .values[*]}}{{.}} {{end}}{{\"\\n\"}}{{end}}")
        rc, out = self.runner(["kubectl", "get", "nodepool", pool,
                               "-o", f"jsonpath={jp}"])
        return rc == 0 and bool(out.strip())

    def _dump(self, pool: str) -> str:
        rc, out = self.runner(["kubectl", "get", "nodepool", pool, "-o", "yaml"])
        return out

    def observed_state(self, pool: str) -> dict:
        rc, raw = self.runner(["kubectl", "get", "nodepool", pool, "-o", "json"])
        if rc != 0:
            return {}
        try:
            doc = json.loads(raw)
        except json.JSONDecodeError:
            return {}
        spec = doc.get("spec", {})
        out: dict = {}
        disruption = spec.get("disruption", {})
        out.update({k: v for k, v in disruption.items()
                    if k in ("consolidationPolicy", "consolidateAfter")})
        reqs = (spec.get("template", {}).get("spec", {}).get("requirements")
                or spec.get("template", {}).get("requirements") or [])
        for req in reqs:
            if req.get("key") == "karpenter.sh/capacity-type":
                out["capacity_types"] = list(req.get("values", []))
            if req.get("key") == "topology.kubernetes.io/zone":
                out["zones"] = list(req.get("values", []))
        return out


def context_runner(context: str, base: Runner | None = None) -> Runner:
    """A runner pinned to one kubeconfig context.

    Inserts ``--context <name>`` right after ``kubectl`` so every command a
    sink issues lands on that context's cluster — the per-region wiring
    live multi-region requires (`RegionSpec.kube_context`). ``base`` is the
    underlying executor (subprocess by default; injectable for tests).
    """
    inner = base or _subprocess_runner
    inner_takes_budget = _accepts_budget(inner)

    def run(argv: Sequence[str], **kw) -> tuple[int, str]:
        # Forward the widened drain budget (timeout_s/deadline_s) so
        # context-pinned fleet sinks keep long evictions alive too — but
        # only when the underlying executor accepts it (injected argv-only
        # test runners don't; silently dropping the kwargs there matches
        # KubectlSink's own capability probe).
        argv = list(argv)
        if argv and argv[0] == "kubectl":
            argv = ["kubectl", "--context", context, *argv[1:]]
        return inner(argv, **kw) if inner_takes_budget else inner(argv)
    return run


# Transient kubectl failure handling. The reference dies fast under
# `set -e`; a long-running controller daemon must instead bound each
# command (a hung kubectl would freeze the control loop mid-tick) and
# absorb transient API-server hiccups with a short
# bounded backoff, never an unbounded retry storm. All attempts + backoff
# share ONE total deadline: a degraded API server costs a tick at most
# ``_RUNNER_DEADLINE_S`` per command, not retries x timeout (the 30s
# control cadence survives a few slow commands, never a multi-minute one).
_RUNNER_TIMEOUT_S = 30.0     # cap for any single attempt
_RUNNER_DEADLINE_S = 45.0    # total budget across attempts + backoff
_RUNNER_RETRIES = 2          # total attempts = 1 + retries
_RUNNER_BACKOFF_S = 0.5      # doubled per retry: 0.5s, 1s


def _subprocess_runner(argv: Sequence[str], *,
                       timeout_s: float = _RUNNER_TIMEOUT_S,
                       deadline_s: float = _RUNNER_DEADLINE_S,
                       retries: int = _RUNNER_RETRIES,
                       backoff_s: float = _RUNNER_BACKOFF_S,
                       sleep=time.sleep,
                       clock=time.monotonic) -> tuple[int, str]:
    last: tuple[int, str] = (127, "not attempted")
    t_end = clock() + deadline_s
    for attempt in range(1 + retries):
        if attempt:
            pause = backoff_s * (2 ** (attempt - 1))
            if clock() + pause >= t_end:
                break        # no budget left for another attempt
            sleep(pause)
        budget = t_end - clock()
        if budget <= 0:
            break
        try:
            proc = subprocess.run(list(argv), capture_output=True,
                                  text=True, timeout=min(timeout_s, budget),
                                  check=False)
            # kubectl writes error detail to stderr; fold it in so failures
            # surface their reason to the operator (dump-state discipline).
            out = proc.stdout
            if proc.returncode != 0 and proc.stderr:
                out = (out + "\n" + proc.stderr).strip()
            if proc.returncode == 0:
                return proc.returncode, out
            last = (proc.returncode, out)
            if not _transient(proc.stderr or out):
                return last          # real errors (NotFound, Forbidden,
                                     # invalid patch) don't deserve retries
        except subprocess.TimeoutExpired as e:
            last = (124, f"timed out after {min(timeout_s, budget):.0f}s: {e}")
        except OSError as e:
            return 127, str(e)       # no kubectl binary — retry can't help
    return last


def _transient(detail: str) -> bool:
    """Retry-worthy failure modes: connectivity + API-server pressure.

    Needles are anchored to specific kubectl/client-go/API-server error
    phrases — a bare "timeout"/"eof" substring would also match
    non-transient output such as `kubectl wait`'s "timed out waiting for
    the condition", re-issuing a command that already mutated state.
    """
    needles = ("connection refused", "connection reset by peer",
               "i/o timeout", "client.timeout exceeded", "dial tcp",
               "no route to host", "tls handshake", "unexpected eof",
               "error from server: eof",  # apiserver dropped mid-request
               "etcdserver", "too many requests", "serviceunavailable")
    low = detail.lower()
    return any(n in low for n in needles)


def _deep_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
