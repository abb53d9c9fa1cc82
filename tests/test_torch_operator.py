"""The port's operator tools against the JAX package's: guardrails,
bootstrap, burst, preroll, watch, dashboard and the metrics pipeline.

The tools render dicts and kubectl command streams on the host, so the
standard is byte for byte: every manifest ``json.dumps(..., sort_keys=
True)`` equal to JAX's, every argv stream a fake kubectl records equal to
the one it records for JAX (a manifest's temp-file path replaced by the
file's content), every DryRunSink transcript equal. Preroll's two
accelerator rows are the card's in the port (`torch-device`,
`kernels-build` for JAX's `jax-backend`, `simulator-compiles`); every
other row is held against JAX's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import socket

import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.actuation import burst as jburst
from ccka_tpu.actuation import guardrails as jguard
from ccka_tpu.actuation.sink import KubectlSink as JKubectlSink
from ccka_tpu.harness import dashboard as jdash
from ccka_tpu.harness import pipeline as jpipe
from ccka_tpu.harness import preroll as jpre
from ccka_tpu.harness import promexport as jprom
from ccka_tpu.harness import watch as jwatch
from ccka_tpu_torch.actuation import bootstrap, burst, guardrails
from ccka_tpu_torch.actuation.sink import KubectlSink
from ccka_tpu_torch.harness import dashboard, pipeline, preroll, promexport
from ccka_tpu_torch.harness import watch

# The JAX package's actuation/__init__ exports a function named bootstrap.
jboot = importlib.import_module("ccka_tpu.actuation.bootstrap")


def _dump(doc) -> str:
    return json.dumps(doc, sort_keys=True)


def _cfgs(preset: str = "default", **overrides):
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    if overrides:
        jc, tc = jc.with_overrides(**overrides), tc.with_overrides(**overrides)
    return jc, tc


_WORKLOAD = {"workload.deployments": 5, "workload.replicas": 3,
             "workload.pod_cpu_request": 0.35,
             "workload.pod_mem_request_gib": 0.3,
             "workload.pdb_min_available": 0.25,
             "workload.namespace": "load-x"}


def _manifest_cases():
    """(name, JAX renderer, port renderer) over the tools' manifests."""
    def boot(preset):
        def render(mod, cfgmod):
            cfg = cfgmod.PRESETS[preset]()
            return ([mod.render_ec2nodeclass_manifest(cfg.cluster)]
                    + [mod.render_nodepool_manifest(cfg.cluster, p)
                       for p in cfg.cluster.pools]
                    + [mod.karpenter_node_role(cfg.cluster)])
        return (lambda: render(jboot, jcfg), lambda: render(bootstrap, tcfg))

    def burst_docs(overrides, count=None, replicas=None, ns="nov-22"):
        def render(mod, cfgmod):
            wl = cfgmod.default_config().with_overrides(**overrides).workload
            return (mod.render_burst_rbac(ns)
                    + [mod.render_burst_pdb(wl, ns)]
                    + mod.render_burst_deployments(wl, ns, count=count,
                                                   replicas=replicas))
        return (lambda: render(jburst, jcfg), lambda: render(burst, tcfg))

    url, ns = "http://amp.example:8005/workspaces/ws-1", "obs-ns"
    cases = {
        "guardrails": (jguard.render_guardrails,
                       guardrails.render_guardrails),
        "hardened-context": (
            lambda: [jguard.hardened_pod_security_context(),
                     jguard.hardened_pod_security_context(472, 472, 472),
                     jguard.HARDENED_CONTAINER_SECURITY_CONTEXT],
            lambda: [guardrails.hardened_pod_security_context(),
                     guardrails.hardened_pod_security_context(472, 472, 472),
                     guardrails.HARDENED_CONTAINER_SECURITY_CONTEXT]),
        "bootstrap-default": boot("default"),
        "bootstrap-multiregion": boot("multiregion"),
        "burst-default": burst_docs({}),
        "burst-overridden": burst_docs(_WORKLOAD, count=7, replicas=2,
                                       ns="load-x"),
        "dashboard": (lambda: [jdash.render_dashboard(),
                               jdash.render_dashboard("other")],
                      lambda: [dashboard.render_dashboard(),
                               dashboard.render_dashboard("other")]),
        "dashboard-stack": (
            lambda: jdash.render_observability_stack(url, ns),
            lambda: dashboard.render_observability_stack(url, ns)),
        "dashboard-configmap": (
            lambda: jdash.render_dashboard_configmap(url, ns),
            lambda: dashboard.render_dashboard_configmap(url, ns)),
    }
    for tag, kw in (("plain", {}),
                    ("sigv4-proxy", dict(region="us-west-2",
                                         writer_role_arn="arn:w",
                                         query_role_arn="arn:q",
                                         proxy=True))):
        cases[f"pipeline-{tag}"] = (
            lambda kw=kw: jpipe.render_metrics_pipeline(url, ns, **kw),
            lambda kw=kw: pipeline.render_metrics_pipeline(url, ns, **kw))
    return cases


_MANIFESTS = _manifest_cases()


@pytest.fixture()
def fixed_password(monkeypatch):
    """The Grafana admin Secret's random password, fixed for both."""
    import secrets

    monkeypatch.setattr(secrets, "token_urlsafe", lambda n: f"pw-{n}")


@pytest.mark.parametrize("name", sorted(_MANIFESTS))
def test_manifests_byte_identical(name, fixed_password):
    want, got = (fn() for fn in _MANIFESTS[name])
    assert _dump(got) == _dump(want)


def test_pipeline_refuses_what_jax_refuses():
    with pytest.raises(ValueError) as jerr:
        jpipe.render_metrics_pipeline("http://x", "ns", proxy=True)
    with pytest.raises(ValueError) as terr:
        pipeline.render_metrics_pipeline("http://x", "ns", proxy=True)
    assert str(terr.value) == str(jerr.value)


def test_pending_pod_diagnostics_and_role_matchers():
    pods = [
        {"metadata": {"name": "a"}, "status": {
            "phase": "Pending", "conditions": [{
                "type": "PodScheduled", "status": "False",
                "reason": "Unschedulable", "message": "0/3 nodes"}]},
         "spec": {"nodeSelector": {"karpenter.sh/capacity-type": "spot"}}},
        {"metadata": {"name": "b"}, "status": {"phase": "Running"}},
        {"metadata": {"name": "c"}, "status": {"phase": "Pending"}},
    ]
    assert burst.pending_pod_diagnostics(pods) == \
        jburst.pending_pod_diagnostics(pods)
    blobs = ['- rolearn: arn:aws:iam::1:role/KarpenterNodeRole-demo1\n',
             '- {rolearn: "arn:aws:iam::1:role/KarpenterNodeRole-demo10", '
             'username: x}', '"rolearn": "arn:aws:iam::2:role/other"', ""]
    for blob in blobs:
        assert bootstrap.mapped_role_arns(blob) == \
            jboot.mapped_role_arns(blob)
        for kw in ({"role_name": "KarpenterNodeRole-demo1"},
                   {"role_arn": "arn:aws:iam::2:role/other"}):
            assert bootstrap.role_mapped(blob, **kw) == \
                jboot.role_mapped(blob, **kw)


class FakeKubectl:
    """A kubectl stand-in holding objects by (kind, namespace, name):
    apply -f, get (by name or label selector, -o json), delete (by name
    or selector) and patch. Records every argv, a manifest's temp-file
    path replaced by the file's JSON."""

    def __init__(self, objects=()):
        self.store = {}
        self.calls = []
        for doc in objects:
            self._put(doc)

    @staticmethod
    def _key(kind, ns, name):
        return (kind.lower().rstrip("s"), ns or "", name)

    def _put(self, doc):
        md = doc["metadata"]
        self.store[self._key(doc["kind"], md.get("namespace"),
                             md["name"])] = doc

    @staticmethod
    def _opt(argv, flag):
        return argv[argv.index(flag) + 1] if flag in argv else ""

    def __call__(self, argv):
        argv = list(argv)
        rec = list(argv)
        verb = argv[1]
        ns = self._opt(argv, "-n")
        if verb == "apply":
            path = self._opt(argv, "-f")
            with open(path) as fh:
                doc = json.load(fh)
            rec[rec.index(path)] = _dump(doc)
            self.calls.append(rec)
            if ns and "namespace" not in doc["metadata"]:
                doc["metadata"]["namespace"] = ns
            self._put(doc)
            return 0, "applied"
        self.calls.append(rec)
        kind = argv[2]
        sel = self._opt(argv, "-l")
        name = (argv[3] if len(argv) > 3 and not argv[3].startswith("-")
                else "")
        if verb == "get":
            if name:
                doc = self.store.get(self._key(kind, ns, name))
                if doc is None:
                    return 1, f'Error from server (NotFound): "{name}"'
                if "jsonpath={.data.mapRoles}" in argv:
                    return 0, doc.get("data", {}).get("mapRoles", "")
                return 0, json.dumps(doc)
            return 0, json.dumps({"items": self._select(kind, ns, sel)})
        if verb == "delete":
            keys = ([self._key(kind, ns, name)] if name else
                    [self._key(d["kind"], ns, d["metadata"]["name"])
                     for d in self._select(kind, ns, sel)])
            for k in keys:
                self.store.pop(k, None)
            return 0, "deleted"
        return 0, ""

    def _select(self, kind, ns, sel):
        k, _, v = sel.partition("=")
        return [doc for (kd, n, _), doc in sorted(self.store.items())
                if kd == self._key(kind, ns, "")[0]
                and (not ns or n == ns)
                and (not sel or doc["metadata"].get("labels", {}).get(k)
                     == v)]


def _deployment(name, capacity, replicas, ready, ns="nov-22"):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": ns,
                         "labels": {"group": "scale-burst",
                                    "capacity": capacity}},
            "spec": {"replicas": replicas},
            "status": {"readyReplicas": ready}}


_CANNED = [
    {"apiVersion": "v1", "kind": "ConfigMap",
     "metadata": {"name": "aws-auth", "namespace": "kube-system"},
     "data": {"mapRoles": "- rolearn: arn:aws:iam::9:role/other\n"
                          "  username: x\n"}},
    _deployment("burst-web-1", "spot", 5, 5),
    _deployment("burst-web-2", "on-demand", 5, 3),
    _deployment("burst-web-4", "on-demand", 5, 0),
    {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
     "metadata": {"name": "burst-pdb", "namespace": "nov-22"}},
]


def _jsonable(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


_STREAMS = {
    "map-nodes": lambda boot, burst_, cfg, sink: boot.ensure_node_role_mapping(
        cfg, sink, account_id="123456789012"),
    "map-nodes-twice": lambda boot, burst_, cfg, sink: [
        boot.ensure_node_role_mapping(cfg, sink, account_id="1"),
        boot.ensure_node_role_mapping(cfg, sink, account_id="1")],
    "cleanup": lambda boot, burst_, cfg, sink: boot.cleanup(cfg, sink),
    "cleanup-wipe-nodeclass": lambda boot, burst_, cfg, sink: boot.cleanup(
        cfg, sink, wipe_nodeclass=True),
    "bootstrap": lambda boot, burst_, cfg, sink: boot.bootstrap(cfg, sink),
    "burst-status": lambda boot, burst_, cfg, sink: burst_.burst_status(
        sink),
    "burst-delete": lambda boot, burst_, cfg, sink: [
        burst_.delete_burst(sink), burst_.burst_status(sink)],
    "burst-apply": lambda boot, burst_, cfg, sink: burst_.apply_burst(
        cfg.workload, sink, count=3, replicas=2),
}


@pytest.mark.parametrize("preset", ["default", "multiregion"])
@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_kubectl_streams_match_jax(name, preset):
    """The same canned cluster under a fake kubectl: the argv stream
    and the results are JAX's."""
    jc, tc = _cfgs(preset)
    out = []
    for boot, burst_, cfg, sink_cls in ((jboot, jburst, jc, JKubectlSink),
                                        (bootstrap, burst, tc, KubectlSink)):
        fake = FakeKubectl(json.loads(json.dumps(_CANNED)))
        result = _STREAMS[name](boot, burst_, cfg, sink_cls(fake))
        out.append((fake.calls, _jsonable(result)))
    (jcalls, jres), (tcalls, tres) = out
    assert tcalls == jcalls
    assert _dump(tres) == _dump(jres)
    assert tcalls  # the fake saw the tool's commands


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["bootstrap"], ["bootstrap", "--json"],
    ["--preset", "multiregion", "bootstrap"],
    ["guardrails"], ["guardrails", "--json"],
    ["map-nodes", "--account-id", "123456789012"],
    ["cleanup"], ["cleanup", "--wipe-nodeclass"],
    ["burst"], ["burst", "--json", "--count", "3", "--replicas", "2"],
    ["burst", "--status"], ["burst", "--delete"],
    ["--set", "workload.namespace=load-x", "burst", "--namespace", "b"],
    ["watch"], ["dashboard"], ["dashboard", "--json"],
    ["dashboard", "--provision-only"],
    ["pipeline"], ["pipeline", "--json", "--region", "us-east-1",
                   "--proxy", "--query-role-arn", "arn:q"],
], ids=lambda a: " ".join(a))
def test_dry_run_transcripts_match_jax(argv, fixed_password):
    """Every operator subcommand's dry run (DryRunSink transcripts and
    --json manifests): stdout, stderr and exit code are JAX's."""
    from ccka_tpu.cli import main as jmain
    from ccka_tpu_torch.cli import main as tmain

    assert _run(tmain, argv) == _run(jmain, argv)


def test_operator_refusals_match_jax():
    from ccka_tpu.cli import main as jmain
    from ccka_tpu_torch.cli import main as tmain

    for argv in (["burst", "--json", "--status"],
                 ["pipeline", "--query-role-arn", "arn:q"],
                 ["pipeline", "--proxy"]):
        with pytest.raises(SystemExit) as jerr:
            _run(jmain, argv)
        with pytest.raises(SystemExit) as terr:
            _run(tmain, argv)
        assert str(terr.value) == str(jerr.value), argv


# ---- watch


def test_watch_plan_matches_jax():
    for overrides in ({}, {"signals.prometheus_url": "http://localhost:9999/"
                                                      "ws",
                           "signals.opencost_url": "https://oc.example"}):
        jc, tc = _cfgs(**overrides)
        want = [dataclasses.asdict(f) | {"argv": f.argv()}
                for f in jwatch.watch_plan(jc)]
        got = [dataclasses.asdict(f) | {"argv": f.argv()}
               for f in watch.watch_plan(tc)]
        assert got == want


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _session_cfg():
    return tcfg.default_config().with_overrides(**{
        "signals.prometheus_url": f"http://localhost:{_free_port()}/ws",
        "signals.opencost_url": f"http://localhost:{_free_port()}"})


def test_watch_session_readiness_under_fake_spawners():
    """Listening tunnels are ready and smoke-queried; a child that died
    is not ready even when its socket answers; teardown terminates every
    child."""
    cfg = _session_cfg()
    spawned, terminated, listeners = [], [], []

    class FakePF:
        dead = False

        def __init__(self, argv):
            spawned.append(list(argv))
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", int(argv[-1].split(":")[0])))
            s.listen(1)
            listeners.append(s)

        def poll(self):
            return 1 if self.dead else None

        def terminate(self):
            terminated.append(1)

    def fetch(url, headers):
        if "label/__name__" in url:
            return json.dumps({"status": "success",
                               "data": ["up", "ccka_cost_usd_hr"]}).encode()
        return json.dumps({"status": "success", "data": {"result": [
            {"metric": {}, "value": [0, "1"]}]}}).encode()

    probe = socket.socket()
    try:
        probe.bind(("127.0.0.1", watch.GRAFANA_PORT))
        grafana_free = True
    except OSError:
        grafana_free = False
    finally:
        probe.close()
    try:
        with watch.WatchSession(cfg, spawner=FakePF, fetch=fetch,
                                sleep=lambda _s: None,
                                socket_timeout_s=2.0) as session:
            ready = session.start()
            smoke = session.smoke()
    finally:
        for s in listeners:
            s.close()
    assert ready["prometheus"] and ready["opencost"], ready
    assert ready["grafana"] is grafana_free
    assert smoke["reachable"] and smoke["has_ccka_series"]
    assert smoke["metric_names"] == 2 and smoke["up_series"] == 1
    assert len(terminated) == len(spawned) == 2 + grafana_free

    listeners.clear()
    FakePF.dead = True
    session = watch.WatchSession(_session_cfg(), spawner=FakePF,
                                 sleep=lambda _s: None, socket_timeout_s=1.0)
    try:
        ready = session.start()
    finally:
        session.stop()
        for s in listeners:
            s.close()
    assert not any(ready.values())

    def dead_fetch(url, headers):
        raise OSError("connection refused")

    assert watch.WatchSession(cfg, fetch=dead_fetch).smoke()[
        "reachable"] is False


# ---- preroll

_DEVICE_ROWS = {"jax-backend": "torch-device",
                "simulator-compiles": "kernels-build"}


def _rows(text: str) -> list[str]:
    """The PASS/FAIL rows without the two accelerator rows."""
    return [ln for ln in text.splitlines()
            if ln.startswith("[") and not any(
                f"] {name}" in ln for name in
                list(_DEVICE_ROWS) + list(_DEVICE_ROWS.values()))]


def _kubectl_env(policy, burst_out, roles=(0, "- rolearn: arn:aws:iam::1:"
                                                "role/KarpenterNodeRole-"
                                                "demo1")):
    def runner(argv):
        joined = " ".join(argv)
        if "get deploy" in joined:
            return burst_out
        if "configmap aws-auth" in joined:
            return roles
        return policy
    return runner


@pytest.mark.parametrize("env", [
    ("healthy", _kubectl_env((0, "WhenEmpty"), (0, ""))),
    ("not-neutral", _kubectl_env((0, "WhenEmptyOrUnderutilized"), (0, ""))),
    ("leftover-burst", _kubectl_env((0, "WhenEmpty"),
                                    (0, "deployment.apps/burst-web-1\n"))),
    ("unmapped", _kubectl_env((0, "WhenEmpty"), (0, ""),
                              (0, "- rolearn: arn:aws:iam::1:role/other"))),
    ("unreachable", lambda argv: (1, "The connection to the server was "
                                     "refused")),
    ("missing", lambda argv: (1, "Error from server (NotFound)")),
], ids=lambda e: e[0])
def test_live_preroll_rows_match_jax(env):
    """Live preroll under a fake kubectl: every row but the two
    accelerator rows is JAX's, and so is the exit code when those pass."""
    _name, runner = env
    jc, tc = _cfgs()
    jrc, jout, _ = _run(lambda _a: jpre.run_preroll(jc, live=True,
                                                    runner=runner), [])
    trc, tout, _ = _run(lambda _a: preroll.run_preroll(
        tc, live=True, runner=runner, device="cpu"), [])
    assert _rows(tout) == _rows(jout)
    assert trc == jrc
    assert "[PASS] torch-device" in tout and "[PASS] kernels-build" in tout


def test_offline_preroll_on_the_cpu():
    rc, out, _ = _run(lambda _a: preroll.run_preroll(
        tcfg.default_config(), device="cpu"), [])
    assert rc == 0, out
    assert "[PASS] torch-device — cpu" in out
    assert "[PASS] kernels-build — plain 4-tick rollout" in out
    assert _rows(out) == _rows(_run(lambda _a: jpre.run_preroll(
        jcfg.default_config()), [])[1])
    assert preroll._local_ports(tcfg.default_config()) == \
        jpre._local_ports(jcfg.default_config()) == [3000, 8005, 9090]


def test_port_gate_flags_a_squatted_port():
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    port = holder.getsockname()[1]
    try:
        got = preroll.check_ports_free(tcfg.default_config(), ports=[port])
        want = jpre.check_ports_free(jcfg.default_config(), ports=[port])
    finally:
        holder.close()
    assert [(c.name, c.ok, c.hint) for c in got] == \
        [(c.name, c.ok, c.hint) for c in want]
    assert not got[0].ok


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="this host has a CUDA device")
def test_preroll_under_the_default_device_fails_without_a_gpu():
    rc, out, _ = _run(lambda _a: preroll.run_preroll(
        tcfg.default_config()), [])
    assert rc == 1
    assert "[FAIL] torch-device — device cuda asked for" in out
    assert "[FAIL] kernels-build" in out
    assert not preroll.check_torch_device().ok
    assert not preroll.check_torch_device("cuda").ok
    assert not preroll.check_torch_device("meta").ok
    assert preroll.check_torch_device("cpu").ok
    assert not preroll.check_kernels_build(tcfg.default_config()).ok


# ---- the dashboard's panels against the exported series


def test_every_panel_reads_exported_series_both_ways():
    """Each panel expression reads only exported series, and each
    exported series resolves from the controller's TickReport (the
    service-only set from the fleet service's report, JAX's set while
    the service is not ported); the vocabulary is JAX's."""
    from ccka_tpu.harness.service import ServiceTickReport
    from ccka_tpu_torch.harness.controller import TickReport

    assert dashboard._PANEL_DEFS == jdash._PANEL_DEFS
    exported = promexport.exported_series_names()
    assert exported == jprom.exported_series_names()
    assert promexport.SERVICE_ONLY_SERIES == jprom.SERVICE_ONLY_SERIES
    paneled = set()
    for _title, expr, _unit in dashboard._PANEL_DEFS:
        refs = promexport.referenced_series(expr)
        assert refs == jprom.referenced_series(expr)
        assert refs and refs <= exported, expr
        paneled |= refs
    tick_fields = {f.name for f in dataclasses.fields(TickReport)}
    service_fields = {f.name for f in dataclasses.fields(ServiceTickReport)}
    for name, (field, _help) in promexport.SERIES.items():
        base = field.split(".", 1)[0]
        want = (service_fields if name in promexport.SERVICE_ONLY_SERIES
                else tick_fields)
        assert base in want, f"{name} maps to unknown field {field}"
    assert {"ccka_tick_scrape_ms", "ccka_reconcile_diverged",
            "ccka_resumes_total"} <= paneled
