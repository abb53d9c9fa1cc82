"""The port's closed control loop against the JAX package's, on one world.

Both controllers tick a synthetic source started at 08:58, so ticks 0-3
are off-peak and 4+ peak (`tests/test_controller.py:28`), through
dry-run sinks. Standards, set from the dtypes before the runs:

- rule and carbon: identical command streams, and every TickReport
  float within 1e-5 relative (atol 1e-6 for values at 0; pending pods,
  a remainder of the demand, within 1e-5 of the demand's scale): the
  estimate step is the same float32 arithmetic in two frameworks;
- the bridged flagship (JAX's shipped params in both backends):
  identical command streams, floats within 1e-3 (a bf16 torso);
- MPC (2 planner iterations): each replan's objective within 3e-4
  relative (ROADMAP §C's standard for plans across frameworks);
- within the port, across a kill and a resume: bitwise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.actuation.sink import DryRunSink as JDryRunSink
from ccka_tpu.harness import recovery as jrecovery
from ccka_tpu.harness import snapshot as jsnap
from ccka_tpu.harness.controller import Controller as JController
from ccka_tpu.harness.promexport import SERIES as JSERIES
from ccka_tpu.harness.promexport import render_exposition as jrender
from ccka_tpu.harness.telemetry import summarize_telemetry as jsummarize
from ccka_tpu.policy import CarbonAwarePolicy as JCarbonAwarePolicy
from ccka_tpu.policy import RulePolicy as JRulePolicy
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.train.checkpoint import load_params_npz as jload_params
from ccka_tpu.train.flagship import flagship_checkpoint_path as jckpt
from ccka_tpu.train.mpc import MPCBackend as JMPCBackend
from ccka_tpu.train.ppo import PPOBackend as JPPOBackend
from ccka_tpu_torch import bridge, cli
from ccka_tpu_torch.actuation.sink import DryRunSink
from ccka_tpu_torch.harness import recovery, snapshot
from ccka_tpu_torch.harness.controller import (Controller, TickReport,
                                               controller_from_config)
from ccka_tpu_torch.harness.promexport import MetricsExporter
from ccka_tpu_torch.harness.telemetry import (read_telemetry,
                                              summarize_telemetry)
from ccka_tpu_torch.obs.compile import compile_report, stats_for
from ccka_tpu_torch.obs.trace import SpanTracer, validate_chrome_trace
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.train.mpc import MPCBackend
from ccka_tpu_torch.train.ppo import PPOBackend
from ccka_tpu_torch.workloads.types import WorkloadStep

EDGE = 8 * 3600 + 58 * 60
TICKS = 12
FLOATS = ("cost_usd_hr", "carbon_g_hr", "nodes_spot", "nodes_od",
          "pending_pods", "latency_p95_ms", "usd_per_kreq",
          "g_co2_per_kreq", "waste_frac", "denied_nodes", "delayed_nodes",
          "inference_queue_depth", "batch_backlog",
          "inference_slo_violations_total", "batch_deadline_misses_total")
EXACT = ("t", "is_peak", "profile", "applied", "verified", "fallbacks",
         "slo_ok", "degraded", "degraded_ticks_total", "reconcile_retries",
         "reconcile_diverged", "actuation_failures", "resumes_total")
QUIET = dict(interval_s=0.0, log_fn=lambda s: None)
PODS = tcfg.default_config().workload.total_pods


def _sources(cj, ct):
    return (JSource(cj.cluster, cj.workload, cj.sim, cj.signals,
                    start_unix_s=EDGE),
            SyntheticSignalSource(ct.cluster, ct.workload, ct.sim,
                                  ct.signals, start_unix_s=EDGE))


def _backends(name: str, cj, ct):
    if name == "rule":
        return JRulePolicy(cj.cluster), RulePolicy(ct.cluster, device="cpu")
    if name == "carbon":
        return (JCarbonAwarePolicy(cj.cluster),
                CarbonAwarePolicy(ct.cluster, device="cpu"))
    if name == "flagship":
        params, _ = jload_params(jckpt(cj))
        return (JPPOBackend(cj, params),
                PPOBackend(ct, jax.tree.map(np.asarray, params),
                           device="cpu"))
    return (JMPCBackend(cj, horizon=8, iters=2, replan_every=4),
            MPCBackend(ct, horizon=8, iters=2, replan_every=4,
                       device="cpu"))


def _check_reports(jr, tr, rtol: float) -> float:
    """Exact fields equal, floats within ``rtol``; returns the largest
    relative difference."""
    worst = 0.0
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        for f in EXACT:
            assert getattr(a, f) == getattr(b, f), (a.t, f)
        for f in FLOATS:
            x, y = getattr(a, f), getattr(b, f)
            # Pending pods are demand minus what is served (tens of pods
            # each): the difference cancels, so it is held to the
            # standard at the scale of the demand it remains of.
            atol = rtol * PODS if f == "pending_pods" else 1e-6
            assert np.isclose(y, x, rtol=rtol, atol=atol), (a.t, f, x, y)
            if f != "pending_pods":
                worst = max(worst, abs(y - x) / max(abs(x), 1e-6))
    return worst


@pytest.mark.parametrize("preset,name,rtol", [
    ("default", "rule", 1e-5), ("default", "carbon", 1e-5),
    ("multiregion", "rule", 1e-5), ("multiregion", "carbon", 1e-5),
    ("multiregion", "flagship", 1e-3)])
def test_controller_matches_the_reference(preset, name, rtol):
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    sj, st = _sources(cj, ct)
    bj, bt = _backends(name, cj, ct)
    kj, kt = JDryRunSink(), DryRunSink()
    jr = JController(cj, bj, sj, kj, **QUIET).run(TICKS)
    tr = Controller(ct, bt, st, kt, device="cpu", **QUIET).run(TICKS)
    worst = _check_reports(jr, tr, rtol)
    print(f"\n{preset}/{name}: worst TickReport rel diff {worst:.3g}")
    assert [r.is_peak for r in tr] == [False] * 4 + [True] * (TICKS - 4)
    assert kt.rendered() == kj.rendered() and len(kt.commands) > 0
    assert all(r.applied and r.verified for r in tr)


@pytest.mark.parametrize("forecaster", ["oracle", "persistence"])
def test_mpc_controller_objective_matches_the_reference(forecaster):
    """Replans on the source's forecast (oracle) or through a forecaster
    on the observed history: each replan's objective within 3e-4."""
    from ccka_tpu.forecast import make_forecaster as jforecaster
    from ccka_tpu_torch.forecast.base import make_forecaster

    cj, ct = jcfg.PRESETS["multiregion"](), tcfg.PRESETS["multiregion"]()
    sj, st = _sources(cj, ct)
    bj, bt = _backends("mpc", cj, ct)
    bj.forecaster, bt.forecaster = (jforecaster(forecaster),
                                    make_forecaster(forecaster))
    seen = {"j": [], "t": []}
    for key, b in (("j", bj), ("t", bt)):
        inner = b.replan

        def spy(state, window, inner=inner, key=key):
            res = inner(state, window)
            seen[key].append(np.asarray(res.losses).reshape(-1))
            return res
        b.replan = spy
    jr = JController(cj, bj, sj, JDryRunSink(), **QUIET).run(TICKS)
    tr = Controller(ct, bt, st, DryRunSink(), device="cpu", **QUIET).run(
        TICKS)
    assert len(seen["t"]) == len(seen["j"]) == 3        # ticks 0, 4, 8
    for a, b in zip(seen["j"], seen["t"]):
        np.testing.assert_allclose(b, a, rtol=3e-4)
    assert [r.profile for r in tr] == [r.profile for r in jr]
    assert all(r.verified for r in tr)


def test_workload_families_through_the_seam():
    """With families enabled the port's estimate, fed JAX's own arrival
    track, follows JAX's queues within 1e-5."""
    over = {"workloads.enabled": True, "workloads.inference_rate_pods": 30.0,
            "workloads.inference_flash_frac": 0.3,
            "workloads.batch_rate_pods": 20.0,
            "workloads.background_rate_pods": 5.0,
            "workloads.batch_deadline_ticks": 4}
    cj = jcfg.default_config().with_overrides(**over)
    ct = tcfg.default_config().with_overrides(**over)
    sj, st = _sources(cj, ct)
    bj, bt = _backends("rule", cj, ct)
    jc = JController(cj, bj, sj, JDryRunSink(), **QUIET)
    steps = WorkloadStep(**jax.tree.map(np.asarray, jc._wl_steps)._asdict())
    tc = Controller(ct, bt, st, DryRunSink(), device="cpu",
                    workload_steps=steps, **QUIET)
    jr, tr = jc.run(TICKS), tc.run(TICKS)
    _check_reports(jr, tr, 1e-5)
    assert max(r.inference_queue_depth + r.batch_backlog for r in tr) > 0
    assert tr[-1].inference_slo_violations_total == \
        jr[-1].inference_slo_violations_total


@pytest.mark.parametrize("name", ["rule", "carbon"])
def test_degraded_modes_through_a_flaky_source(name):
    """Stale scrapes drive ok -> hold -> rule-fallback identically."""
    cj, ct = jcfg.default_config(), tcfg.default_config()
    sj, st = _sources(cj, ct)
    bj, bt = _backends(name, cj, ct)
    kj, kt = JDryRunSink(), DryRunSink()
    jr = JController(cj, bj, jrecovery._FlakyStaleSource(sj, 0.45), kj,
                     seed=4, degraded_fallback_after=2, **QUIET).run(16)
    tr = Controller(ct, bt, recovery._FlakyStaleSource(st, 0.45), kt,
                    device="cpu", seed=4, degraded_fallback_after=2,
                    **QUIET).run(16)
    _check_reports(jr, tr, 1e-5)
    modes = {r.degraded for r in tr}
    assert {"ok", "hold", "fallback"} <= modes, modes
    assert [r.signal_stale for r in tr] == [r.signal_stale for r in jr]
    assert kt.rendered() == kj.rendered()


def _body_leaves(enc: dict) -> dict:
    return {k: snapshot.decode_array(v) for k, v in enc.items()}


def test_snapshot_leaves_equal_the_reference_body(tmp_path):
    cj, ct = jcfg.PRESETS["multiregion"](), tcfg.PRESETS["multiregion"]()
    for name in ("carbon", "mpc"):
        sj, st = _sources(cj, ct)
        bj, bt = _backends(name, cj, ct)
        pj, pt = str(tmp_path / f"j-{name}"), str(tmp_path / f"t-{name}")
        jc = JController(cj, bj, sj, JDryRunSink(), snapshot_path=pj,
                         **QUIET)
        tc = Controller(ct, bt, st, DryRunSink(), device="cpu",
                        snapshot_path=pt, **QUIET)
        jc.run(6)
        tc.run(6)
        jb, tb = jsnap.load_snapshot(pj), snapshot.load_snapshot(pt)
        assert set(jb) - set(tb) == {"prng_key"}
        assert set(tb) <= set(jb)
        for key in ("state", "last_action") + (
                ("backend_plan",) if name == "mpc" else ()):
            a, b = _body_leaves(jb[key]), _body_leaves(tb[key])
            assert list(a) == list(b), key
            # A plan's coordinates on a kink of the objective land on
            # each framework's own side, up to about 2 lr apart (§C).
            atol = (2 * 10 * ct.train.learning_rate
                    if key == "backend_plan" else 1e-5)
            for leaf in a:
                assert a[leaf].dtype == b[leaf].dtype
                np.testing.assert_allclose(b[leaf], a[leaf], rtol=3e-4,
                                           atol=atol, err_msg=leaf)
        for key in ("next_tick", "seed", "backend", "config_sha256",
                    "degraded", "desired"):
            assert tb[key] == jb[key], key
        # The live tuples too, carried across by the bridge.
        got = snapshot.decode_like(
            bridge.cluster_state(jax.tree.map(np.asarray, jc.state)
                                 ._asdict(), device="cpu"), tb["state"])
        for a, b in zip(got, bridge.cluster_state(
                jax.tree.map(np.asarray, jc.state)._asdict(), "cpu")):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                       atol=1e-5)
        if name == "mpc":
            np.testing.assert_allclose(
                tc.backend._plan.reshape(bj._plan.shape).numpy(),
                bridge.plan_latent(np.asarray(bj._plan), "cpu").numpy(),
                atol=2 * 10 * ct.train.learning_rate)


def test_snapshot_codec_and_refusals(tmp_path):
    ct = tcfg.default_config()
    src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals,
                                start_unix_s=EDGE)
    path = str(tmp_path / "c.snap")
    ctrl = Controller(ct, RulePolicy(ct.cluster, device="cpu"), src,
                      DryRunSink(), device="cpu", snapshot_path=path,
                      seed=3, **QUIET)
    ctrl.run(3)
    body = snapshot.load_snapshot(path)
    assert body["next_tick"] == 3 and "prng_key" not in body
    # Round trip: the decoded tuple is the live one, leaf for leaf.
    one = type(ctrl.state)(*(x[0] for x in ctrl.state))
    back = snapshot.decode_like(one, body["state"])
    assert all(torch.equal(a, b) for a, b in zip(one, back))
    assert back.time_s.shape == ()
    with pytest.raises(snapshot.SnapshotError, match="shape"):
        snapshot.decode_like(ctrl.state, body["state"])
    with pytest.raises(snapshot.SnapshotError, match="missing leaf"):
        snapshot.decode_like(one, {})
    raw = json.load(open(path))
    # Corrupt: the body no longer matches its checksum.
    raw["body"]["next_tick"] = 99
    (tmp_path / "corrupt").write_text(json.dumps(raw))
    with pytest.raises(snapshot.SnapshotError, match="checksum"):
        snapshot.load_snapshot(str(tmp_path / "corrupt"))
    (tmp_path / "torn").write_text(open(path).read()[:-40])
    with pytest.raises(snapshot.SnapshotError, match="torn"):
        snapshot.load_snapshot(str(tmp_path / "torn"))
    raw = json.load(open(path))
    raw["version"] = 2
    (tmp_path / "v2").write_text(json.dumps(raw))
    with pytest.raises(snapshot.SnapshotError, match="version"):
        snapshot.load_snapshot(str(tmp_path / "v2"))
    (tmp_path / "other").write_text(json.dumps({"format": "x"}))
    with pytest.raises(snapshot.SnapshotError, match="not a"):
        snapshot.load_snapshot(str(tmp_path / "other"))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    # Identity refusals: config, backend, seed.
    for kw, match in (
            (dict(cfg=ct.with_overrides(**{"sim.dt_s": 15.0})), "config"),
            (dict(backend=CarbonAwarePolicy(ct.cluster, device="cpu")),
             "backend"),
            (dict(seed=4), "seed")):
        args = dict(cfg=ct, backend=RulePolicy(ct.cluster, device="cpu"),
                    seed=3)
        args.update(kw)
        c2 = Controller(args["cfg"], args["backend"], src, DryRunSink(),
                        device="cpu", seed=args["seed"], **QUIET)
        with pytest.raises(snapshot.SnapshotError, match=match):
            c2.restore(body)
    with pytest.raises(snapshot.SnapshotError, match="kind"):
        ctrl.restore({**body, "kind": "fleet"})


@pytest.mark.parametrize("name", ["rule", "carbon", "mpc"])
def test_kill_and_resume_bitwise_at_every_tick(name, tmp_path):
    """Killed after any completed tick of a 6-tick run under moderate
    chaos and stale scrapes, a fresh controller (with a fresh backend: the
    mpc plan comes back from the snapshot) resumes bitwise."""
    ct = tcfg.default_config()
    def make_backend():
        return _backends(name, jcfg.default_config(), ct)[1]

    for kill in range(1, 6):
        pair = recovery._run_pair(
            ct, make_backend, tcfg.CHAOS_PRESETS["moderate"], 0.15, ticks=6,
            seed=23, kill_tick=kill,
            snap_path=str(tmp_path / f"{name}-{kill}.snap"), device="cpu")
        assert pair["resume_bitwise"], kill
        assert pair["duplicate_patches"] == pair["lost_patches"] == 0
        assert pair["ticks_to_reconverge"] == 0 and pair["resumes"] == 1
        assert pair["usd_ratio"] == pytest.approx(1.0)


def test_kill_and_resume_with_workload_families(tmp_path):
    """Workload families at rates that fill the queues (the JAX test's
    own rates leave the port's queues at 0): killed at ticks 1, 4, 7 and
    10 of 12, a fresh controller resumes with fingerprints, queues and
    the family counters bitwise the uninterrupted run's."""
    ct = tcfg.default_config().with_overrides(**{
        "workloads.enabled": True, "workloads.inference_rate_pods": 30.0,
        "workloads.inference_flash_frac": 0.3,
        "workloads.batch_rate_pods": 20.0,
        "workloads.background_rate_pods": 5.0,
        "workloads.batch_deadline_ticks": 4})
    ticks = 12

    def run(start: int, stop: int, snap: str = ""):
        src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim,
                                    ct.signals, start_unix_s=EDGE)
        ctrl = Controller(ct, RulePolicy(ct.cluster, device="cpu"), src,
                          DryRunSink(), device="cpu", seed=5,
                          snapshot_path=snap, **QUIET)
        if start:
            assert ctrl.restore(snapshot.load_snapshot(snap)) == start
        reports = ctrl.run(stop - start, start_tick=start)
        ctrl.close()
        return reports

    def state(reports):
        return [(recovery._fingerprint(r), r.inference_queue_depth,
                 r.batch_backlog, r.inference_slo_violations_total,
                 r.batch_deadline_misses_total) for r in reports]

    want = state(run(0, ticks))
    assert max(r[1] + r[2] for r in want) > 0  # the queues fill
    for kill in (1, 4, 7, 10):
        snap = str(tmp_path / f"wl-{kill}.snap")
        got = state(run(0, kill, snap) + run(kill, ticks, snap))
        assert got == want, kill


def test_recovery_board_kills_where_the_reference_does():
    kw = dict(policies=("rule",), intensities=("off", "severe"),
              runs_per_cell=2, ticks=6, seed=9)
    got = recovery.recovery_scoreboard(tcfg.default_config(), device="cpu",
                                       **kw)
    want = jrecovery.recovery_scoreboard(jcfg.default_config(), **kw)
    for cell in ("off", "severe"):
        g, w = got["cells"][cell]["rows"]["rule"], \
            want["cells"][cell]["rows"]["rule"]
        assert g["kill_ticks"] == w["kill_ticks"]
        assert g["usd_per_slo_hr_vs_baseline"] == 1.0
        assert g["chaos_injected"] == w["chaos_injected"]
        assert g["degraded_ticks_mean"] == w["degraded_ticks_mean"]
    assert got["invariants"] == {"duplicate_patches_total": 0,
                                 "lost_patches_total": 0,
                                 "resume_bitwise_frac": 1.0}
    assert got["n_paired_runs"] == 4
    with pytest.raises(ValueError, match="unknown policies"):
        recovery.recovery_scoreboard(tcfg.default_config(), device="cpu",
                                     policies=("rulez",))


def test_trace_exporter_telemetry_and_counters(tmp_path):
    ct = tcfg.default_config()
    src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals,
                                start_unix_s=EDGE)
    tracer = SpanTracer(jsonl_path=str(tmp_path / "spans.jsonl"))
    exporter = MetricsExporter(port=0, textfile=str(tmp_path / "m.prom"),
                               cluster=ct.cluster.name)
    before = stats_for("controller.step")
    calls0 = before.calls if before is not None else 0
    try:
        ctrl = Controller(ct, RulePolicy(ct.cluster, device="cpu"), src,
                          DryRunSink(), device="cpu", tracer=tracer,
                          exporter=exporter,
                          telemetry_path=str(tmp_path / "t.jsonl"), **QUIET)
        reports = ctrl.run(5)
        ctrl.close()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/metrics",
                timeout=10) as resp:
            text = resp.read().decode()
    finally:
        exporter.close()
        tracer.close()
    names = {ln.split("{")[0].split()[0] for ln in text.splitlines()
             if ln.startswith("ccka_")}
    assert "ccka_tick_decide_ms" in names and "ccka_resumes_total" in names
    assert names <= set(JSERIES)
    doc = tracer.chrome_trace()
    assert validate_chrome_trace(doc) == []
    path = tracer.write_chrome_trace(str(tmp_path / "trace.json"))
    assert validate_chrome_trace(json.load(open(path))) == []
    stages = {"scrape", "decide", "render", "apply", "verify", "estimate",
              "slo_scrape"}
    assert stages <= {e["name"] for e in doc["traceEvents"]}
    assert sum(1 for _ in open(tmp_path / "spans.jsonl")) == len(
        doc["traceEvents"])
    assert validate_chrome_trace({"traceEvents": [{"ph": "X"}]})
    recs = read_telemetry(str(tmp_path / "t.jsonl"))
    assert [r["t"] for r in recs] == list(range(5))
    assert summarize_telemetry(recs) == jsummarize(recs)
    assert all(set(r.timings_ms) == stages for r in reports)
    s = stats_for("controller.step")
    assert s.calls == calls0 + 5 and s.compiles == 0 and s.recompiles == 0
    assert "controller.step" in compile_report()


def test_entries_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    ct = tcfg.default_config()
    src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals)
    rule = RulePolicy(ct.cluster, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Controller(ct, rule, src, DryRunSink())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        controller_from_config(ct, rule)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.make_backend(ct, "rule")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recovery.recovery_scoreboard(ct, policies=("rule",), ticks=4,
                                     runs_per_cell=1, intensities=("off",))
    # The ledgers are ported: a CPU controller takes them.
    from ccka_tpu_torch.obs.decisions import DecisionLedger
    ledger = DecisionLedger(ct.obs, ct.train, policy="rule")
    Controller(ct, rule, src, DryRunSink(), device="cpu",
               decision_ledger=ledger, **QUIET).tick(0)
    assert ledger.rows_total == 1
    assert isinstance(controller_from_config(ct, rule, device="cpu",
                                             **QUIET).tick(0), TickReport)


def test_cli_run_resume_and_recover_eval(tmp_path, capsys):
    snap, trace = str(tmp_path / "s.snap"), str(tmp_path / "t.json")
    base = ["run", "--device", "cpu", "--interval", "0", "--snapshot", snap]
    assert cli.main(base + ["--ticks", "3", "--trace-out", trace]) == 0
    assert validate_chrome_trace(json.load(open(trace))) == []
    assert cli.main(base + ["--ticks", "5", "--resume"]) == 0
    err = capsys.readouterr().err
    assert "resumed at tick 3" in err and "ran 2 tick(s)" in err
    assert cli.main(["--preset", "multiregion", "run", "--device", "cpu",
                     "--backend", "ppo", "--ticks", "1", "--interval",
                     "0"]) == 0
    assert cli.main(["recover-eval", "--device", "cpu", "--runs", "1",
                     "--ticks", "4", "--intensities", "off",
                     "--policies", "rule"]) == 0
    out = capsys.readouterr().out
    board = json.loads(out[out.index('{\n  "engine"'):])
    assert board["invariants"]["resume_bitwise_frac"] == 1.0
    # The fleet's service layer runs through the command line too.
    assert cli.main(["fleet", "--service", "default", "--device", "cpu",
                     "--clusters", "2", "--ticks", "1"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["service"] == "default"
    with pytest.raises(SystemExit, match="needs --snapshot"):
        cli.main(["run", "--device", "cpu", "--resume"])


def test_python_dash_m_reaches_the_port_cli(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "ccka_tpu_torch", "run", "--device", "cpu",
         "--ticks", "2", "--interval", "0"], cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": root}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["t"] for ln in lines] == [0, 1]


def test_watch_counts_captures_and_warns_on_a_late_one():
    """A watched callable reports its CUDA-graph captures through
    ``captures``: the first is the warm-up, a hot entry's next one is a
    recompile and warns; an entry without the attribute counts calls."""
    from ccka_tpu_torch.obs.compile import watch_jit

    class Graphs:
        def __init__(self):
            self.captures = 0

        def __call__(self, shape):
            if shape not in getattr(self, "seen", set()):
                self.seen = getattr(self, "seen", set()) | {shape}
                self.captures += 1
            return shape

    warned = []
    w = watch_jit(Graphs(), "test.graphs", hot=True, warn=warned.append)
    for shape in (1, 1, 1, 2, 2):
        w(shape)
    s = stats_for("test.graphs")
    assert (s.calls, s.compiles, s.cache_hits, s.recompiles) == (5, 2, 3, 1)
    assert len(warned) == 1 and "RECAPTURED" in warned[0]
    # shared_stats accumulates another owner's captures without a warning.
    w2 = watch_jit(Graphs(), "test.graphs", hot=True, shared_stats=True,
                   warn=warned.append)
    w2(7)
    assert stats_for("test.graphs").compiles == 3 and len(warned) == 1
    plain = watch_jit(lambda x: x + 1, "test.eager", hot=True)
    assert plain(1) == 2 and stats_for("test.eager").compiles == 0
    assert compile_report()["test.eager"]["calls"] == 1


def test_exposition_series_and_profiler_capture(tmp_path):
    from ccka_tpu_torch.harness.promexport import SERIES, render_exposition
    from ccka_tpu_torch.harness.telemetry import profile_trace

    assert SERIES == JSERIES
    rep = TickReport(t=3, is_peak=True, profile="peak", applied=True,
                     verified=True, fallbacks=0, cost_usd_hr=1.5,
                     carbon_g_hr=2.0, nodes_spot=1.0, nodes_od=2.0,
                     pending_pods=0.0, slo_ok=True,
                     timings_ms={"scrape": 1.0, "decide": 2.0})
    assert render_exposition(rep, cluster="c") == jrender(
        dataclasses.asdict(rep), cluster="c")
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert os.listdir(tmp_path / "prof")


def test_service_series_resolve_from_the_service_report():
    """Every service-only series resolves from the port's
    ServiceTickReport, and one report's exposition text is JAX's."""
    from ccka_tpu.harness.promexport import SERVICE_ONLY_SERIES as JONLY
    from ccka_tpu.harness.service import ServiceTickReport as JReport
    from ccka_tpu_torch.harness.promexport import (SERIES,
                                                   SERVICE_ONLY_SERIES,
                                                   render_exposition,
                                                   resolve_field)
    from ccka_tpu_torch.harness.service import ServiceTickReport

    fields = dict(
        t=5, n_tenants=8, admitted=4, deferred=1, shed=2,
        cadence_skipped=0, bulkhead_skipped=1, scrape_failed=1, probes=1,
        applied=6, fanout_deferred=0, slo_ok=7, cost_usd_hr=1.5,
        carbon_g_hr=300.0, pending_pods=2.0, tick_latency_ms=112.5,
        admission_queue_depth=8, sheds_total=24, deferrals_total=9,
        breaker_transitions_total=3, cadence_divisor=2, decide_ms=2.1,
        fanout_ms=4.2, breaker_states={"0": 0, "1": 2, "2": 1},
        slo_burn_rate=0.25, slo_burn_rate_slow=0.125, incident_active=1,
        incidents_total=3, recorder_dumps_total=2,
        program_dispatches_total=123, achieved_roofline_fraction=0.75,
        pipeline_occupancy={"generation": 0.3, "kernel": 0.6, "host": 0.1},
        shard_imbalance=1.25, policy_divergence_rate=0.375,
        objective_term_shares={"cost": 0.7, "carbon": 0.2,
                               "slo_pending": 0.06, "slo_violation": 0.04},
        shadow_slo_delta=-1.0, shadow_usd_delta=0.0125,
        candidate_win_rate={"carbon": 0.7, "rule": 0.4},
        tournament_leader=1, region_migration_rate={"mean": 0.12},
        region_carbon_intensity={"r0": 380.0, "r1": 420.0},
        host_loop_us_per_tenant=0.875, active_tenants=4)
    rec = dataclasses.asdict(ServiceTickReport(**fields))
    assert SERVICE_ONLY_SERIES == JONLY
    names = {f.name for f in dataclasses.fields(ServiceTickReport)}
    for name in SERVICE_ONLY_SERIES:
        spec = SERIES[name][0]
        assert spec.split(".", 1)[0] in names, name
        assert resolve_field(rec, spec) is not None, name
    assert resolve_field(rec, SERIES["ccka_tenant_breaker_state"][0]) == 3
    assert render_exposition(ServiceTickReport(**fields), cluster="f") == \
        jrender(dataclasses.asdict(JReport(**fields)), cluster="f")


class _Feed:
    """A spot-interruption feed: terminate warnings on the first polls (one
    resolvable, one never, one resolvable from tick 2), a rebalance, and
    a redelivery of the first."""

    def __init__(self, warning_cls):
        self.polls, self.W = 0, warning_cls

    def poll(self):
        self.polls += 1
        W = self.W
        return {1: [W("i-0spot1", "terminate", "EC2 Spot"),
                    W("i-0gone", "terminate", "EC2 Spot"),
                    W("i-0late", "terminate", "EC2 Spot"),
                    W("i-0spot1", "rebalance", "Rebalance")],
                3: [W("i-0spot1", "terminate", "EC2 Spot")]}.get(
            self.polls, [])


def test_drains_hpa_and_keda_match_the_reference(tmp_path):
    """The remaining branches side by side: interruption drains (dedupe,
    bounded retry, the estimate decrement) and HPA and KEDA objects every
    tick, under the carbon teacher."""
    from ccka_tpu.signals.live import InterruptionWarning as JW
    from ccka_tpu_torch.signals.live import InterruptionWarning as TW
    from test_controller import _spot_node

    over = {"workload.sqs_queue_name": "q",
            "workload.aws_account_id": "123456789012"}
    cj = jcfg.default_config().with_overrides(**over)
    ct = tcfg.default_config().with_overrides(**over)
    zone = ct.cluster.zones[1]
    out = {}
    for key, cfg, sink_cls, ctl, backend, W in (
            ("j", cj, JDryRunSink, JController,
             JCarbonAwarePolicy(cj.cluster), JW),
            ("t", ct, DryRunSink,
             lambda *a, **k: Controller(*a, device="cpu", **k),
             CarbonAwarePolicy(ct.cluster, device="cpu"), TW)):
        sj, st = _sources(cj, ct)
        sink = sink_cls()
        sink.objects[("node", "", "n1")] = _spot_node("n1", "i-0spot1", zone)
        ctrl = ctl(cfg, backend, sj if key == "j" else st, sink,
                   interruption_feed=_Feed(W), apply_hpa=True,
                   apply_keda=True, **QUIET)
        reports = []
        for t in range(6):
            if t == 2:
                sink.objects[("node", "", "n2")] = _spot_node(
                    "n2", "i-0late", zone)
            reports.append(ctrl.tick(t))
        out[key] = (reports, sink.rendered())
    (jr, jc), (tr, tc) = out["j"], out["t"]
    assert tc == jc
    assert [(r.interruption_warnings, r.nodes_drained) for r in tr] == [
        (r.interruption_warnings, r.nodes_drained) for r in jr]
    assert sum(r.nodes_drained for r in tr) == 2
    assert all("interruptions" in r.timings_ms for r in tr)
    assert any("kind: HorizontalPodAutoscaler" in c or
               '"kind": "HorizontalPodAutoscaler"' in c for c in tc)
    assert any("ScaledObject" in c for c in tc)
    _check_reports(jr, tr, 1e-5)
    with pytest.raises(ValueError, match="apply_keda requires"):
        Controller(tcfg.default_config(), RulePolicy(ct.cluster, "cpu"),
                   _sources(cj, ct)[1], DryRunSink(), device="cpu",
                   apply_keda=True, **QUIET)


def test_controller_lock_refuses_a_second_daemon(tmp_path):
    from ccka_tpu_torch.harness.controller import ControllerLockHeld

    ct = tcfg.default_config()
    src = _sources(jcfg.default_config(), ct)[1]
    kw = dict(device="cpu", lock=True, lock_dir=str(tmp_path), **QUIET)
    first = Controller(ct, RulePolicy(ct.cluster, "cpu"), src, DryRunSink(),
                       **kw)
    with pytest.raises(ControllerLockHeld, match="pid="):
        Controller(ct, RulePolicy(ct.cluster, "cpu"), src, DryRunSink(),
                   telemetry_path=str(tmp_path / "never.jsonl"), **kw)
    assert not (tmp_path / "never.jsonl").exists()
    first.close()
    Controller(ct, RulePolicy(ct.cluster, "cpu"), src, DryRunSink(),
               **kw).close()
