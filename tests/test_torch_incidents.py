"""The port's incident log, flight recorder and the controller's ledgers
against the JAX package's.

- `IncidentLog` records and JSONL lines equal JAX's apart from the wall
  clock (``time_unix``); ids continue across sessions; a torn tail is
  repaired before appending; I/O failures degrade the record, never the
  loop;
- a `FlightRecorder` dump verifies, and its digest equals JAX's for the
  same body (the same canonical JSON under the same SHA-256);
- `build_timeline` and `attach_dump_entries` give identical rows;
- a `Controller` with ``incident_log=`` under a seeded `ChaosSink` stamps
  the same trigger sequence as JAX's controller on one world; with
  ``decision_ledger=`` the records agree within 1e-5 (rule, carbon:
  float32 estimate steps in two frameworks; pending pods at the
  demand's scale), and ledger-on and ledger-off runs are bitwise;
- `incidents list|show|timeline` print what JAX's command line prints;
- the burn-rate engine's windows, rates and the two-window AND are
  JAX's on the same series;
- the service cases of `tests/test_incidents.py`: a seeded chaos and
  slow-tenant service run stamps one incident per breaker open,
  give-up and overshoot, each with a verifying dump and a place on the
  timeline, the same trigger sequence as JAX's service on the same
  traces; shed spikes and a hold→fallback escalation stamp once each;
  recorder-on and recorder-off services are bitwise.
"""

from __future__ import annotations

import json

import pytest

import ccka_tpu.config as jcfg
import ccka_tpu.obs.incidents as jinc
import ccka_tpu.obs.recorder as jrec
import ccka_tpu_torch.config as tcfg
from ccka_tpu.actuation.chaos import ChaosSink as JChaosSink
from ccka_tpu.actuation.sink import DryRunSink as JDryRunSink
from ccka_tpu.harness.controller import Controller as JController
from ccka_tpu.obs.decisions import DecisionLedger as JDecisionLedger
from ccka_tpu.policy import CarbonAwarePolicy as JCarbon
from ccka_tpu.policy import RulePolicy as JRule
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu_torch import cli
from ccka_tpu_torch.actuation.chaos import ChaosSink
from ccka_tpu_torch.actuation.sink import DryRunSink
from ccka_tpu_torch.harness.controller import Controller
from ccka_tpu_torch.harness.recovery import _fingerprint
from ccka_tpu_torch.harness.snapshot import SnapshotError, save_snapshot
from ccka_tpu_torch.obs import incidents as inc
from ccka_tpu_torch.obs import recorder as rec
from ccka_tpu_torch.obs.decisions import DecisionLedger
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

EDGE = 8 * 3600 + 58 * 60      # ticks 0-3 off-peak, 4+ peak
QUIET = dict(interval_s=0.0, log_fn=lambda s: None)


def _strip(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "time_unix"}


def _stamp_all(log):
    log.stamp("breaker_open", t=3, tenant=1, state="open")
    log.stamp("shed_spike", t=4, shed=5, frac=0.25)
    log.stamp("reconcile_giveup", t=4, region="us-east-2",
              diverged=["spot"], retries=2)
    log.stamp("policy_divergence", t=6, rate=0.5, threshold=0.25)


def test_incident_records_equal_jax(tmp_path):
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "port")}
    jl, tl = jinc.IncidentLog(paths["jax"]), inc.IncidentLog(paths["port"])
    _stamp_all(jl)
    _stamp_all(tl)
    jl.close()
    tl.close()
    assert inc.TRIGGERS == jinc.TRIGGERS
    assert [_strip(i.to_record()) for i in tl.incidents] == \
        [_strip(i.to_record()) for i in jl.incidents]
    assert tl.counts() == jl.counts() and tl.last_tick() == 6
    assert [_strip(r) for r in inc.read_incidents(paths["port"])] == \
        [_strip(r) for r in jinc.read_incidents(paths["jax"])]
    with pytest.raises(ValueError, match="unknown incident trigger"):
        inc.IncidentLog().stamp("novel_trigger", t=0)


def test_sessions_continue_ids_and_repair_a_torn_tail(tmp_path):
    path = str(tmp_path / "inc.jsonl")
    dumps = tcfg.ObsConfig(enabled=True, dump_dir=str(tmp_path / "d"))
    r1 = rec.FlightRecorder(dumps)
    r1.record(0, {"t": 1})
    log = inc.IncidentLog(path, recorder=r1)
    first = log.stamp("breaker_open", t=1, tenant=0)
    log.stamp("shed_spike", t=2, shed=4)
    log.close()
    raw = open(path, "rb").read()
    with open(path, "wb") as fh:           # tear the final record
        fh.write(raw[:-10])
    r2 = rec.FlightRecorder(dumps)
    r2.record(0, {"t": 3})
    log2 = inc.IncidentLog(path, recorder=r2)
    second = log2.stamp("breaker_open", t=3, tenant=0)
    log2.close()
    assert second.id == first.id + 1 and second.dump_path != first.dump_path
    recs = inc.read_incidents(path)
    assert [r["t"] for r in recs] == [1, 3]
    for r in recs:
        assert rec.verify_dump(r["dump_path"])["t"] == r["t"]
    with open(path, "w") as fh:
        fh.write('{"id": 1, "t": 0}\nGARBAGE\n{"id": 2, "t": 1}\n')
    with pytest.raises(ValueError, match="corrupt incident log"):
        inc.IncidentLog(path)


def test_io_failure_degrades_the_record_not_the_loop(tmp_path, capsys):
    class FailingRecorder:
        def dump(self, **_kw):
            raise OSError(28, "No space left on device")

    log = inc.IncidentLog(str(tmp_path / "inc.jsonl"),
                          recorder=FailingRecorder())
    log._fh.close()
    i = log.stamp("breaker_open", t=1, tenant=0)
    assert i.dump_path is None and log.total == 1 and log.io_errors == 2
    assert "incident-log" in capsys.readouterr().err
    log._fh = None


def test_recorder_dump_verifies_with_jax_s_digest(tmp_path):
    def fill(r):
        for t in range(10):
            r.record(r_mod.FLEET_KEY, {"t": t, "lane": t % 3})
            r.record(3, {"t": t, "ok": bool(t % 2), "lat_ms": 0.5 * t})

    digests, bodies = [], []
    for r_mod, o_mod, d in ((rec, tcfg, "port"), (jrec, jcfg, "jax")):
        r = r_mod.FlightRecorder(o_mod.ObsConfig(
            enabled=True, ring_size=4, dump_dir=str(tmp_path / d)))
        fill(r)
        path, sha = r.dump(trigger="breaker_open", t=9, tenant=3,
                           incident_id=1, context={"state": "open"})
        assert r.dumps_total == 1
        # Triggers of one (tick, tenant) share the capture.
        assert r.dump(trigger="hold_fallback", t=9, tenant=3,
                      incident_id=2) == (path, sha)
        digests.append(sha)
        bodies.append(r_mod.verify_dump(path))
    assert digests[0] == digests[1] and bodies[0] == bodies[1]
    assert [x["t"] for x in bodies[0]["rings"]["3"]] == [6, 7, 8, 9]
    assert rec.FLEET_KEY == jrec.FLEET_KEY
    path = str(tmp_path / "port" / "incident-00001-t000009-breaker_open.json")
    doc = json.load(open(path))
    doc["body"]["t"] = 999
    json.dump(doc, open(path, "w"))
    with pytest.raises(SnapshotError, match="checksum"):
        rec.verify_dump(path)
    other = str(tmp_path / "ctrl.snap")
    save_snapshot(other, {"kind": "controller", "next_tick": 3})
    with pytest.raises(SnapshotError, match="not a recorder-dump"):
        rec.verify_dump(other)
    assert rec.FlightRecorder(tcfg.ObsConfig(enabled=True)).dump(
        trigger="breaker_open", t=0, tenant=0) is None


def test_timeline_identical():
    logs = (inc.IncidentLog(), jinc.IncidentLog())
    for log in logs:
        _stamp_all(log)
    runlog = [{"event": "iter", "t": 4, "loss": 1.0},
              {"event": "iter", "t": 5, "loss": 2.0},
              {"event": "note", "msg": "no tick key"}]
    spans = [{"name": "fleet.dispatch", "args": {"t": 4}, "dur_us": 1500.0},
             {"name": "fleet.fanout", "args": {"t": 99}, "dur_us": 1.0}]
    for kw in ({}, {"around": 4, "window": 1}):
        got = inc.build_timeline(logs[0].incidents, runlog=runlog,
                                 spans=spans, **kw)
        want = jinc.build_timeline(logs[1].incidents, runlog=runlog,
                                   spans=spans, **kw)
        assert [_strip(r) for r in got] == [_strip(r) for r in want]
        assert {r["source"] for r in got} == {"incident", "runlog", "span"}
    row = {"source": "incident", "id": 1, "t": 3, "dump_path": None}
    assert inc.attach_dump_entries(row) == jinc.attach_dump_entries(row)


def _controllers(name, *, ledgers, chaos=True, tmp_path=None):
    """JAX's and the port's controller on one world: the same synthetic
    source clock, the same seeded severe ChaosSink fates."""
    cj, ct = jcfg.default_config(), tcfg.default_config()
    jb, tb = ((JRule(cj.cluster), RulePolicy(ct.cluster, device="cpu"))
              if name == "rule" else
              (JCarbon(cj.cluster), CarbonAwarePolicy(ct.cluster,
                                                      device="cpu")))
    js = JDryRunSink()
    ts = DryRunSink()
    if chaos:
        js = JChaosSink(js, jcfg.CHAOS_PRESETS["severe"], seed=5)
        ts = ChaosSink(ts, tcfg.CHAOS_PRESETS["severe"], seed=5)
    jkw, tkw = {}, {}
    if ledgers:
        jkw = dict(incident_log=jinc.IncidentLog(),
                   decision_ledger=JDecisionLedger(
                       jcfg.ObsConfig(enabled=True), cj.train, policy=name))
        tkw = dict(incident_log=inc.IncidentLog(),
                   decision_ledger=DecisionLedger(
                       tcfg.ObsConfig(enabled=True), ct.train, policy=name))
    common = dict(reconcile_backoff_s=0.0, **QUIET)
    jc = JController(cj, jb, JSource(cj.cluster, cj.workload, cj.sim,
                                     cj.signals, start_unix_s=EDGE),
                     js, **common, **jkw)
    tc = Controller(ct, tb, SyntheticSignalSource(
        ct.cluster, ct.workload, ct.sim, ct.signals, start_unix_s=EDGE),
        ts, device="cpu", **common, **tkw)
    return jc, tc


def _close(a, b, path=""):
    """Recursive comparison: structure equal, numbers within 1e-5
    relative (1e-6 absolute at 0), everything else equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        assert abs(a - b) <= 1e-5 * max(abs(a), abs(b)) + 1e-6, \
            (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", ["rule", "carbon"])
def test_controller_stamps_and_records_as_jax_does(name):
    jc, tc = _controllers(name, ledgers=True)
    jc.run(ticks=12)
    tc.run(ticks=12)
    ji, ti = jc.incident_log.incidents, tc.incident_log.incidents
    assert [(i.trigger, i.t, i.details) for i in ti] == \
        [(i.trigger, i.t, i.details) for i in ji]
    assert {i.trigger for i in ti} >= {"reconcile_giveup"}
    jrows, trows = list(jc.decision_ledger.rows), \
        list(tc.decision_ledger.rows)
    assert len(trows) == len(jrows) == 12
    # Pending pods are remainders of the demand: their terms are held at
    # the demand's scale through the absolute floor below.
    for a, b in zip(trows, jrows):
        for side in ("objective",):
            for k in ("terms", "by_class"):
                for kk in a[side][k]:
                    x, y = a[side][k][kk], b[side][k][kk]
                    assert abs(x - y) <= 1e-5 * max(abs(y), 1.0), (k, kk)
        _close({k: v for k, v in a.items() if k not in ("objective",
                                                        "shadow")},
               {k: v for k, v in b.items() if k not in ("objective",
                                                        "shadow")})
        _close(a["shadow"]["action"], b["shadow"]["action"])
        assert a["lane"] == b["lane"]
        assert a["shadow"]["diverged"] == b["shadow"]["diverged"]
        assert sum(a["objective"]["shares"].values()) == \
            pytest.approx(1.0, abs=1e-9)
    assert tc.decision_ledger.spikes_total == jc.decision_ledger.spikes_total
    if name == "rule":
        assert all(r["shadow"]["div_max_abs"] == 0.0 for r in trows
                   if r["lane"] != "hold")


@pytest.mark.parametrize("name", ["rule", "carbon"])
def test_ledgers_on_and_off_runs_are_bitwise(name):
    _, on = _controllers(name, ledgers=True)
    _, off = _controllers(name, ledgers=False)
    r_on, r_off = on.run(ticks=12), off.run(ticks=12)
    assert [_fingerprint(r) for r in r_on] == [_fingerprint(r)
                                               for r in r_off]
    cmds = [[c.render() for c in ctrl.sink.inner.commands]
            for ctrl in (on, off)]
    assert cmds[0] == cmds[1] and cmds[0]
    assert on.decision_ledger.rows_total == 12


def test_stale_source_fallback_stamps_one_hold_fallback():
    ct = tcfg.default_config()

    class StaleSource(SyntheticSignalSource):
        last_scrape_stale = True

    log = inc.IncidentLog()
    led = DecisionLedger(tcfg.ObsConfig(enabled=True), ct.train,
                         policy="carbon")
    ctrl = Controller(ct, CarbonAwarePolicy(ct.cluster, device="cpu"),
                      StaleSource(ct.cluster, ct.workload, ct.sim,
                                  ct.signals),
                      DryRunSink(), device="cpu", degraded_fallback_after=1,
                      incident_log=log, decision_ledger=led, **QUIET)
    ctrl.run(ticks=3)
    assert log.counts() == {"hold_fallback": 1}
    assert log.incidents[0].t == 0
    rows = list(led.rows)
    assert all(r["lane"] == "fallback" for r in rows)
    assert all(r["shadow"]["div_max_abs"] == 0.0 for r in rows)
    assert all(r["exo"]["stale"] for r in rows)


def test_incidents_cli_matches_jax(tmp_path, capsys):
    import ccka_tpu.cli as jcli

    path = str(tmp_path / "inc.jsonl")
    r = rec.FlightRecorder(tcfg.ObsConfig(enabled=True,
                                          dump_dir=str(tmp_path / "d")))
    r.record(rec.FLEET_KEY, {"t": 4})
    log = inc.IncidentLog(path, recorder=r)
    _stamp_all(log)
    log.close()
    spans = str(tmp_path / "spans.jsonl")
    with open(spans, "w") as fh:
        fh.write(json.dumps({"name": "fleet.fanout", "args": {"t": 4},
                             "dur_us": 10.0}) + "\n")
    for argv in (["incidents", "list", path],
                 ["incidents", "show", path, "--id", "2"],
                 ["incidents", "timeline", path, "--trace", spans],
                 ["incidents", "timeline", path, "--id", "3",
                  "--window", "1"]):
        outs = []
        for main in (cli.main, jcli.main):
            assert main(list(argv)) == 0
            outs.append(capsys.readouterr())
        assert outs[0].out == outs[1].out and outs[0].out
        assert outs[0].err == outs[1].err
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match="needs --id"):
            main(["incidents", "show", path])
        with pytest.raises(SystemExit, match="no incident with id"):
            main(["incidents", "show", path, "--id", "42"])


# ---- the burn-rate engine ---------------------------------------------------


def test_burn_windows_and_two_window_and():
    from ccka_tpu_torch.obs.burnrate import BurnRate

    br = BurnRate(fast_ticks=2, slow_ticks=8, threshold=0.5)
    assert br.fast_rate == 0.0 and not br.burning
    for _ in range(2):
        br.update(1.0, 1.0)
    assert br.fast_rate == 1.0 and br.slow_rate == 1.0 and br.burning
    for _ in range(6):
        br.update(0.0, 1.0)
    assert br.fast_rate == 0.0
    assert br.slow_rate == pytest.approx(2.0 / 8.0)
    assert not br.burning
    blip = BurnRate(fast_ticks=1, slow_ticks=8, threshold=0.5)
    for _ in range(8):
        blip.update(0.0, 1.0)
    blip.update(1.0, 1.0)
    assert blip.fast_rate == 1.0 and not blip.burning
    with pytest.raises(ValueError, match="fast window"):
        BurnRate(fast_ticks=8, slow_ticks=2)


def test_burn_engine_series_equal_jax():
    import numpy as np

    from ccka_tpu.obs.burnrate import BurnRateEngine as JEngine
    from ccka_tpu_torch.obs.burnrate import BurnRateEngine

    rng = np.random.default_rng(3)
    a, b = BurnRateEngine(3, 9, 0.4), JEngine(3, 9, 0.4)
    for _ in range(40):
        for name in ("slo", "deadline", "shed"):
            total = float(rng.integers(1, 12))
            bad = float(rng.integers(0, int(total) + 1))
            a.update(name, bad, total)
            b.update(name, bad, total)
        assert a.rates() == b.rates()
        assert a.any_burning == b.any_burning
        for name in ("slo", "deadline", "shed"):
            for w in ("fast", "slow"):
                assert a.rate(name, w) == b.rate(name, w)


# ---- the service cases ------------------------------------------------------


def _svc_obs(tmp_path):
    return tcfg.ObsConfig(enabled=True, dump_dir=str(tmp_path / "dumps"),
                          incident_log_path=str(tmp_path / "i.jsonl"))


def _service(ct, profiles, obs, *, service=None, seed=3, ticks=12):
    from test_torch_decisions import det_clock

    from ccka_tpu_torch.harness.service import fleet_service_from_config

    svc = fleet_service_from_config(
        ct, RulePolicy(ct.cluster, device="cpu"), len(profiles),
        profiles=profiles,
        service=service or tcfg.SERVICE_PRESETS["default"], obs=obs,
        horizon_ticks=16, seed=seed, clock=det_clock(), device="cpu")
    return svc, svc.run(ticks) if ticks else []


def test_service_triggers_under_chaos(tmp_path):
    ct = tcfg.default_config().with_overrides(**{"sim.horizon_steps": 16})
    obs = _svc_obs(tmp_path)
    svc, reports = _service(ct, ["healthy"] * 3 + ["slow", "flaky",
                                                    "flaky"], obs)
    counts = svc.incidents.counts()
    opens = sum(b.transitions["opened"] for b in svc.breakers)
    assert opens > 0 and counts.get("breaker_open", 0) == opens
    assert svc.actuation_giveups_total > 0
    assert counts.get("reconcile_giveup", 0) == svc.actuation_giveups_total
    for i in svc.incidents.incidents:
        body = rec.verify_dump(i.dump_path)
        assert body["t"] == i.t
        if i.tenant is not None:
            ring = body["rings"][str(i.tenant)]
            assert ring and ring[-1]["t"] == i.t
    recs = inc.read_incidents(obs.incident_log_path)
    tl = inc.build_timeline(recs, spans=[sp.to_record()
                                         for sp in svc.tracer.spans()])
    incidents = [r for r in tl if r["source"] == "incident"]
    assert len(incidents) == svc.incidents.total
    span_ticks = {r["t"] for r in tl if r["source"] == "span"}
    assert all(r["t"] in span_ticks and r["trigger"] in inc.TRIGGERS
               for r in incidents)
    last = reports[-1]
    assert last.incidents_total == svc.incidents.total
    assert last.recorder_dumps_total == svc.recorder.dumps_total
    assert 0.0 <= last.slo_burn_rate <= 1.0
    lastinc = svc.incidents.last_tick()
    assert last.incident_active == int(
        svc.burn.any_burning or (lastinc is not None and last.t - lastinc
                                 < svc.obs.burn_fast_window))
    # The obs layer's device surfaces: the dispatch count is the
    # session's, no observatory snapshot was published, no geo rollout
    # ran — skip values, not fake zeros.
    assert last.program_dispatches_total >= 12
    assert last.achieved_roofline_fraction is None
    assert last.region_migration_rate == {} == last.region_carbon_intensity
    svc.close()


def test_service_trigger_sequence_matches_jax():
    from test_torch_service import MIX, run_pair, service_pair

    js, ts = service_pair("rule", "default", 6, MIX,
                          obs_j=jcfg.ObsConfig(enabled=True),
                          obs_t=tcfg.ObsConfig(enabled=True))
    (jreps, _), (treps, _) = run_pair(js, ts, 12)
    seq = [(i.trigger, i.t, i.tenant) for i in ts.incidents.incidents]
    assert seq and seq == [(i.trigger, i.t, i.tenant)
                           for i in js.incidents.incidents]
    assert {i.trigger for i in ts.incidents.incidents} >= {
        "breaker_open", "hold_fallback"}
    assert [(r.slo_burn_rate, r.slo_burn_rate_slow, r.incident_active)
            for r in treps] == [(r.slo_burn_rate, r.slo_burn_rate_slow,
                                 r.incident_active) for r in jreps]
    js.close()
    ts.close()


def test_service_deadline_overshoot_one_incident_per_tick(tmp_path):
    ct = tcfg.default_config().with_overrides(**{"sim.horizon_steps": 16})
    svc, _ = _service(ct, ["healthy"] * 3, _svc_obs(tmp_path), seed=7,
                      ticks=0)
    orig = svc._tick_fn

    def slow_dispatch(*a, **kw):
        out = orig(*a, **kw)
        svc.clock.advance(0.3)     # 300 ms > the 250 ms deadline
        return out

    svc._tick_fn = slow_dispatch
    reports = svc.run(4)
    assert sum(r.tick_latency_ms > svc.svc.tick_deadline_ms
               for r in reports) == 4
    assert svc.incidents.counts()["deadline_overshoot"] == 4
    for i in svc.incidents.incidents:
        if i.trigger == "deadline_overshoot":
            assert i.details["latency_ms"] > i.details["deadline_ms"]
    svc.close()


def test_service_shed_spike_and_hold_fallback_stamped_once_each(tmp_path):
    import math

    ct = tcfg.default_config().with_overrides(**{"sim.horizon_steps": 16})
    post = tcfg.ServiceConfig(enabled=True, tick_deadline_ms=200.0,
                              admission_queue_cap=3, breaker_failures=1,
                              hold_fallback_after=2, breaker_probe_ticks=32)
    svc, reports = _service(
        ct, ["healthy", "healthy", "slow"] + ["batch"] * 3,
        _svc_obs(tmp_path), service=post, seed=5, ticks=8)
    counts = svc.incidents.counts()
    bar = max(1, math.ceil(svc.obs.shed_spike_frac * 6))
    spike_ticks = sum(1 for r in reports if r.shed >= bar)
    assert spike_ticks > 0 and counts["shed_spike"] == spike_ticks
    fallback = [i for i in svc.incidents.incidents
                if i.trigger == "hold_fallback"]
    assert len(fallback) == 1 and fallback[0].tenant == 2
    svc.close()


def test_service_recorder_on_off_bitwise(tmp_path):
    import numpy as np
    import torch

    ct = tcfg.default_config().with_overrides(**{"sim.horizon_steps": 16})
    runs = []
    for obs in (None, _svc_obs(tmp_path)):
        svc, _ = _service(ct, ["healthy"] * 4 + ["slow"], obs, seed=11,
                          ticks=10)
        runs.append((svc.tenant_usd_per_slo_hr().copy(),
                     svc.tenant_fresh_ticks.copy(),
                     [x.clone() for x in svc.states],
                     [[c.render() for c in s.commands] for s in svc.sinks],
                     svc.incidents.total if svc.incidents else 0))
        if obs is None:
            assert svc.recorder is None and svc.incidents is None \
                and svc.burn is None
        svc.close()
    off, on = runs
    np.testing.assert_array_equal(off[0], on[0])
    np.testing.assert_array_equal(off[1], on[1])
    assert all(torch.equal(a, b) for a, b in zip(off[2], on[2]))
    assert off[3] == on[3]
    assert on[4] > 0
    assert tcfg.OBS_PRESETS["off"].enabled is False
