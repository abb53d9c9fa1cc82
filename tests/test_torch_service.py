"""The port's multi-tenant fleet service against the JAX package's.

The two packages sample fleet traces from different random streams, so
both services are handed the same traces: JAX's synthetic device batch,
served by a test source on each side (`test_torch_fleet.JFixed/TFixed`),
on the deterministic clock (scrape delays advance it, nothing else).
N = 6 tenants over 8 ticks, the tenant mix of the fleet-scale parity
gate (healthy, batch, jittery, slow, flaky) behind an admission cap one
below the fleet. Standards, set from the dtypes before the runs:

- every report counter, the breaker states and each tick's lane vector
  equal JAX's (host numpy code, the same counter-addressed draws);
- the fleet sums (cost, carbon, pending) and the packed and per-tenant
  rows within 1e-5 relative for rule and carbon (pending pods at the
  demand's scale), the flagship's within 1e-3 (actions and divergences
  5e-3: a bf16 torso, as in `test_torch_fleet.py`);
- rule and carbon command streams byte-identical;
- the breaker machine's transitions, probe schedules and draws equal
  JAX's on the same seeds; `counter_u01` bitwise JAX's.

Within the port: the off gate byte-identical to `FleetController`,
healthy tenants bitwise the calm run, vectorized bitwise object,
chunked bitwise unchunked, two services interleaved on one tick key
bitwise their separate runs, and the default device raising without a
GPU.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.harness.service as jsvc
import ccka_tpu_torch.config as tcfg
from ccka_tpu.actuation.sink import DryRunSink as JDryRunSink
from ccka_tpu.harness.fleetscale import _report_counters as j_counters
from ccka_tpu_torch.actuation.sink import DryRunSink
from ccka_tpu_torch.harness import service as svc_mod
from ccka_tpu_torch.harness.fleet import fleet_controller_from_config
from ccka_tpu_torch.harness.fleetscale import _report_counters, _run_paired
from ccka_tpu_torch.harness.service import (LANE_FALLBACK, LANE_FRESH,
                                            TENANT_PROFILES, CircuitBreaker,
                                            VirtualClock,
                                            fleet_service_from_config,
                                            resolve_profiles)
from ccka_tpu_torch.policy.rule import RulePolicy
from test_torch_cli import CPU, _both, _json_out, _run, jmain, tmain
from test_torch_fleet import (HORIZON, JFixed, TFixed, _assert_rows_close,
                              _backends, _configs, _jax_traces)

MIX = ["healthy", "batch", "jittery", "slow", "flaky", "healthy"]
# Report fields that are real host time, or sums of float32 rows.
FLOAT_FIELDS = ("cost_usd_hr", "carbon_g_hr", "pending_pods")


def jax_det_clock():
    return jsvc.VirtualClock(base=lambda: 0.0)


def det_clock():
    return VirtualClock(base=lambda: 0.0)


def commands(service) -> list:
    """Per-sink rendered command streams (through any chaos wrap)."""
    return [[c.render() for c in getattr(s, "inner", s).commands]
            for s in service.sinks]


def service_pair(name: str, preset: str, n: int, profiles, *, seed=3,
                 service=None, obs_j=None, obs_t=None, backends=None,
                 configs=None):
    """(JAX service, port service) on the same traces, det clocks, and
    per-tick row recorders (``svc.rows``: (packed, per) per tick)."""
    cj, ct = configs or _configs(preset)
    if backends is None:
        backends = _backends(name, cj, ct)
    jb, tb = backends
    traces = _jax_traces(cj, n, seed)
    post = service or dict(enabled=True, tick_deadline_ms=250.0,
                           scrape_budget_frac=0.4,
                           admission_queue_cap=n - 1, breaker_failures=2)
    js = jsvc.FleetService(
        cj, jb, JFixed(traces), [JDryRunSink() for _ in range(n)],
        profiles=profiles, service=jcfg.ServiceConfig(**post), obs=obs_j,
        horizon_ticks=HORIZON, seed=seed, clock=jax_det_clock())
    ts = svc_mod.FleetService(
        ct, tb, TFixed(traces), [DryRunSink() for _ in range(n)],
        profiles=profiles, service=tcfg.ServiceConfig(**post), obs=obs_t,
        horizon_ticks=HORIZON, seed=seed, clock=det_clock(), device="cpu")
    js.rows, ts.rows = [], []
    j_tick = js._tick_fn

    def j_spy(*a):
        out = j_tick(*a)
        js.rows.append((np.asarray(out[0]), np.asarray(out[2])))
        return out
    js._tick_fn = j_spy
    t_dispatch = ts._dispatch

    def t_spy(t, lanes):
        out = t_dispatch(t, lanes)
        ts.rows.append(out)
        return out
    ts._dispatch = t_spy
    return js, ts


def run_pair(js, ts, ticks: int):
    """Both services tick by tick; (reports, lanes) per package."""
    out = []
    for s in (js, ts):
        reps, lanes = [], []
        for t in range(ticks):
            reps.append(s.tick(t))
            lanes.append(s.last_lanes.copy())
        out.append((reps, lanes))
    return out


def assert_reports_equal(jreps, treps, rtol: float, pending_scale: float):
    """Counters equal; the float sums within ``rtol`` relative (pending
    pods, remainders of the demand, at ``pending_scale``)."""
    for jr, tr in zip(jreps, treps):
        jd, td = j_counters(jr), _report_counters(tr)
        assert set(jd) == set(td)
        for k in FLOAT_FIELDS:
            scale = pending_scale if k == "pending_pods" else 0.0
            assert td.pop(k) == pytest.approx(
                jd.pop(k), rel=rtol, abs=max(1e-6, rtol * scale))
        # The session dispatch count reads each package's own registry.
        jd.pop("program_dispatches_total")
        td.pop("program_dispatches_total")
        assert td == jd


def _svc(**kw) -> tcfg.ServiceConfig:
    base = dict(enabled=True, tick_deadline_ms=200.0)
    base.update(kw)
    return tcfg.ServiceConfig(**base)


@pytest.fixture(scope="module")
def cfg():
    return tcfg.default_config().with_overrides(**{"sim.horizon_steps": 16})


@pytest.fixture(scope="module")
def rule(cfg):
    # ONE backend instance module-wide: the tick cache keys on it.
    return RulePolicy(cfg.cluster, device="cpu")


# ---- the breaker machine, edge by edge, in both packages -------------------


def _snap(br) -> tuple:
    return (br.state, br.level, dict(br.transitions), br._probe_at,
            br.draws)


def _case_opens_then_probe_success_recloses(B, S):
    svc = S(enabled=True, tick_deadline_ms=200.0, breaker_failures=2,
            breaker_probe_ticks=3, breaker_probe_jitter=0.0)
    br, log = B(svc, seed=1), []
    assert br.allow(0) and br.state == "closed"
    br.record_failure(0)
    assert br.state == "closed"
    br.record_failure(1)
    log.append(_snap(br))
    assert br.state == "open" and br.level == 2
    assert not br.allow(2) and not br.allow(3)
    assert br.allow(4) and br.state == "half-open" and br.level == 1
    br.record_success()
    log.append(_snap(br))
    assert br.transitions == {"opened": 1, "half_open": 1, "closed": 1}
    return log


def _case_probe_failure_doubles_delay(B, S):
    svc = S(enabled=True, tick_deadline_ms=200.0, breaker_failures=1,
            breaker_probe_ticks=3, breaker_probe_jitter=0.0)
    br, log = B(svc, seed=0), []
    br.record_failure(0)
    assert br.allow(3) and br.state == "half-open"
    br.record_failure(3)
    log.append(_snap(br))
    assert br.state == "open" and not br.allow(8)
    assert br.allow(9) and br.state == "half-open"
    log.append(_snap(br))
    return log


def _case_reopens_with_reset_backoff(B, S):
    svc = S(enabled=True, tick_deadline_ms=200.0, breaker_failures=1,
            breaker_probe_ticks=4, breaker_probe_jitter=0.0)
    br, log = B(svc, seed=0), []
    br.record_failure(0)
    assert br.allow(4)
    br.record_success()
    br.record_failure(10)
    log.append(_snap(br))
    assert br.state == "open" and br.transitions["opened"] == 2
    assert br.allow(14)
    return log


def _case_capped_seeded_jitter(B, S):
    svc = S(enabled=True, tick_deadline_ms=200.0, breaker_failures=1,
            breaker_probe_ticks=4, breaker_probe_jitter=0.3,
            breaker_max_probe_ticks=16)
    a, b, log, t = B(svc, seed=7), B(svc, seed=7), [], 0
    for _ in range(6):
        a.record_failure(t)
        b.record_failure(t)
        assert a._probe_at == b._probe_at
        assert a._probe_at - t <= svc.breaker_max_probe_ticks
        log.append(_snap(a))
        t = a._probe_at
        assert a.allow(t) and b.allow(t)
    return log


def _case_open_ticks_escalation(B, S):
    svc = S(enabled=True, tick_deadline_ms=200.0, breaker_failures=1,
            hold_fallback_after=3)
    br = B(svc, seed=0)
    log = [br.open_ticks(5)]
    br.record_failure(5)
    log += [br.open_ticks(6), br.open_ticks(9)]
    assert log == [0, 1, 4] and log[2] >= svc.hold_fallback_after
    br.record_success()
    log.append(br.open_ticks(12))
    assert log[-1] == 0
    return log


@pytest.mark.parametrize("case", [
    _case_opens_then_probe_success_recloses,
    _case_probe_failure_doubles_delay, _case_reopens_with_reset_backoff,
    _case_capped_seeded_jitter, _case_open_ticks_escalation],
    ids=lambda f: f.__name__[6:])
def test_breaker_edges_equal_jax(case):
    want = case(jsvc.CircuitBreaker, jcfg.ServiceConfig)
    got = case(CircuitBreaker, tcfg.ServiceConfig)
    assert got == want


def test_counter_u01_bitwise_jax_and_banks_consume_its_draws():
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 2 ** 63, 64, dtype=np.int64).astype(np.uint64)
    counters = rng.integers(0, 2 ** 40, 64)
    got = svc_mod.counter_u01(seeds, counters)
    assert np.array_equal(got, jsvc.counter_u01(seeds, counters))
    assert np.array_equal(svc_mod._mix64(seeds), jsvc._mix64(seeds))
    assert np.array_equal(got, [float(svc_mod.counter_u01(s, c))
                                for s, c in zip(seeds, counters)])
    assert np.all((got >= 0.0) & (got < 1.0))

    def drive(bank):
        bank.record_failure_idx(np.arange(0, 6, 2), 0)
        bank.record_failure_idx(np.arange(6), 4)
        bank.record_success_idx(np.asarray([1, 3]))
        bank.record_failure_idx(np.asarray([1]), 9)
        return bank

    post = dict(enabled=True, tick_deadline_ms=200.0, breaker_failures=1,
                breaker_probe_ticks=3, breaker_probe_jitter=0.3,
                breaker_max_probe_ticks=32)
    vec = drive(svc_mod._VectorBreakerBank(tcfg.ServiceConfig(**post), 211,
                                           6))
    jvec = drive(jsvc._VectorBreakerBank(jcfg.ServiceConfig(**post), 211, 6))
    obj = svc_mod._ObjectBreakerBank(tcfg.ServiceConfig(**post), 211, 6)
    for idx, t in ((np.arange(0, 6, 2), 0), (np.arange(6), 4)):
        for i in idx:
            obj.record_failure(int(i), t)
    for i in (1, 3):
        obj.record_success(i)
    obj.record_failure(1, 9)
    for a, b in ((vec, jvec),):
        assert np.array_equal(a.probe_at, b.probe_at)
        assert np.array_equal(a.draws, b.draws)
        assert a.transition_counts() == b.transition_counts()
    assert vec.draws.tolist() == [b.draws for b in obj.breakers]
    assert vec.probe_at.tolist() == [b._probe_at for b in obj.breakers]


# ---- the service against JAX's on one world ---------------------------------


@pytest.mark.parametrize("name,preset", [("rule", "default"),
                                         ("carbon", "default"),
                                         ("flagship", "multiregion")])
def test_service_matches_jax(name, preset):
    # The flagship's rendered patches may differ in a whole second of
    # consolidateAfter: its tenants carry no kubectl chaos, so the
    # admission machine's inputs stay the same in both packages.
    profiles = (MIX if name != "flagship" else
                ["healthy", "batch", "jittery", "slow", "healthy",
                 "batch"])
    js, ts = service_pair(name, preset, 6, profiles)
    (jreps, jlanes), (treps, tlanes) = run_pair(js, ts, 8)
    rtol = 1e-3 if name == "flagship" else 1e-5
    _, ct = _configs(preset)
    assert_reports_equal(jreps, treps, rtol,
                         6 * float(ct.workload.total_pods))
    assert all(np.array_equal(a, b) for a, b in zip(jlanes, tlanes))
    assert {int(x) for lanes in tlanes for x in lanes} == {0, 1, 2}
    if name == "flagship":
        _assert_rows_close(js.rows, ts.rows, ct, 1e-3, action_rtol=5e-3)
    else:
        _assert_rows_close(js.rows, ts.rows, ct, 1e-5)
        assert commands(ts) == commands(js)
    np.testing.assert_array_equal(ts.tenant_fresh_ticks,
                                  js.tenant_fresh_ticks)
    np.testing.assert_allclose(ts.tenant_cost_usd, js.tenant_cost_usd,
                               rtol=rtol)
    assert ts.breaker_transition_counts() == js.breaker_transition_counts()
    assert ts.chaos_injected() == js.chaos_injected()
    js.close()
    ts.close()


def test_two_services_interleaved_on_one_tick_key():
    """The overload board's paired services share one tick (one graph
    on the card): ticking them in turn gives each what it gives alone."""
    _, ct = _configs("default")
    backend = RulePolicy(ct.cluster, device="cpu")

    def make(profiles):
        return fleet_service_from_config(
            ct, backend, 6, profiles=profiles,
            service=tcfg.SERVICE_PRESETS["default"], horizon_ticks=16,
            seed=4, clock=det_clock(), device="cpu")

    stress_mix = ["healthy"] * 3 + ["slow", "flaky", "flaky"]
    alone = [make(stress_mix), make(["healthy"] * 6)]
    for s in alone:
        s.run(6)
    pair = [make(stress_mix), make(["healthy"] * 6)]
    assert pair[0]._tick_fn is pair[1]._tick_fn
    for t in range(6):
        for s in pair:
            s.tick(t)
    for a, b in zip(alone, pair):
        assert all(torch.equal(x, y) for x, y in zip(a.states, b.states))
        np.testing.assert_array_equal(a.tenant_cost_usd, b.tenant_cost_usd)
        assert commands(a) == commands(b)
    np.testing.assert_array_equal(pair[0].tenant_usd_per_slo_hr()[:3],
                                  pair[1].tenant_usd_per_slo_hr()[:3])


# ---- the contracts of tests/test_service.py, on the port --------------------


def test_off_preset_byte_identical_to_fleet_controller(cfg, rule):
    n, ticks = 6, 3
    svc = fleet_service_from_config(
        cfg, rule, n, service=tcfg.SERVICE_PRESETS["off"], horizon_ticks=8,
        seed=5, device="cpu")
    ctl = fleet_controller_from_config(
        cfg, rule, n, horizon_ticks=8, seed=5, fanout_workers=1,
        device="cpu")
    r_svc = svc.run(ticks)
    r_ctl = [ctl.tick(t) for t in range(ticks)]
    for a, b in zip(r_svc, r_ctl):
        assert (a.t, a.applied, a.slo_ok) == (b.t, b.applied, b.slo_ok)
        assert a.cost_usd_hr == b.cost_usd_hr
        assert a.carbon_g_hr == b.carbon_g_hr
    for sa, sb in zip(svc.sinks, ctl.sinks):
        assert [(c.name, c.patch_type, c.patch) for c in sa.commands] \
            == [(c.name, c.patch_type, c.patch) for c in sb.commands]
    assert not hasattr(svc, "breakers")
    svc.close()
    ctl.close()


def test_healthy_tenants_bitwise_match_calm_run(cfg, rule):
    n, ticks = 8, 8
    mk = dict(service=tcfg.SERVICE_PRESETS["default"], horizon_ticks=16,
              seed=3, device="cpu")
    stress = fleet_service_from_config(
        cfg, rule, n, profiles=["healthy"] * 5 + ["slow"] * 2 + ["flaky"],
        **mk)
    calm = fleet_service_from_config(cfg, rule, n,
                                     profiles=["healthy"] * n, **mk)
    stress.run(ticks)
    calm.run(ticks)
    np.testing.assert_array_equal(stress.tenant_usd_per_slo_hr()[:5],
                                  calm.tenant_usd_per_slo_hr()[:5])
    assert stress.tenant_fresh_ticks[:5].min() == ticks
    assert stress.tenant_fresh_ticks[5:].max() < ticks
    stress.close()
    calm.close()


def test_hung_scrape_deferred_then_breaker_bulkheads(cfg, rule):
    n, ticks = 4, 10
    svc = fleet_service_from_config(
        cfg, rule, n, profiles=["healthy"] * 3 + ["slow"],
        service=_svc(breaker_failures=2, breaker_probe_ticks=4),
        horizon_ticks=16, seed=11, device="cpu")
    reports = svc.run(ticks)
    assert svc.scrape_timeouts_total >= 2
    assert svc.breakers[3].transitions["opened"] >= 1
    assert svc.bulkhead_skips_total > 0
    assert all(r.admitted >= 3 for r in reports)
    assert svc.tenant_fresh_ticks[:3].min() == ticks
    assert max(svc.latencies_ms) < svc.svc.tick_deadline_ms
    assert any(r.tick_latency_ms > 50.0 for r in reports[:3])
    assert reports[-1].tick_latency_ms < 100.0
    assert any(r.scrape_failed > 0 for r in reports)
    assert any(r.bulkhead_skipped > 0 for r in reports)
    for r in reports:
        assert (r.admitted + r.shed + r.cadence_skipped + r.deferred
                + r.bulkhead_skipped + r.scrape_failed) == n, r
    svc.close()


def test_open_breaker_escalates_hold_to_rule_fallback(cfg, rule):
    svc = fleet_service_from_config(
        cfg, rule, 3, profiles=["healthy"] * 2 + ["slow"],
        service=_svc(breaker_failures=1, hold_fallback_after=2,
                     breaker_probe_ticks=32),
        horizon_ticks=16, seed=2, device="cpu")
    svc.run(6)
    assert svc.last_lanes.tolist() == [LANE_FRESH, LANE_FRESH,
                                       LANE_FALLBACK]
    svc.close()


def test_shed_priority_and_cadence_degradation(cfg, rule):
    n, ticks = 6, 8
    svc = fleet_service_from_config(
        cfg, rule, n, profiles=["healthy"] * 3 + ["batch"] * 3,
        service=_svc(admission_queue_cap=4, shed_backoff_after=2,
                     cadence_backoff_max=4),
        horizon_ticks=16, seed=9, device="cpu")
    reports = svc.run(ticks)
    assert svc.sheds_total > 0
    assert svc.tenant_fresh_ticks[:3].min() == ticks
    assert svc.tenant_fresh_ticks[3:].max() < ticks
    assert 1 < reports[-1].cadence_divisor <= 4
    assert svc.cadence_skips_total > 0
    for r in reports:
        assert (r.admitted + r.shed + r.cadence_skipped + r.deferred
                + r.bulkhead_skipped + r.scrape_failed) == n
    svc.close()


def test_unknown_profiles_rejected_up_front(cfg, rule):
    msgs = []
    for resolve in (resolve_profiles, jsvc.resolve_profiles):
        with pytest.raises(ValueError) as e:
            resolve(["healthy", "bogus"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "unknown tenant profiles" in msgs[0]
    with pytest.raises(ValueError, match="unknown tenant profiles"):
        fleet_service_from_config(
            cfg, rule, 2, profiles=["healthy", "bogus"],
            service=tcfg.SERVICE_PRESETS["default"], horizon_ticks=8,
            device="cpu")
    assert [p.name for p in resolve_profiles(list(TENANT_PROFILES))] \
        == list(TENANT_PROFILES)
    assert {k: dataclasses.asdict(v) for k, v in TENANT_PROFILES.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in jsvc.TENANT_PROFILES.items()}


def test_vectorized_bitwise_object_at_small_n(cfg, rule):
    profiles = ["healthy", "batch", "jittery", "slow", "flaky"] * 2
    n = len(profiles)
    res = _run_paired(
        cfg, rule, n, profiles, _svc(breaker_failures=2,
                                     admission_queue_cap=n - 2),
        ticks=10, seed=211, horizon=14,
        variants={"vectorized": ("vectorized", None),
                  "object": ("object", None)}, device="cpu")
    assert res["bitwise_identical"], res["mismatches"]
    assert set(res["checked"]) >= {"report_counters", "patch_streams",
                                   "held_rows", "tenant_usd",
                                   "tenant_slo_ticks",
                                   "breaker_transitions"}


def test_report_fields_are_jax_s():
    assert [f.name for f in dataclasses.fields(svc_mod.ServiceTickReport)] \
        == [f.name for f in dataclasses.fields(jsvc.ServiceTickReport)]
    assert (svc_mod.LANE_FRESH, svc_mod.LANE_HOLD, svc_mod.LANE_FALLBACK) \
        == (jsvc.LANE_FRESH, jsvc.LANE_HOLD, jsvc.LANE_FALLBACK)


def test_default_device_raises_without_gpu(cfg, rule):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_service_from_config(cfg, rule, 2)
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc_mod.FleetService(cfg, rule, src, [DryRunSink()])
    # No capture failure is caught and carried on eagerly: the card
    # refuses a backend its graph cannot hold before any tick.
    from ccka_tpu_torch.train.mpc import MPCBackend
    with pytest.raises(ValueError, match="cannot be captured"):
        svc_mod._build_service_tick(cfg, MPCBackend(cfg, device="cpu"), 2,
                                    16, "cuda", chunked=False)


# ---- `fleet --service` against JAX's command line ----------------------------


@pytest.mark.parametrize("obs", [[], ["--obs", "default",
                                       "--incidents-out", "inc.jsonl",
                                       "--decisions-out", "dec.jsonl"]],
                         ids=["plain", "obs"])
def test_fleet_service_reports_jax_s_keys(obs, tmp_path, monkeypatch):
    """`fleet --service default`: JAX's summary keys, with and without
    the obs flags (JAX writes its files beside the port's)."""
    monkeypatch.chdir(tmp_path)
    argv = ["fleet", "--service", "default", "--clusters", "8", "--ticks",
            "4", "--profiles", "healthy,batch,flaky"]
    jrc, jout, _ = _run(jmain, argv + [a.replace(".jsonl", "-j.jsonl")
                                       for a in obs])
    trc, tout, terr = _run(tmain, argv + obs + CPU)
    assert jrc == trc == 0, terr[-2000:]
    want, got = _json_out(jout), _json_out(tout)
    assert set(got) == set(want)
    assert (got["clusters"], got["ticks"], got["service"]) == (8, 4,
                                                              "default")
    if obs:
        assert got["decision_rows_total"] == 32
        assert os.path.exists("inc.jsonl") and os.path.exists("dec.jsonl")
        assert set(got["incident_counts"]) <= {
            "breaker_open", "reconcile_giveup", "policy_divergence",
            "hold_fallback", "deadline_overshoot", "shed_spike"}


def test_fleet_service_off_delegates_to_the_bare_fleet():
    want, got = _both(["fleet", "--service", "off", "--clusters", "4",
                       "--ticks", "2"])
    assert set(got) == set(want) and got["applied_frac"] == 1.0


def test_converge_deadline_reads_the_service_clock(cfg, rule):
    """A converge's deadline is read on the service's clock: on the real
    clock a 60 ms stall inside a failing apply gives up at the 37.5 ms
    converge budget; on the deterministic clock the same stall does not
    move the clock, the retry runs, and the tenant applies."""
    import time

    from ccka_tpu_torch.actuation.sink import ApplyResult

    class StallOnce(DryRunSink):
        def __init__(self):
            super().__init__()
            self.stalled = False

        def apply_nodepool(self, ps):
            if not self.stalled:
                self.stalled = True
                time.sleep(0.06)
                return ApplyResult(ps.pool, ok=False, used_fallback=False)
            return super().apply_nodepool(ps)

    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    out = {}
    for name, clock in (("real", None), ("det", det_clock())):
        svc = svc_mod.FleetService(
            cfg, rule, src, [StallOnce()],
            service=tcfg.SERVICE_PRESETS["default"], horizon_ticks=8,
            seed=1, clock=clock, device="cpu")
        rep = svc.tick(0)
        out[name] = (rep.applied, svc.actuation_giveups_total)
        svc.close()
    assert out == {"real": (0, 1), "det": (1, 0)}
