"""The port's decision-provenance ledger against the JAX package's.

- the layout, the action names and the objective decomposition are the
  JAX package's, exactly;
- the device half (`shadow_decision_columns`) within 1e-5 relative of
  JAX's on the same metrics, exo and actions (float32 arithmetic whose
  zone means may add in another order);
- the host half fed identical per-cluster rows writes JSON-equal records
  and a byte-identical JSONL, and `explain_row` renders identical text;
- in the port: the rule fleet is its own shadow (divergence exactly 0),
  the carbon fleet genuinely diverges, every row's shares sum to 1,
  ledger-on and ledger-off fleets are bitwise, and a spike stamps one
  `policy_divergence` incident.

The service cases of `tests/test_decisions.py` too: through
`FleetService` the shadow rows are bitwise a standalone rule decide on
the same pre-step states and exo, a rule service is its own shadow on
every fresh lane, a carbon service diverges and stamps one edge-triggered
`policy_divergence` incident with a verifying dump, ledger-on and
ledger-off services are bitwise, and on JAX's traces the service's
ledger counts, lanes and incidents are JAX's.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.obs.decisions as jdec
import ccka_tpu_torch.config as tcfg
from ccka_tpu.sim.dynamics import ExoStep as JExoStep
from ccka_tpu.sim.types import StepMetrics as JStepMetrics
from ccka_tpu_torch import cli
from ccka_tpu_torch.actuation.sink import DryRunSink
from ccka_tpu_torch.harness import fleet as fl
from ccka_tpu_torch.obs import decisions as dec
from ccka_tpu_torch.obs.incidents import IncidentLog
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.types import StepMetrics

OVERRIDES = {"sim.horizon_steps": 16}


@pytest.fixture(scope="module")
def cfgs():
    return (jcfg.default_config().with_overrides(**OVERRIDES),
            tcfg.default_config().with_overrides(**OVERRIDES))


def _fleet(ct, backend, n=6, seed=11, **kw):
    src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals)
    return fl.FleetController(ct, backend, src,
                              [DryRunSink() for _ in range(n)],
                              horizon_ticks=16, seed=seed, fanout_workers=1,
                              device="cpu", **kw)


def _rows(ctrl, ticks):
    out = []
    for t in range(ticks):
        ctrl.tick(t)
        out.append(ctrl.last_rows)
    return out


def test_layout_names_and_terms_are_jax_s(cfgs):
    cj, ct = cfgs
    assert dec.DECISION_COLS == jdec.DECISION_COLS
    assert dec.CAND_COLS == jdec.CAND_COLS
    assert dec.TERM_NAMES == jdec.TERM_NAMES
    assert dec.LANE_NAMES == jdec.LANE_NAMES
    for cand in ((), ("rule", "carbon")):
        a, b = (jdec.decision_row_layout(cj.cluster, cand),
                dec.decision_row_layout(ct.cluster, cand))
        assert (a.a_dim, a.base, a.cols, a.shadow_action, a.region_carbon,
                a.width) == (b.a_dim, b.base, b.cols, b.shadow_action,
                             b.region_carbon, b.width)
        for c in cand:
            assert a.cand_lean(c) == b.cand_lean(c)
            assert a.cand_col(c, "cand_slo_ok") == b.cand_col(c,
                                                             "cand_slo_ok")
    assert dec.flat_action_names(ct.cluster) == \
        jdec.flat_action_names(cj.cluster)
    assert dec.action_dim(ct.cluster) == jdec.action_dim(cj.cluster)
    kw = dict(cost_usd=0.5, carbon_g=100.0, pend_c0=3.0, pend_c1=1.0,
              slo_ok=0.0, migration_cost_usd=0.25)
    assert dec.objective_terms(ct.train, **kw) == \
        jdec.objective_terms(cj.train, **kw)
    terms = dec.objective_terms(ct.train, **kw)[0]
    assert dec.term_shares(terms) == jdec.term_shares(terms)
    assert sum(dec.term_shares(terms).values()) == pytest.approx(1.0)
    assert dec.term_shares({k: 0.0 for k in dec.TERM_NAMES}) == {}


def _random_metrics(rng, n, z):
    shapes = {"served_pods": (n, 2), "pending_pods": (n, 2),
              "desired_pods": (n, 2), "demand_pods": (n, 2),
              "nodes_by_ct": (n, 2), "nodes_by_zone": (n, z)}
    d = {f: rng.uniform(0, 30, shapes.get(f, (n,))).astype(np.float32)
         for f in StepMetrics._fields}
    d["slo_ok"] = (rng.uniform(size=n) > 0.5).astype(np.float32)
    return d


def test_shadow_columns_match_jax(cfgs):
    _, ct = cfgs
    rng = np.random.default_rng(0)
    n, z, a = 11, ct.cluster.n_zones, dec.action_dim(ct.cluster)
    chosen, shadow = _random_metrics(rng, n, z), _random_metrics(rng, n, z)
    exo = {"spot_price_hr": rng.uniform(0.02, 0.09, (n, z)),
           "od_price_hr": rng.uniform(0.09, 0.1, (n, z)),
           "carbon_g_kwh": rng.uniform(200, 550, (n, z)),
           "demand_pods": rng.uniform(0, 40, (n, 2)),
           "is_peak": (rng.uniform(size=n) > 0.5).astype(np.float64)}
    exo = {k: v.astype(np.float32) for k, v in exo.items()}
    fc, fs = (rng.uniform(0, 1, (n, a)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jdec.shadow_decision_columns(
        JStepMetrics(**{k: jnp.asarray(v) for k, v in chosen.items()}),
        JStepMetrics(**{k: jnp.asarray(v) for k, v in shadow.items()}),
        JExoStep(**{k: jnp.asarray(v) for k, v in exo.items()}),
        jnp.asarray(fc), jnp.asarray(fs)))
    t = torch.as_tensor
    got = dec.shadow_decision_columns(
        StepMetrics(**{k: t(v) for k, v in chosen.items()}),
        StepMetrics(**{k: t(v) for k, v in shadow.items()}),
        ExoStep(**{k: t(v) for k, v in exo.items()}), t(fc), t(fs)).numpy()
    assert got.shape == want.shape == (n, len(dec.DECISION_COLS))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ledgers_fed_identical_rows_write_identical_records(cfgs, tmp_path):
    cj, ct = cfgs
    rows = _rows(_fleet(ct, CarbonAwarePolicy(ct.cluster, device="cpu")),
                 5)
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "port")}
    jl = jdec.DecisionLedger(jcfg.ObsConfig(
        enabled=True, decision_log_path=paths["jax"]), cj.train,
        policy="carbon")
    tl = dec.DecisionLedger(tcfg.ObsConfig(
        enabled=True, decision_log_path=paths["port"]), ct.train,
        policy="carbon")
    jlay = jdec.decision_row_layout(cj.cluster)
    tlay = dec.decision_row_layout(ct.cluster)
    for t, packed, per in rows:
        js = jl.observe_tick(t, per, packed, jlay)
        ts = tl.observe_tick(t, per, packed, tlay)
        assert json.dumps(js, sort_keys=True) == json.dumps(ts,
                                                            sort_keys=True)
    jl.close()
    tl.close()
    assert list(jl.rows) == list(tl.rows)
    assert (jl.rows_total, jl.diverged_total, jl.spikes_total) == \
        (tl.rows_total, tl.diverged_total, tl.spikes_total)
    assert open(paths["jax"]).read() == open(paths["port"]).read()
    names = dec.flat_action_names(ct.cluster)
    for r in list(tl.rows)[:6]:
        assert dec.explain_row(r, action_names=names) == \
            jdec.explain_row(r, action_names=names)
    assert dec.read_decisions(paths["port"]) == \
        jdec.read_decisions(paths["jax"])


def test_rule_fleet_is_its_own_shadow(cfgs):
    _, ct = cfgs
    led = dec.DecisionLedger(tcfg.ObsConfig(enabled=True), ct.train,
                             policy="rule")
    ctrl = _fleet(ct, RulePolicy(ct.cluster, device="cpu"), ledger=led)
    ctrl.run(5)
    rows = list(led.rows)
    assert len(rows) == 5 * 6 and all(r["lane"] == "fresh" for r in rows)
    for r in rows:
        assert r["shadow"]["div_max_abs"] == 0.0
        assert r["shadow"]["div_l2"] == 0.0
        assert r["shadow"]["action"] == r["action"]
        assert r["shadow"]["objective"]["terms"] == r["objective"]["terms"]
    assert led.diverged_total == 0 and led.spikes_total == 0


def test_carbon_fleet_diverges_and_shares_sum_to_one(cfgs):
    _, ct = cfgs
    led = dec.DecisionLedger(tcfg.ObsConfig(enabled=True), ct.train,
                             policy="carbon")
    log = IncidentLog()
    ctrl = _fleet(ct, CarbonAwarePolicy(ct.cluster, device="cpu"), n=3,
                  ledger=led, incident_log=log)
    ctrl.run(2)
    assert led.rows_total == 6 and led.diverged_total == 6
    for r in led.rows:
        for side in (r["objective"], r["shadow"]["objective"]):
            assert sum(side["shares"].values()) == pytest.approx(1.0,
                                                                 abs=1e-9)
            assert set(side["shares"]) == set(dec.TERM_NAMES)
    # The 1:1 spikes == incidents invariant holds from the bare fleet.
    assert led.spikes_total == 1
    assert log.counts() == {"policy_divergence": 1}


def test_ledger_on_and_off_fleets_are_bitwise(cfgs, tmp_path):
    _, ct = cfgs
    backend = CarbonAwarePolicy(ct.cluster, device="cpu")
    off = _fleet(ct, backend)
    led = dec.DecisionLedger(tcfg.ObsConfig(
        enabled=True, decision_log_path=str(tmp_path / "d.jsonl")),
        ct.train, policy="carbon")
    on = _fleet(ct, backend, ledger=led)
    for a, b in zip(_rows(off, 6), _rows(on, 6)):
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) \
            and np.array_equal(a[2], b[2])
    assert all(torch.equal(x, y) for x, y in zip(off.states, on.states))
    assert [[c.render() for c in s.commands] for s in off.sinks] == \
        [[c.render() for c in s.commands] for s in on.sinks]
    assert led.rows_total == 36 and led.diverged_total > 0


def test_decisions_cli_matches_jax(cfgs, tmp_path, capsys):
    import ccka_tpu.cli as jcli

    _, ct = cfgs
    path = str(tmp_path / "d.jsonl")
    led = dec.DecisionLedger(tcfg.ObsConfig(
        enabled=True, decision_log_path=path), ct.train, policy="carbon")
    _fleet(ct, CarbonAwarePolicy(ct.cluster, device="cpu"), n=3,
           ledger=led).run(3)
    led.close()
    for argv in (["decisions", "list", path, "-n", "4"],
                 ["decisions", "show", path, "--t", "1"],
                 ["decisions", "explain", path, "--t", "2", "--tenant",
                  "1"]):
        outs = []
        for main in (cli.main, jcli.main):
            assert main(list(argv)) == 0
            outs.append(capsys.readouterr())
        assert outs[0].out == outs[1].out and outs[0].out
        assert outs[0].err == outs[1].err
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match="needs --t TICK"):
            main(["decisions", "explain", path])
        with pytest.raises(SystemExit, match="no decision rows"):
            main(["decisions", "show", path, "--t", "99"])


def test_explain_renderer_names_action_deltas():
    row = {
        "t": 3, "tenant": 0, "lane": "fresh", "policy": "carbon",
        "exo": {"spot_price_hr": 0.03, "od_price_hr": 0.096,
                "carbon_g_kwh": 400.0, "demand_pods": 25.0,
                "is_peak": False},
        "state": {"nodes_spot": 1.0, "nodes_od": 0.5},
        "action": [0.25, 1.0],
        "objective": {"total": 0.1,
                      "terms": {k: 0.025 for k in dec.TERM_NAMES},
                      "shares": {k: 0.25 for k in dec.TERM_NAMES},
                      "by_class": {"class0": 0.02, "class1": 0.005},
                      "migration_components": {"us-east>us-west": 0.01}},
        "shadow": {"policy": "rule", "action": [1.0, 1.0],
                   "objective": {"total": 0.1, "terms": {}, "shares": {},
                                 "by_class": {}},
                   "usd_delta": -0.01, "slo_delta": 1.0,
                   "div_max_abs": 0.75, "div_l2": 0.75, "diverged": True},
    }
    for names in (["zone_weight[0][0]", "zone_weight[0][1]"],
                  ["a", "b", "c"]):
        text = dec.explain_row(row, action_names=names)
        assert text == jdec.explain_row(row, action_names=names)
    assert "zone_weight[0][0]: 0.250 vs rule 1.000" in dec.explain_row(
        row, action_names=["zone_weight[0][0]", "zone_weight[0][1]"])
    assert "action labels omitted" in dec.explain_row(
        row, action_names=["a", "b", "c"])


# ---- the service cases ------------------------------------------------------


def det_clock():
    from ccka_tpu_torch.harness.service import VirtualClock

    state = {"s": 0.0}

    def base():
        state["s"] += 1e-4
        return state["s"]
    return VirtualClock(base=base)


def _obs(tmp_path=None, **kw):
    base = dict(enabled=True)
    if tmp_path is not None:
        base.update(dump_dir=str(tmp_path / "dumps"),
                    incident_log_path=str(tmp_path / "incidents.jsonl"),
                    decision_log_path=str(tmp_path / "decisions.jsonl"))
    base.update(kw)
    return tcfg.ObsConfig(**base)


def _service(ct, backend, n, obs, *, ticks=8, seed=11, profiles=None,
             capture_states=False):
    from ccka_tpu_torch.harness.service import fleet_service_from_config

    svc = fleet_service_from_config(
        ct, backend, n, profiles=profiles or ["healthy"] * n,
        service=tcfg.SERVICE_PRESETS["default"], obs=obs, horizon_ticks=16,
        seed=seed, clock=det_clock(), device="cpu")
    states_pre = []
    for t in range(ticks):
        if capture_states:
            states_pre.append(type(svc.states)(*(x.clone()
                                                 for x in svc.states)))
        svc.tick(t)
    return svc, states_pre


@pytest.fixture(scope="module")
def t_carbon(cfgs):
    return CarbonAwarePolicy(cfgs[1].cluster, device="cpu")


def test_service_shadow_rows_bitwise_standalone_rule(cfgs, t_carbon):
    _, ct = cfgs
    svc, states_pre = _service(ct, t_carbon, 3, _obs(), ticks=4,
                               capture_states=True)
    rule_fn = RulePolicy(ct.cluster, device="cpu").action_fn()
    rows = list(svc.decisions.rows)
    assert len(rows) == 4 * 3
    for t in range(4):
        exo_n = fl.exo_at(svc.ctrl._xs_all, torch.tensor(t), 16)
        expect = fl.flatten_actions(fl.batched_action(
            rule_fn(states_pre[t], exo_n, torch.tensor(t)), 3), 3).numpy()
        for i in range(3):
            row = next(r for r in rows if r["t"] == t and r["tenant"] == i)
            np.testing.assert_array_equal(
                np.asarray(row["shadow"]["action"], np.float32), expect[i])
            assert row["exo"]["is_peak"] == bool(float(exo_n.is_peak[i])
                                                 > 0.5)
            assert row["exo"]["demand_pods"] == pytest.approx(
                float(exo_n.demand_pods[i].sum()), rel=1e-6)
    svc.close()


def test_service_rule_rows_are_their_own_shadow(cfgs):
    _, ct = cfgs
    svc, _ = _service(ct, RulePolicy(ct.cluster, device="cpu"), 3, _obs(),
                      ticks=6)
    rows = list(svc.decisions.rows)
    assert rows and all(r["lane"] == "fresh" for r in rows)
    for r in rows:
        assert r["shadow"]["div_max_abs"] == 0.0 == r["shadow"]["div_l2"]
        assert r["shadow"]["diverged"] is False
        assert r["shadow"]["action"] == r["action"]
        assert r["shadow"]["objective"]["terms"] == r["objective"]["terms"]
        assert r["shadow"]["usd_delta"] == 0.0 == r["shadow"]["slo_delta"]
    assert svc.decisions.diverged_total == 0 == svc.decisions.spikes_total
    assert svc.incidents.counts().get("policy_divergence", 0) == 0
    svc.close()


def test_service_carbon_diverges_and_shares_sum_to_one(cfgs, t_carbon):
    _, ct = cfgs
    svc, _ = _service(ct, t_carbon, 3, _obs(), ticks=6)
    assert svc.decisions.diverged_total > 0
    for r in svc.decisions.rows:
        for side in (r["objective"], r["shadow"]["objective"]):
            assert sum(side["shares"].values()) == pytest.approx(1.0,
                                                                 abs=1e-9)
            assert set(side["shares"]) == set(dec.TERM_NAMES)
            assert side["total"] > 0.0
    svc.close()


def _on_off_run(ct, backend, decisions_enabled, tmp_path=None):
    obs = (_obs(tmp_path, decisions_enabled=decisions_enabled)
           if tmp_path is not None
           else tcfg.ObsConfig(enabled=True,
                               decisions_enabled=decisions_enabled))
    svc, _ = _service(ct, backend, 5, obs, ticks=10,
                      profiles=["healthy"] * 3 + ["slow", "flaky"])
    out = {
        "usd": svc.tenant_usd_per_slo_hr().copy(),
        "fresh": svc.tenant_fresh_ticks.copy(),
        "states": [x.clone() for x in svc.states],
        "commands": [[c.render() for c in getattr(s, "inner", s).commands]
                     for s in svc.sinks],
        "rows": svc.decisions.rows_total if svc.decisions else 0,
        "diverged": svc.decisions.diverged_total if svc.decisions else 0,
    }
    svc.close()
    return out


def test_service_ledger_on_off_bitwise(cfgs, t_carbon, tmp_path):
    _, ct = cfgs
    off = _on_off_run(ct, t_carbon, False)
    on = _on_off_run(ct, t_carbon, True, tmp_path)
    np.testing.assert_array_equal(off["usd"], on["usd"])
    np.testing.assert_array_equal(off["fresh"], on["fresh"])
    assert all(torch.equal(a, b) for a, b in zip(off["states"],
                                                 on["states"]))
    assert off["commands"] == on["commands"]
    assert off["rows"] == 0 and on["rows"] > 0 and on["diverged"] > 0


def test_service_decisions_off_builds_no_ledger(cfgs):
    from ccka_tpu_torch.harness.service import fleet_service_from_config

    _, ct = cfgs
    svc = fleet_service_from_config(
        ct, RulePolicy(ct.cluster, device="cpu"), 2,
        service=tcfg.SERVICE_PRESETS["default"],
        obs=tcfg.ObsConfig(enabled=True, decisions_enabled=False),
        horizon_ticks=16, seed=1, device="cpu")
    assert svc.decisions is None
    rep = svc.tick(0)
    assert rep.policy_divergence_rate is None
    assert rep.objective_term_shares == {} and rep.shadow_slo_delta is None
    svc.close()


def test_service_divergence_incident(cfgs, t_carbon, tmp_path):
    from ccka_tpu_torch.obs.recorder import verify_dump

    _, ct = cfgs
    svc, _ = _service(ct, t_carbon, 4, _obs(tmp_path), ticks=8,
                      profiles=["healthy"] * 3 + ["slow"])
    counts = svc.incidents.counts()
    assert svc.decisions.spikes_total == counts["policy_divergence"] == 1
    for i in svc.incidents.incidents:
        if i.trigger == "policy_divergence":
            assert verify_dump(i.dump_path)["t"] == i.t
            assert i.details["rate"] >= i.details["threshold"]
    rep = svc.tick(8)
    assert 0.0 < rep.policy_divergence_rate <= 1.0
    assert sum(rep.objective_term_shares.values()) == pytest.approx(
        1.0, abs=1e-5)
    assert rep.shadow_slo_delta is not None
    assert rep.shadow_usd_delta is not None
    rows = dec.read_decisions(svc.obs.decision_log_path)
    assert len(rows) == svc.decisions.rows_total
    assert rows[0]["t"] == 0 and "shadow" in rows[0]
    svc.close()


@pytest.mark.parametrize("name", ["rule", "carbon"])
def test_service_ledger_matches_jax(name):
    """On JAX's traces the service's ledger records the same lanes, the
    same divergence verdicts and spikes, and stamps the same incidents;
    its rows' numbers within 1e-5 of JAX's."""
    from test_torch_service import MIX, run_pair, service_pair

    js, ts = service_pair(name, "default", 6, MIX,
                          obs_j=jcfg.ObsConfig(enabled=True),
                          obs_t=tcfg.ObsConfig(enabled=True))
    run_pair(js, ts, 8)
    jrows, trows = list(js.decisions.rows), list(ts.decisions.rows)
    assert len(jrows) == len(trows) == 48
    for a, b in zip(jrows, trows):
        assert (a["t"], a["tenant"], a["lane"], a["shadow"]["diverged"]) \
            == (b["t"], b["tenant"], b["lane"], b["shadow"]["diverged"])
        np.testing.assert_allclose(b["action"], a["action"], rtol=1e-5,
                                   atol=1e-6)
    assert (ts.decisions.diverged_total, ts.decisions.spikes_total) == \
        (js.decisions.diverged_total, js.decisions.spikes_total)
    assert [(i.trigger, i.t, i.tenant) for i in ts.incidents.incidents] \
        == [(i.trigger, i.t, i.tenant) for i in js.incidents.incidents]
    js.close()
    ts.close()
