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

The non-service cases of `tests/test_decisions.py`; the service's wait
for its slice.
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
