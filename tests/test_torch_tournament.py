"""The port's shadow tournament against the JAX package's.

- the registry lists JAX's candidates with JAX's descriptions; the
  flywheel challenger refuses an empty slot with JAX's message, and a
  slotted checkpoint rides a fleet's candidate lanes as JAX's
  `challenger_backend` does (the shipped multiregion flagship; rows
  within the flagship's 1e-3, its action divergence 5e-3);
- the device half: `tournament_decision_columns` within 1e-5 relative of
  JAX's on the same metrics and actions, and a rostered fleet's
  per-cluster rows (`add_candidate_lanes` inside the tick) within 1e-5
  of JAX's fleet on the same traces (pending pods at the demand's
  scale);
- the host half fed identical rows writes JSON-equal board rows and
  audits, `explain_board` / `explain_audit` render identical text,
  `sign_audit` gives identical signatures and `PromotionGate.review`
  the same verdicts;
- in the port: a ("rule",) roster's lanes are bitwise the rule shadow's
  columns, and ledger-on and ledger-off fleets are bitwise.

The service cases of `tests/test_tournament.py` too: through
`FleetService` a ("rule",) roster's candidate columns are bitwise its
shadow columns, tournament-on and -off services are bitwise, an empty
roster builds no ledger, an obs override naming another roster is
refused with JAX's message, and the over-provisioned incumbent's seeded
scenario stamps exactly one edge-triggered `challenger_sustained_win`
with a verifying dump and a signed audit — the same incident, board and
audit verdict as JAX's service on the same traces.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.obs.tournament as jtour
from ccka_tpu.actuation.sink import DryRunSink as JDryRunSink
from ccka_tpu.harness.fleet import FleetController as JFleet
from ccka_tpu.obs.decisions import decision_row_layout as jlayout
from ccka_tpu.policy import CarbonAwarePolicy as JCarbon
from ccka_tpu.sim.dynamics import ExoStep as JExoStep
from ccka_tpu.sim.types import StepMetrics as JStepMetrics
import ccka_tpu_torch.config as tcfg
from ccka_tpu_torch import cli
from ccka_tpu_torch.actuation.sink import DryRunSink
from ccka_tpu_torch.harness import fleet as fl
from ccka_tpu_torch.obs import tournament as tour
from ccka_tpu_torch.obs.decisions import CAND_COLS, decision_row_layout
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.types import StepMetrics

from test_torch_fleet import JFixed, TFixed, _jax_traces, _pending_cols

OVERRIDES = {"sim.horizon_steps": 16}
ROSTER = {"obs.tournament_roster": ("rule", "carbon", "carbon-sharp")}


@pytest.fixture(scope="module")
def cfgs():
    return (jcfg.default_config().with_overrides(**OVERRIDES),
            tcfg.default_config().with_overrides(**OVERRIDES))


def _fleet(ct, backend, n=5, seed=11, **kw):
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


def test_registry_is_jax_s_and_the_flywheel_challenger_builds_from_its_slot(
        cfgs, capsys):
    import ccka_tpu.cli as jcli
    import ccka_tpu.train.flywheel as jfw
    from ccka_tpu.train.flagship import flagship_checkpoint_path
    from ccka_tpu_torch.train import flywheel as tfw

    assert {k: v[1] for k, v in tour.CANDIDATE_BUILDERS.items()} == \
        {k: v[1] for k, v in jtour.CANDIDATE_BUILDERS.items()}
    outs = []
    for main in (cli.main, jcli.main):
        assert main(["tournament", "list"]) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].out
    assert outs[0].err == outs[1].err
    cj, ct = cfgs
    assert tour.workload_class("batch") == jtour.workload_class("batch")
    assert tour.WORKLOAD_CLASSES == jtour.WORKLOAD_CLASSES

    roster = ("flywheel-challenger",)
    msgs = []
    for pkg in (tfw, jfw):
        with pytest.raises(ValueError, match="does not exist") as e:
            pkg.set_challenger_checkpoint("/no/such/file.npz")
        msgs.append(str(e.value))
        pkg.set_challenger_checkpoint("")
    with pytest.raises(ValueError, match="no challenger checkpoint") as e:
        tour.TournamentRoster(ct, roster, device="cpu")
    msgs.append(str(e.value))
    with pytest.raises(ValueError, match="no challenger checkpoint") as e:
        jfw.challenger_backend(cj)
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]

    cj = jcfg.PRESETS["multiregion"]().with_overrides(
        **OVERRIDES, **{"obs.tournament_roster": roster})
    ct = tcfg.PRESETS["multiregion"]().with_overrides(
        **OVERRIDES, **{"obs.tournament_roster": roster})
    path = flagship_checkpoint_path(cj)
    n, ticks = 8, 3
    traces = _jax_traces(cj, n, seed=5)
    try:
        for pkg in (tfw, jfw):
            pkg.set_challenger_checkpoint(path)
        assert tfw.challenger_checkpoint() == jfw.challenger_checkpoint()
        jctrl = JFleet(cj, JCarbon(cj.cluster), JFixed(traces),
                       [JDryRunSink() for _ in range(n)], horizon_ticks=16,
                       seed=5, fanout_workers=1)
        tctrl = fl.FleetController(
            ct, CarbonAwarePolicy(ct.cluster, device="cpu"), TFixed(traces),
            [DryRunSink() for _ in range(n)], horizon_ticks=16, seed=5,
            fanout_workers=1, device="cpu")
        lay = decision_row_layout(ct.cluster, roster)
        tol = np.full(lay.width, 1e-3)
        tol[lay.cand_col(roster[0], "cand_div_max")] = 5e-3
        pend = _pending_cols(ct) + [
            lay.cand_col(roster[0], f) for f in ("cand_pend_c0",
                                                 "cand_pend_c1")]
        for t in range(ticks):
            disp = jctrl._dispatch(t)
            jq = np.asarray(disp.per_metrics)
            jctrl._harvest_and_fanout(disp)
            tctrl.tick(t)
            tq = tctrl.last_rows[2]
            assert tq.shape == jq.shape == (n, lay.width)
            scale = np.maximum(np.abs(jq), 1e-3)
            scale[:, pend] = np.maximum(scale[:, pend],
                                        ct.workload.total_pods)
            assert np.all(np.abs(tq - jq) / scale <= tol), t
            # The challenger is not the carbon incumbent: it diverges.
            assert float(tq[:, lay.cand_col(roster[0],
                                            "cand_div_max")].max()) > 0
    finally:
        for pkg in (tfw, jfw):
            pkg.set_challenger_checkpoint("")


def test_roster_rejections_leave_it_unchanged(cfgs):
    _, ct = cfgs
    with pytest.raises(ValueError, match="unknown tournament candidates"):
        tour.resolve_candidates(("rule", "no-such-policy"))
    with pytest.raises(ValueError, match="already registered"):
        tour.register_candidate("rule", lambda cfg, device=None: None)
    assert "Peak/Off-Peak" in tour.CANDIDATE_BUILDERS["rule"][1]
    roster = tour.TournamentRoster(ct, ("rule", "carbon"), device="cpu")
    with pytest.raises(ValueError, match="duplicate tournament candidate"):
        roster.register("rule", RulePolicy(ct.cluster, device="cpu"))

    class Broken:
        def action_fn(self):
            def fn(state, exo, t):
                raise RuntimeError("no checkpoint for you")
            return fn

    class WrongShape:
        def action_fn(self):
            return lambda state, exo, t: torch.zeros(1)

    for bad in (Broken(), WrongShape()):
        with pytest.raises(ValueError,
                           match="registration probe .roster unchanged."):
            roster.register("bad", bad)
    assert roster.names == ("rule", "carbon")
    assert [n for n, _fn in roster.action_fns()] == ["rule", "carbon"]


def _random_metrics(rng, k, n, z):
    shapes = {"served_pods": (2,), "pending_pods": (2,),
              "desired_pods": (2,), "demand_pods": (2,),
              "nodes_by_ct": (2,), "nodes_by_zone": (z,)}
    d = {f: rng.uniform(0, 30, (k, n) + shapes.get(f, ())).astype(
        np.float32) for f in StepMetrics._fields}
    d["slo_ok"] = (rng.uniform(size=(k, n)) > 0.5).astype(np.float32)
    return d


def test_tournament_columns_match_jax():
    cj, ct = (jcfg.PRESETS["multiregion"](), tcfg.PRESETS["multiregion"]())
    rng = np.random.default_rng(3)
    k, n = 3, 7
    p, z = ct.cluster.n_pools, ct.cluster.n_zones
    a = decision_row_layout(ct.cluster).a_dim
    metrics = _random_metrics(rng, k, n, z)
    flat_c = rng.uniform(0, 1, (k, n, a)).astype(np.float32)
    flat = rng.uniform(0, 1, (n, a)).astype(np.float32)
    zw = rng.uniform(0, 1, (k, n, p, z)).astype(np.float32)
    exo = {"spot_price_hr": rng.uniform(0.02, 0.09, (n, z)),
           "od_price_hr": rng.uniform(0.09, 0.1, (n, z)),
           "carbon_g_kwh": rng.uniform(200, 550, (n, z)),
           "demand_pods": rng.uniform(0, 40, (n, 2)),
           "is_peak": np.ones(n)}
    exo = {kk: v.astype(np.float32) for kk, v in exo.items()}
    zri, r = ct.cluster.zone_region_index, ct.cluster.n_regions
    want = np.asarray(jtour.tournament_decision_columns(
        JStepMetrics(**{kk: jnp.asarray(v) for kk, v in metrics.items()}),
        jnp.asarray(flat_c), jnp.asarray(flat), jnp.asarray(zw),
        JExoStep(**{kk: jnp.asarray(v) for kk, v in exo.items()}), zri, r))
    t = torch.as_tensor
    got = tour.tournament_decision_columns(
        StepMetrics(**{kk: t(v) for kk, v in metrics.items()}), t(flat_c),
        t(flat), t(zw), ExoStep(**{kk: t(v) for kk, v in exo.items()}),
        zri, r).numpy()
    assert got.shape == want.shape == (n, r + k * (len(CAND_COLS) + r))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_rostered_fleet_rows_match_jax():
    cj = jcfg.PRESETS["multiregion"]().with_overrides(**OVERRIDES, **ROSTER)
    ct = tcfg.PRESETS["multiregion"]().with_overrides(**OVERRIDES, **ROSTER)
    n, ticks = 8, 4
    traces = _jax_traces(cj, n, seed=5)
    jctrl = JFleet(cj, JCarbon(cj.cluster), JFixed(traces),
                   [JDryRunSink() for _ in range(n)], horizon_ticks=16,
                   seed=5, fanout_workers=1)
    tctrl = fl.FleetController(ct, CarbonAwarePolicy(ct.cluster,
                                                     device="cpu"),
                               TFixed(traces),
                               [DryRunSink() for _ in range(n)],
                               horizon_ticks=16, seed=5, fanout_workers=1,
                               device="cpu")
    lay = decision_row_layout(ct.cluster, ROSTER["obs.tournament_roster"])
    assert lay.width == jlayout(cj.cluster,
                                ROSTER["obs.tournament_roster"]).width
    pend = _pending_cols(ct) + [
        lay.cand_col(c, f) for c in ROSTER["obs.tournament_roster"]
        for f in ("cand_pend_c0", "cand_pend_c1")]
    for t in range(ticks):
        disp = jctrl._dispatch(t)
        jq = np.asarray(disp.per_metrics)
        jctrl._harvest_and_fanout(disp)
        tctrl.tick(t)
        tq = tctrl.last_rows[2]
        assert tq.shape == jq.shape == (n, lay.width)
        scale = np.maximum(np.abs(jq), 0.1)
        scale[:, pend] = np.maximum(scale[:, pend],
                                    ct.workload.total_pods)
        assert float(np.max(np.abs(tq - jq) / scale)) <= 1e-5
    assert [[c.render() for c in s.commands] for s in tctrl.sinks] == \
        [[c.render() for c in s.commands] for s in jctrl.sinks]


def test_k1_rule_lanes_are_the_rule_shadow():
    ct = tcfg.default_config().with_overrides(
        **OVERRIDES, **{"obs.tournament_roster": ("rule",)})
    ctrl = _fleet(ct, CarbonAwarePolicy(ct.cluster, device="cpu"), n=3)
    lay = ctrl._dec_layout
    pairs = [("cand_cost_usd", "shadow_cost_usd"),
             ("cand_carbon_g", "shadow_carbon_g"),
             ("cand_pend_c0", "shadow_pend_c0"),
             ("cand_pend_c1", "shadow_pend_c1"),
             ("cand_slo_ok", "shadow_slo_ok"),
             ("cand_div_max", "div_max_abs")]
    for _t, _packed, per in _rows(ctrl, 4):
        for cand_col, shadow_col in pairs:
            np.testing.assert_array_equal(per[:, lay.cand_col("rule",
                                                              cand_col)],
                                          per[:, lay.col(shadow_col)])
    lay0 = decision_row_layout(ct.cluster)
    assert lay0.cols == lay.cols and lay0.shadow_action == lay.shadow_action
    assert lay.width == (lay0.width + 2 * ct.cluster.n_regions
                         + len(CAND_COLS))


def test_ledger_on_and_off_fleets_are_bitwise(tmp_path):
    ct = tcfg.default_config().with_overrides(
        **OVERRIDES, **{"obs.tournament_roster": ("rule", "carbon")})
    backend = CarbonAwarePolicy(ct.cluster, device="cpu")
    off_rows = _rows(_fleet(ct, backend), 6)
    obs = tcfg.ObsConfig(enabled=True, tournament_roster=("rule", "carbon"),
                         tournament_log_path=str(tmp_path / "t.jsonl"))
    led = tour.TournamentLedger(obs, ct.train, ("rule", "carbon"),
                                policy="carbon")
    on = _fleet(ct, backend)
    on_rows = []
    for t in range(6):
        on.tick(t)
        on_rows.append(on.last_rows)
        led.observe_tick(t, on.last_rows[2], on._dec_layout)
    led.close()
    for a, b in zip(off_rows, on_rows):
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert led.ticks_total == 6 and led.comparisons_total == 6 * 5 * 2


def _crafted(lay, n, chosen_cost, cand_cost, name="carbon"):
    per = np.zeros((n, lay.width), np.float32)
    per[:, 0] = 1.0
    per[:, 1] = chosen_cost
    per[:, lay.cand_col(name, "cand_slo_ok")] = 1.0
    per[:, lay.cand_col(name, "cand_cost_usd")] = cand_cost
    return per


def test_ledgers_fed_identical_rows_write_identical_boards(cfgs, tmp_path):
    """The challenger scenario's ledger arithmetic, both packages on the
    same crafted rows: per-class splits, the sliding window, ties, one
    edge-triggered challenger with its signed audit, the final board."""
    cj, ct = cfgs
    names = ("carbon",)
    kw = dict(enabled=True, tournament_roster=names, tournament_window=4,
              tournament_sustain_ticks=3, tournament_win_rate=0.6)
    classes = ["inference", "inference", "batch", "background"]
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "port")}
    jl = jtour.TournamentLedger(jcfg.ObsConfig(
        tournament_log_path=paths["jax"], **kw), cj.train, names,
        classes=classes, policy="overprovision")
    tl = tour.TournamentLedger(tcfg.ObsConfig(
        tournament_log_path=paths["port"], **kw), ct.train, names,
        classes=classes, policy="overprovision")
    jlay = jlayout(cj.cluster, names)
    tlay = decision_row_layout(ct.cluster, names)
    rng = np.random.default_rng(7)
    surfaces = []
    for t in range(12):
        cand = (rng.random(4).astype(np.float32) * (2.0 if t < 4 else 0.9))
        if t == 5:
            cand[:] = 1.0                      # ties do not win
        per = _crafted(tlay, 4, 1.0, cand)
        js = jl.observe_tick(t, per, jlay)
        ts = tl.observe_tick(t, per, tlay)
        assert json.dumps(js, sort_keys=True) == json.dumps(ts,
                                                            sort_keys=True)
        surfaces.append(ts)
    jl.close()
    tl.close()
    assert tl.challengers_total == jl.challengers_total == 1
    assert open(paths["jax"]).read() == open(paths["port"]).read()
    rows = tour.read_tournament(paths["port"])
    boards = [r for r in rows if r["kind"] == "board"]
    audits = [r for r in rows if r["kind"] == "promotion_audit"]
    assert boards and len(audits) == 1
    key = ct.obs.tournament_audit_key
    assert tour.verify_audit(audits[0], key)
    assert audits[0]["auto_switch"] is False
    for b in boards:
        assert tour.explain_board(b) == jtour.explain_board(b)
    assert tour.explain_audit(audits[0], key) == \
        jtour.explain_audit(audits[0], key)
    assert tour.explain_audit(audits[0], "other") == \
        jtour.explain_audit(audits[0], "other")


def test_signatures_and_gate_verdicts_are_jax_s(cfgs):
    cj, ct = cfgs
    rec = {"kind": "promotion_audit", "t": 3, "challenger": "c",
           "decision": "needs-bench-recheck", "classes": {"batch": 1}}
    for key in ("k1", "sekrit"):
        assert tour.sign_audit(rec, key) == jtour.sign_audit(rec, key)
    signed = {**rec, "signature": tour.sign_audit(rec, "k1")}
    assert tour.verify_audit(signed, "k1")
    assert not tour.verify_audit(signed, "k2")
    assert not tour.verify_audit({**signed, "t": 4}, "k1")
    jgate = jtour.PromotionGate(jcfg.ObsConfig(
        enabled=True, tournament_audit_key="sekrit"), "incumbent")
    tgate = tour.PromotionGate(tcfg.ObsConfig(
        enabled=True, tournament_audit_key="sekrit"), "incumbent")
    board = {"carbon": {"win_rate": 0.9, "classes": {}}}
    for bench in (None, {"bitwise_identical": True,
                         "overhead_gate_ok": True, "board_gate_ok": True},
                  {"bitwise_identical": False, "overhead_gate_ok": True}):
        kw = dict(sustained_ticks=8, window_ticks=16, t=5,
                  bench_record=bench)
        a = tgate.review("carbon", board, **kw)
        assert a == jgate.review("carbon", board, **kw)
        assert a["auto_switch"] is False
    assert tgate.audits_total == 3


def test_tournament_cli_matches_jax(cfgs, tmp_path, capsys):
    import ccka_tpu.cli as jcli

    _, ct = cfgs
    names = ("carbon",)
    path = str(tmp_path / "t.jsonl")
    led = tour.TournamentLedger(tcfg.ObsConfig(
        enabled=True, tournament_roster=names, tournament_window=4,
        tournament_sustain_ticks=2, tournament_win_rate=0.5,
        tournament_log_path=path), ct.train, names, policy="chosen")
    lay = decision_row_layout(ct.cluster, names)
    for t in range(6):
        led.observe_tick(t, _crafted(lay, 3, 1.0, 0.5), lay)
    led.close()
    for argv in (["tournament", "board", path],
                 ["tournament", "explain", path],
                 ["tournament", "explain", path, "--key", "other"]):
        outs = []
        for main in (cli.main, jcli.main):
            assert main(list(argv)) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0]
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match="needs the tournament JSONL"):
            main(["tournament", "board"])


def test_overprovision_incumbent_loses_to_the_carbon_lane():
    """The challenger scenario on a bare fleet: the over-provisioned
    incumbent's slack is what the carbon candidate's consolidation
    reclaims, so its windowed win rate crosses the bar."""
    ct = tcfg.default_config().with_overrides(**{
        **OVERRIDES, "obs.tournament_roster": ("carbon",)})
    inc = tour.OverProvisionPolicy(ct.cluster, device="cpu")
    assert inc.name == "overprovision"
    obs = tcfg.ObsConfig(enabled=True, tournament_roster=("carbon",),
                         tournament_window=8, tournament_sustain_ticks=4,
                         tournament_win_rate=0.6)
    led = tour.TournamentLedger(obs, ct.train, ("carbon",),
                                policy=inc.name)
    ctrl = _fleet(ct, inc, n=4)
    for t in range(12):
        ctrl.tick(t)
        s = led.observe_tick(t, ctrl.last_rows[2], ctrl._dec_layout)
    assert s["candidate_win_rate"]["carbon"] >= 0.6
    assert led.challengers_total == 1


# ---- the service cases ------------------------------------------------------


def _service(run_cfg, backend, n, obs, *, ticks=8, seed=11, profiles=None,
             capture_rows=False):
    from test_torch_decisions import det_clock

    from ccka_tpu_torch.harness.service import fleet_service_from_config

    svc = fleet_service_from_config(
        run_cfg, backend, n, profiles=profiles or ["healthy"] * n,
        service=tcfg.SERVICE_PRESETS["default"], obs=obs, horizon_ticks=16,
        seed=seed, clock=det_clock(), device="cpu")
    rows = []
    if capture_rows and svc.tournament is not None:
        orig = svc.tournament.observe_tick

        def spy(t, per_np, layout, **kw):
            rows.append(np.array(per_np))
            return orig(t, per_np, layout, **kw)
        svc.tournament.observe_tick = spy
    return svc, svc.run(ticks), rows


def _tobs(tmp_path=None, **kw):
    base = dict(enabled=True)
    if tmp_path is not None:
        base.update(dump_dir=str(tmp_path / "dumps"),
                    incident_log_path=str(tmp_path / "incidents.jsonl"),
                    tournament_log_path=str(tmp_path / "tournament.jsonl"))
    base.update(kw)
    return tcfg.ObsConfig(**base)


def test_service_k1_candidate_columns_bitwise_shadow_columns(tmp_path):
    ct = tcfg.default_config().with_overrides(
        **OVERRIDES, **{"obs.tournament_roster": ("rule",)})
    svc, _reports, rows = _service(
        ct, CarbonAwarePolicy(ct.cluster, device="cpu"), 3,
        _tobs(tmp_path), ticks=4, capture_rows=True)
    assert len(rows) == 4
    lay = svc._dec_layout
    for per in rows:
        for cand_col, shadow_col in (("cand_cost_usd", "shadow_cost_usd"),
                                     ("cand_carbon_g", "shadow_carbon_g"),
                                     ("cand_pend_c0", "shadow_pend_c0"),
                                     ("cand_pend_c1", "shadow_pend_c1"),
                                     ("cand_slo_ok", "shadow_slo_ok"),
                                     ("cand_div_max", "div_max_abs")):
            np.testing.assert_array_equal(
                per[:, lay.cand_col("rule", cand_col)],
                per[:, lay.col(shadow_col)], err_msg=cand_col)
    svc.close()


def test_service_tournament_on_off_bitwise(tmp_path):
    ct = tcfg.default_config().with_overrides(
        **OVERRIDES, **{"obs.tournament_roster": ("rule", "carbon")})
    backend = CarbonAwarePolicy(ct.cluster, device="cpu")
    runs = {}
    for on in (False, True):
        obs = (_tobs(tmp_path, tournament_enabled=True) if on
               else tcfg.ObsConfig(enabled=True, tournament_enabled=False))
        svc, _r, _ = _service(ct, backend, 5, obs, ticks=10,
                              profiles=["healthy"] * 3 + ["slow", "flaky"])
        runs[on] = (svc.tenant_usd_per_slo_hr().copy(),
                    svc.tenant_fresh_ticks.copy(),
                    [x.clone() for x in svc.states],
                    [[c.render() for c in getattr(k, "inner", k).commands]
                     for k in svc.sinks], svc.tournament)
        svc.close()
    off, on = runs[False], runs[True]
    np.testing.assert_array_equal(off[0], on[0])
    np.testing.assert_array_equal(off[1], on[1])
    assert all(torch.equal(a, b) for a, b in zip(off[2], on[2]))
    assert off[3] == on[3]
    assert off[4] is None
    assert on[4].ticks_total == 10 and on[4].comparisons_total == 10 * 5 * 2


def test_service_empty_roster_and_roster_override(cfgs):
    import ccka_tpu.harness.service as jsvc
    from ccka_tpu.policy import RulePolicy as JRule

    from ccka_tpu_torch.harness.service import fleet_service_from_config

    cj, ct = cfgs
    svc, reports, _ = _service(ct, RulePolicy(ct.cluster, device="cpu"), 2,
                               tcfg.ObsConfig(enabled=True), ticks=1)
    assert svc.tournament is None
    assert reports[-1].candidate_win_rate == {}
    assert reports[-1].tournament_leader is None
    svc.close()
    k2 = {"obs.tournament_roster": ("rule", "carbon")}
    with pytest.raises(ValueError) as want:
        jsvc.fleet_service_from_config(
            cj.with_overrides(**k2), JRule(cj.cluster), 2,
            service=jcfg.SERVICE_PRESETS["default"],
            obs=jcfg.ObsConfig(enabled=True, tournament_roster=("carbon",)),
            horizon_ticks=16, seed=1)
    with pytest.raises(ValueError) as got:
        fleet_service_from_config(
            ct.with_overrides(**k2), RulePolicy(ct.cluster, device="cpu"), 2,
            service=tcfg.SERVICE_PRESETS["default"],
            obs=tcfg.ObsConfig(enabled=True, tournament_roster=("carbon",)),
            horizon_ticks=16, seed=1, device="cpu")
    assert str(got.value) == str(want.value)
    assert "program-shaping" in str(got.value)


CHALLENGER = {"sim.horizon_steps": 16,
              "obs.tournament_roster": ("carbon",),
              "obs.tournament_window": 8,
              "obs.tournament_sustain_ticks": 4,
              "obs.tournament_win_rate": 0.6}


def test_service_challenger_incident_matches_jax(tmp_path):
    """The seeded scenario on JAX's traces in both packages: exactly one
    edge-triggered challenger_sustained_win, dump-attributable, with a
    signed audit that never auto-switches — the same tick, board leader
    and audit verdict as JAX's service."""
    from test_torch_service import run_pair, service_pair

    from ccka_tpu.obs.tournament import OverProvisionPolicy as JOver
    from ccka_tpu_torch.obs.recorder import verify_dump

    cj = jcfg.default_config().with_overrides(**CHALLENGER)
    ct = tcfg.default_config().with_overrides(**CHALLENGER)
    kw = dict(tournament_roster=("carbon",), tournament_window=8,
              tournament_sustain_ticks=4, tournament_win_rate=0.6)
    paths = {k: tmp_path / k for k in ("jax", "port")}
    js, ts = service_pair(
        "rule", "default", 4, ["healthy", "healthy", "batch", "flaky"],
        service=dict(enabled=True, tick_deadline_ms=250.0,
                     scrape_budget_frac=0.4),
        backends=(JOver(cj.cluster),
                  tour.OverProvisionPolicy(ct.cluster, device="cpu")),
        obs_j=jcfg.ObsConfig(enabled=True, **{
            k: str(paths["jax"] / f) for k, f in (
                ("dump_dir", "dumps"), ("incident_log_path", "i.jsonl"),
                ("tournament_log_path", "t.jsonl"))}, **kw),
        obs_t=_tobs(paths["port"], **kw), configs=(cj, ct))
    (jreps, _), (treps, _) = run_pair(js, ts, 24)
    assert ts.incidents.counts().get("challenger_sustained_win", 0) == 1
    assert ts.tournament.challengers_total == 1
    assert treps[-1].candidate_win_rate["carbon"] >= 0.6
    assert treps[-1].tournament_leader == 0
    inc = [i for i in ts.incidents.incidents
           if i.trigger == "challenger_sustained_win"][0]
    assert verify_dump(inc.dump_path)["t"] == inc.t
    assert inc.details["candidate"] == "carbon"
    assert inc.details["incumbent"] == "overprovision"
    audits = [r for r in tour.read_tournament(ts.obs.tournament_log_path)
              if r.get("kind") == "promotion_audit"]
    assert len(audits) == 1
    assert tour.verify_audit(audits[0], ct.obs.tournament_audit_key)
    assert audits[0]["decision"] == "needs-bench-recheck"
    assert audits[0]["auto_switch"] is False
    jinc = [i for i in js.incidents.incidents
            if i.trigger == "challenger_sustained_win"]
    assert [(i.t, i.details["candidate"]) for i in jinc] == \
        [(inc.t, inc.details["candidate"])]
    assert [r.tournament_leader for r in treps] == \
        [r.tournament_leader for r in jreps]
    js.close()
    ts.close()
