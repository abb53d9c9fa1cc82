"""The port's geo arbitrage against the JAX package on the same inputs.

JAX draws its region lanes from threefry and the port from its own
generators, so the two are held on JAX's lane block fed to both sides
(`regions/process.py::packed_region_lanes`, multiregion, B = 8 x T = 64),
and the lane processes themselves at the level of their distributions.

Standards:
- `region_step_from_block`: bitwise (a slice);
- `geo_rollout`, every policy on spot-storm and capacity-denial, every
  series JAX has (the port adds `rounding_pods`, the queues' float32
  rounding read against a float64 shadow; within 1e-3 pods here): within
  1e-5 of the series' largest magnitude (the JAX scan and
  the port's tick loop add the same float32 terms in another order; the
  policies feed the queues back into the rates, so a rounding step can
  grow over the horizon; measured worst 6.1e-6 of the magnitude, on
  balanced's `served` in spot-storm);
- `rollout_summary`, `class_points`: 1e-6 relative; `pareto_front` and
  the ``dominates`` relations equal;
- each policy's sanitized rates on one `RegionSignals`: 1e-6 absolute;
- the migration command streams: equal, command for command;
- the lane processes, against JAX's on fixed seeds: the storm-window
  share and the batch-mean arrivals by time of day, each within five
  standard errors of the difference of the two sample means (the error
  measured from the samples themselves).

The port alone: neutral lanes exactly 0; zones of one region bitwise
equal and padding 0; a widened stream's pre-geo rows, the plain rollouts
of the four policies and one streaming drive bitwise the un-widened
stream's; ``none`` bitwise a zero override with a migration term of
exactly 0.0; work conserved within 1e-3 pods, through a thinned command
stream and over a day too; the ledger's migration term; the service's
geo gauges.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
from ccka_tpu.regions import geo as jgeo
from ccka_tpu.regions import migrate as jmig
from ccka_tpu.regions import pareto as jpareto
from ccka_tpu.regions import packed_region_lanes as jpacked_region_lanes
from ccka_tpu.regions import region_step_from_block as jstep_from_block
from ccka_tpu_torch import PRESETS
from ccka_tpu_torch.config import (ChaosConfig, GeoConfig, ObsConfig,
                                   ServiceConfig)
from ccka_tpu_torch.regions import geo as tgeo
from ccka_tpu_torch.regions import migrate, pareto
from ccka_tpu_torch.regions.process import (REGION_LANE_FIELDS,
                                            has_region_lanes,
                                            packed_region_lanes,
                                            region_rows,
                                            region_step_from_block,
                                            sample_region_steps,
                                            unpack_region_lanes)
from ccka_tpu_torch.signals.synthetic import (SyntheticSignalSource,
                                              family_generator)
from ccka_tpu_torch.sim import lanes

B, T, Z, DT = 8, 64, 4, 30.0
SERIES_TOL = 1e-5
SCENARIOS = ("spot-storm", "capacity-denial")


@pytest.fixture(autouse=True)
def no_published_snapshot(monkeypatch):
    """Each test starts with no geo snapshot in either package and leaves
    none behind (other files hold the service's skip values)."""
    monkeypatch.setattr(tgeo, "_GEO_SNAPSHOT", None)
    monkeypatch.setattr(jgeo, "_GEO_SNAPSHOT", None)


@pytest.fixture(scope="module")
def cfg():
    return PRESETS["multiregion"]()


def _geo(cfg, name: str, package=pareto) -> GeoConfig:
    return dataclasses.replace(package.GEO_SCENARIOS[name].geo,
                               zone_region_index=cfg.cluster
                               .zone_region_index)


@pytest.fixture(scope="module")
def pair(cfg):
    """{scenario: (jgeo config, port geo config, JAX block as numpy)}."""
    out = {}
    for i, name in enumerate(SCENARIOS):
        jg = _geo(cfg, name, jpareto)
        block = jpacked_region_lanes(jg, jax.random.key(3 + i), T, T, Z, B,
                                     dt_s=DT)
        out[name] = (jg, _geo(cfg, name), np.array(block))
    return out


@pytest.fixture(scope="module")
def rollouts(pair):
    """{(scenario, policy): (JAX rollout as numpy, port rollout)} on JAX's
    block, and the two steps per scenario."""
    out, steps = {}, {}
    for name, (jg, tg, block) in pair.items():
        js = jstep_from_block(jnp.asarray(block), T, Z, jg)
        ts = region_step_from_block(torch.from_numpy(block), T, Z, tg)
        steps[name] = (js, ts)
        for p in migrate.GEO_POLICIES:
            jr = jgeo.geo_rollout(jg, jmig.GEO_POLICIES[p], js)
            out[name, p] = (type(jr)(*(np.asarray(x) for x in jr)),
                            tgeo.geo_rollout(tg, migrate.GEO_POLICIES[p],
                                             ts))
    return out, steps


# ---- against JAX on JAX's lane block


def test_region_step_from_block_is_jax_s(pair):
    for name, (jg, tg, block) in pair.items():
        js = jstep_from_block(jnp.asarray(block), T, Z, jg)
        ts = region_step_from_block(torch.from_numpy(block), T, Z, tg)
        assert ts._fields == REGION_LANE_FIELDS == js._fields
        for f in ts._fields:
            assert np.array_equal(getattr(ts, f).numpy(),
                                  np.asarray(getattr(js, f))), (name, f)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("policy", sorted(migrate.GEO_POLICIES))
def test_geo_rollout_series_match_jax(rollouts, scenario, policy):
    (jr, tr), = [rollouts[0][scenario, policy]]
    assert tr._fields == jr._fields + ("rounding_pods",)
    assert float(tr.rounding_pods.abs().max()) < 1e-3
    for f in jr._fields:
        want = np.asarray(getattr(jr, f), np.float64)
        got = getattr(tr, f).double().numpy()
        assert got.shape == want.shape, f
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= SERIES_TOL * scale, (f, err, scale)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_raw_residual_is_jax_s_formula(rollouts, scenario):
    """``ledger=False`` is the JAX package's residual, read on the port's
    series (float64 sums in another order: 1e-9 pods); the ledger's
    residual differs from it by the last tick's ``rounding_pods``."""
    js, ts = rollouts[1][scenario]
    for p in migrate.GEO_POLICIES:
        tr = rollouts[0][scenario, p][1]
        as_jax = jgeo.GeoRollout(*(x.numpy() for x in tr[:-1]))
        raw = tgeo.conservation_residual(ts, tr, ledger=False)
        assert abs(raw - jgeo.conservation_residual(js, as_jax)) <= 1e-9
        assert abs(raw - tgeo.conservation_residual(ts, tr)) <= \
            float(tr.rounding_pods[-1].abs().max()) + 1e-9, p


def test_summaries_points_and_fronts_match_jax(rollouts, pair):
    for name, (jg, tg, _block) in pair.items():
        jsum, tsum = {}, {}
        for p in migrate.GEO_POLICIES:
            jr, tr = rollouts[0][name, p]
            jsum[p] = jgeo.rollout_summary(jg, jr)
            tsum[p] = tgeo.rollout_summary(tg, tr)
            assert tgeo.conservation_residual(rollouts[1][name][1],
                                              tr) < 1e-4
        _close(tsum, jsum, 1e-6)
        for klass in pareto._CLASS_SLO:
            jp = jpareto.class_points(jsum, klass)
            tp = pareto.class_points(tsum, klass)
            _close(tp, jp, 1e-6)
            assert pareto.pareto_front(tp) == jpareto.pareto_front(jp)
            for a in tp:
                for b in tp:
                    assert pareto.dominates(tp[a], tp[b]) == \
                        jpareto.dominates(jp[a], jp[b]), (name, klass, a, b)
        tf = pareto.fronts(tsum)
        for klass, fr in tf.items():
            jp = jpareto.class_points(jsum, klass)
            assert fr["dominates_none"] == sorted(
                n for n, p in jp.items()
                if n != "none" and jpareto.dominates(p, jp["none"]))


def _close(got, want, rtol: float) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
    else:
        assert got == pytest.approx(float(want), rel=rtol, abs=1e-9)


SIG = dict(price_dev=[1.2, 0.0], carbon_dev=[180.0, -40.0],
           capacity=[8.0, 10.0], queues=[[5.0, 4.0, 3.0], [1.0, 2.0, 0.5]])


def _signals(package, asarray):
    return package.RegionSignals(**{k: asarray(np.asarray(v, np.float32))
                                    for k, v in SIG.items()})


@pytest.mark.parametrize("policy", sorted(migrate.GEO_POLICIES))
def test_policy_rates_match_jax(policy):
    want = np.asarray(jmig.GEO_POLICIES[policy].rates(
        _signals(jmig, jnp.asarray)))
    got = migrate.GEO_POLICIES[policy].rates(
        _signals(migrate, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    raw = np.random.default_rng(0).uniform(-0.5, 2.5, (3, 3, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        migrate.sanitize_rates(torch.from_numpy(raw)).numpy(),
        np.asarray(jmig.sanitize_rates(jnp.asarray(raw))), rtol=0,
        atol=1e-7)


def _wire(cmds):
    return [(c.resource, c.name, c.patch_type, c.patch) for c in cmds]


def test_command_wire_matches_jax_and_round_trips():
    rates = np.asarray(jmig.GEO_POLICIES["balanced"].rates(
        _signals(jmig, jnp.asarray)))
    jcmds = jmig.render_migration_commands(rates)
    tcmds = migrate.render_migration_commands(
        torch.from_numpy(np.array(rates)))
    assert jcmds and _wire(tcmds) == _wire(jcmds)
    back = migrate.apply_migration_commands(tcmds, 2)
    assert np.array_equal(back.numpy(), np.asarray(
        jmig.apply_migration_commands(jcmds, 2)))
    np.testing.assert_allclose(back.numpy(), rates, rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match=r"\[R, R, 3\]"):
        migrate.render_migration_commands(np.zeros((2, 3, 3)))


# ---- the lane processes: distributions against JAX on fixed seeds


N_SEEDS = 32


def _lane_samples(cfg, geo_over: dict, dt_s: float):
    """JAX's and the port's blocks over N_SEEDS seeds, B x T each, as
    numpy [S, T, rows, B]."""
    jg = dataclasses.replace(jcfg.GeoConfig(**geo_over),
                             zone_region_index=cfg.cluster.zone_region_index)
    tg = dataclasses.replace(GeoConfig(**geo_over),
                             zone_region_index=cfg.cluster.zone_region_index)
    jfn = jax.jit(lambda k: jpacked_region_lanes(jg, k, T, T, Z, B,
                                                 dt_s=dt_s))
    j = np.stack([np.asarray(jfn(jax.random.key(s)))
                  for s in range(N_SEEDS)])
    t = np.stack([packed_region_lanes(
        tg, family_generator(s, lanes.REGION_KEY_TAG, "cpu"), T, T, Z, B,
        dt_s=dt_s).numpy() for s in range(N_SEEDS)])
    return j, t


def _within_five_se(a: np.ndarray, b: np.ndarray, axis=0) -> None:
    """The two sample means along ``axis`` within five standard errors of
    their difference."""
    se = np.sqrt(a.var(axis=axis, ddof=1) / a.shape[axis]
                 + b.var(axis=axis, ddof=1) / b.shape[axis])
    gap = np.abs(a.mean(axis=axis) - b.mean(axis=axis))
    assert np.all(gap <= 5 * se + 1e-12), (gap.max(), se.max())


def test_storm_window_share_matches_jax(cfg):
    """A storm-only price lane is 0 or mult - 1: its share of ticks in a
    window, one sample per (seed, cluster, region) trace."""
    j, t = _lane_samples(cfg, dict(enabled=True, price_storm_frac=0.15,
                                   price_storm_mult=4.0,
                                   price_storm_mean_ticks=8), DT)
    slots = [0, 2]                                  # a zone per region
    for x in (j, t):
        assert set(np.unique(x[:, :, slots])) <= {0.0, 3.0}
    share = [(x[:, :, slots] > 0).mean(axis=1).reshape(-1) for x in (j, t)]
    assert 0.05 < share[1].mean() < 0.3
    _within_five_se(*share)


def test_batch_arrivals_by_time_of_day_match_jax(cfg):
    """T = 64 ticks of 1350 s span a day: the batch-mean migratable batch
    arrivals per tick (anti-diurnal), one sample per trace."""
    j, t = _lane_samples(cfg, dict(enabled=True, migratable_batch_pods=4.0),
                         86400.0 / T)
    row = 4 * Z                                     # batch, zone 0
    a = j[:, :, row].transpose(0, 2, 1).reshape(-1, T)
    b = t[:, :, row].transpose(0, 2, 1).reshape(-1, T)
    _within_five_se(a, b)
    tod = np.arange(T) / T
    noon = np.abs(tod - 14 / 24) < 0.05
    night = np.abs(tod - 2 / 24) < 0.05
    assert b.mean(axis=0)[noon].mean() < b.mean(axis=0)[night].mean()


# ---- the port on its own


def test_neutral_lanes_are_exactly_zero(cfg):
    block = packed_region_lanes(
        GeoConfig(zone_region_index=cfg.cluster.zone_region_index),
        family_generator(0, lanes.REGION_KEY_TAG, "cpu"), 16, 24, Z, 2,
        dt_s=DT)
    assert block.shape == (24, region_rows(Z), 2) == (24, 64, 2)
    assert float(block.abs().max()) == 0.0


def test_zones_of_a_region_equal_and_padding_zero(cfg):
    geo = _geo(cfg, "spot-storm")
    block = packed_region_lanes(
        geo, family_generator(1, lanes.REGION_KEY_TAG, "cpu"), 16, 24, Z, 4,
        dt_s=DT)
    zri = cfg.cluster.zone_region_index
    for i in range(len(REGION_LANE_FIELDS)):
        rows = block[:16, i * Z:(i + 1) * Z]
        for z in range(Z):
            first = zri.index(zri[z])
            assert torch.equal(rows[:, z], rows[:, first])
    assert float(block[:16, 6 * Z:].abs().max()) == 0.0
    assert float(block[16:].abs().max()) == 0.0
    assert float(block[:16, :6 * Z].abs().max()) > 0.0
    one = sample_region_steps(geo, family_generator(1, lanes.REGION_KEY_TAG,
                                                    "cpu"), 16, Z)
    assert one.price_dev.shape == (16, 2)


def _sources(cfg, geo, **kw):
    mk = lambda **extra: SyntheticSignalSource(  # noqa: E731
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals, **kw, **extra)
    return mk(), mk(extra_lanes={"regions": geo})


def test_extra_lanes_refuses_built_in_and_unknown_families(cfg):
    for name in ("faults", "no-such-family"):
        with pytest.raises(ValueError, match="built-in|unknown lane"):
            SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                  cfg.signals, extra_lanes={name: 1.0})


def test_every_subset_of_families_has_its_own_row_count():
    for z in lanes._AMBIGUITY_ZS:
        totals = lanes._subset_sums(z)
        assert len(totals) == 2 ** len(lanes.LANE_FAMILIES)
        for rows, names in totals.items():
            assert lanes.resolve_layout(rows, z).families == names


def test_the_region_generator_is_supplied_through_the_hook():
    from ccka_tpu_torch.regions import process

    assert lanes.lane_generator("regions") is process._generate
    with pytest.raises(ValueError, match="already has a generator"):
        lanes.provide_lane_generator("regions", lambda *a, **k: None)
    for name in ("faults", "nope"):
        with pytest.raises(ValueError, match="takes no generator"):
            lanes.lane_generator(name)


def test_widened_streams_keep_the_pre_geo_rows(cfg):
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    geo = _geo(cfg, "spot-storm")
    mixed = WORKLOAD_SCENARIOS["mixed"].workloads
    for kw, rows in (({}, 16),
                     (dict(faults=_mild_faults(), workloads=mixed), 40)):
        plain, wide = _sources(cfg, geo, **kw)
        assert (plain.packed_rows(), wide.packed_rows()) == (rows, rows + 64)
        a = plain.packed_trace_device(12, 5, 3, t_pad=16, device="cpu")
        b = wide.packed_trace_device(12, 5, 3, t_pad=16, device="cpu")
        assert b.shape == (16, rows + 64, 3) and has_region_lanes(b, Z)
        assert torch.equal(a, b[:, :rows])
        assert torch.equal(unpack_region_lanes(b, 12, Z, geo).price_dev,
                           b[:12, rows:rows + Z][:, [0, 2]])
        for j in range(2):
            pa = plain.packed_block_trace_device(8, 5, 3, j, t_chunk=8,
                                                 device="cpu")
            pb = wide.packed_block_trace_device(8, 5, 3, j, t_chunk=8,
                                                device="cpu")
            assert torch.equal(pa, pb[:, :rows])
            assert float(pb[:, rows:rows + 6 * Z].abs().max()) > 0.0


def _mild_faults():
    from ccka_tpu_torch.config import FAULT_PRESETS
    return FAULT_PRESETS["mild"]


def test_plain_rollouts_on_the_widened_stream_are_bitwise(cfg):
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    plain, wide = _sources(cfg, _geo(cfg, "spot-storm"))
    a = plain.packed_trace_device(24, 7, 4, device="cpu")
    b = wide.packed_trace_device(24, 7, 4, device="cpu")
    params = SimParams.from_config(cfg, device="cpu")
    net = load_flagship_backend(cfg, device="cpu")[0].params
    for mode in ("rule", "carbon", "neural", "plan"):
        x, y = (mk.packed_mode_summary(params, cfg.cluster, mode, s, 24,
                                       seed=5, stochastic=True,
                                       net_params=net) for s in (a, b))
        assert all(torch.equal(u, v) for u, v in zip(x, y)), mode


def test_streaming_drive_on_the_widened_stream_is_bitwise(cfg):
    from ccka_tpu_torch.sim.streaming import streaming_rollout_summary
    from ccka_tpu_torch.sim.types import SimParams

    plain, wide = _sources(cfg, _geo(cfg, "capacity-denial"))
    params = SimParams.from_config(cfg, device="cpu")
    kw = dict(key=13, batch=4, T=32, block_T=16, t_chunk=16, seed=5,
              stochastic=True, device="cpu")
    x, _ = streaming_rollout_summary(plain, params, cfg.cluster, "rule", **kw)
    y, rep = streaming_rollout_summary(wide, params, cfg.cluster, "rule",
                                       **kw)
    assert all(torch.equal(u, v) for u, v in zip(x, y))


def test_none_is_bitwise_a_zero_override(rollouts, pair):
    for name, (_jg, tg, _block) in pair.items():
        ts = rollouts[1][name][1]
        none = rollouts[0][name, "none"][1]
        zero = tgeo.geo_rollout(tg, None, ts,
                                rates_override=torch.zeros(2, 2, 3))
        assert len(none) == len(zero) == 10
        assert all(torch.equal(u, v) for u, v in zip(none, zero))
        assert float(none.migration_cost_usd.abs().max()) == 0.0
        assert float(none.moved_pods.abs().max()) == 0.0


def test_work_is_conserved_over_every_scenario_and_policy(cfg):
    for i, name in enumerate(sorted(pareto.GEO_SCENARIOS)):
        geo = _geo(cfg, name)
        step = region_step_from_block(packed_region_lanes(
            geo, family_generator(i, lanes.REGION_KEY_TAG, "cpu"), 48, 48, Z,
            4, dt_s=DT), 48, Z, geo)
        for p, pol in migrate.GEO_POLICIES.items():
            res = tgeo.conservation_residual(step,
                                             tgeo.geo_rollout(geo, pol, step))
            assert res < 1e-3, (name, p, res)


def test_a_day_is_conserved_and_follows_jax(cfg):
    """A day (T = 2880) of spot-storm at B = 4, one lane block fed to
    both packages, where the
    balanced policy moves thousands of pods a tick: the port's queues
    round as JAX's do (the day's summary within 1e-6 of JAX's), and the
    rounding ledger keeps the residual within 1e-3 pods, where the float32
    queues alone drift toward the 0.01-pod gate (JAX's residual, which
    counts no rounding, is that drift)."""
    jg, tg = _geo(cfg, "spot-storm", jpareto), _geo(cfg, "spot-storm")
    block = packed_region_lanes(
        tg, family_generator(7, lanes.REGION_KEY_TAG, "cpu"), 2880, 2880, Z,
        4, dt_s=DT).numpy()
    js = jstep_from_block(jnp.asarray(block), 2880, Z, jg)
    ts = region_step_from_block(torch.from_numpy(block), 2880, Z, tg)
    jr = jgeo.geo_rollout(jg, jmig.GEO_POLICIES["balanced"], js)
    tr = tgeo.geo_rollout(tg, migrate.GEO_POLICIES["balanced"], ts)
    _close(tgeo.rollout_summary(tg, tr), jgeo.rollout_summary(jg, jr), 1e-6)
    assert float(tr.moved_pods.max()) > 1000.0
    assert tgeo.conservation_residual(ts, tr) < 1e-3


def test_work_is_conserved_through_a_thinned_command_stream(rollouts, pair):
    from ccka_tpu_torch.actuation.chaos import ChaosSink
    from ccka_tpu_torch.actuation.sink import DryRunSink

    tg, step = pair["spot-storm"][1], rollouts[1]["spot-storm"][1]
    rates = migrate.GEO_POLICIES["balanced"].rates(
        _signals(migrate, torch.from_numpy))
    cmds = migrate.render_migration_commands(rates)
    dry = DryRunSink()
    chaos = ChaosSink(dry, ChaosConfig(enabled=True, drop_prob=0.4,
                                       rewrite_prob=0.2), seed=7)
    for cmd in cmds:
        chaos._patch(cmd)
    landed = [c for c in dry.commands
              if getattr(c, "name", "").startswith("geo-mig-")]
    assert 0 < len(landed) < len(cmds)
    out = tgeo.geo_rollout(tg, None, step,
                           rates_override=migrate.apply_migration_commands(
                               landed, 2))
    assert tgeo.conservation_residual(step, out) < 1e-3
    assert float(out.moved_pods.sum()) > 0.0


def test_ledger_carries_the_migration_term(rollouts, cfg):
    """`bench.py`'s geo ledger arm: eight geo ticks of one cluster into a
    DecisionLedger; the migration term present, shares summing to 1."""
    from ccka_tpu_torch.obs.decisions import DecisionLedger

    roll = rollouts[0]["spot-storm", "balanced"][1]
    ledger = DecisionLedger(ObsConfig(enabled=True, decisions_enabled=True),
                            cfg.train, policy="geo-balanced")
    act = np.zeros(4)
    for t in range(8):
        mig = float(roll.migration_cost_usd[t, 0])
        base = dict(cost_usd=float(roll.cost_usd[t, 0]),
                    carbon_g=float(roll.carbon_g[t, 0]),
                    pend_c0=float(roll.pending[t, 0, :, 0].sum()),
                    pend_c1=float(roll.pending[t, 0, :, 1].sum()),
                    slo_ok=1.0)
        ledger.observe_single(t, lane="fresh", action=act, exo={}, state={},
                              chosen=dict(base, migration_cost_usd=mig),
                              shadow=base, shadow_action=act,
                              migration_components={"total": mig})
    assert len(ledger.rows) == 8
    shares = [r["objective"]["shares"] for r in ledger.rows]
    assert all("migration" in r["objective"]["terms"] for r in ledger.rows)
    assert max(abs(sum(s.values()) - 1.0) for s in shares) <= 1e-12
    assert max(s["migration"] for s in shares) > 0.0


def test_service_geo_gauges_read_the_published_snapshot(rollouts, pair,
                                                        cfg):
    from ccka_tpu_torch.harness.promexport import render_exposition
    from ccka_tpu_torch.harness.service import fleet_service_from_config
    from ccka_tpu_torch.policy.rule import RulePolicy

    svc = fleet_service_from_config(
        cfg, RulePolicy(cfg.cluster, "cpu"), 2,
        service=ServiceConfig(enabled=True), obs=ObsConfig(enabled=True),
        horizon_ticks=8, device="cpu",
        log_fn=lambda *a: None)
    try:
        before = svc.tick(0)
        assert before.region_migration_rate == {} == \
            before.region_carbon_intensity
        text = render_exposition(dataclasses.asdict(before))
        assert "ccka_region_migration_rate" not in text
        jg, tg, _block = pair["spot-storm"]
        js, ts = rollouts[1]["spot-storm"]
        jr = jgeo.geo_rollout(jg, jmig.GEO_POLICIES["balanced"], js)
        want = jgeo.publish_geo_snapshot(jg, js, jr)
        got = tgeo.publish_geo_snapshot(
            tg, ts, rollouts[0]["spot-storm", "balanced"][1])
        _close(got, want, 1e-5)
        after = svc.tick(1)
        assert after.region_migration_rate == got["migration_rate"]
        assert after.region_carbon_intensity == got["carbon_intensity"]
        text = render_exposition(dataclasses.asdict(after))
        for series in ("ccka_region_migration_rate",
                       "ccka_region_carbon_intensity"):
            assert f"\n{series} " in text, series
    finally:
        svc.close()


def test_suite_record_and_unknown_names(cfg):
    suite = pareto.run_geo_suite(
        scenarios=["spot-storm"], policies=["carbon-first"],
        zone_region_index=cfg.cluster.zone_region_index, seed=0, steps=24,
        batch=2, dt_s=DT, device="cpu")
    assert suite["policies"] == ["carbon-first", "none"]
    assert suite["classes"] == sorted(pareto._CLASS_SLO)
    assert suite["device"] == "cpu"
    (scn,) = suite["scenarios"]
    for klass in suite["classes"]:
        fr = scn["pareto"][klass]
        assert set(fr["points"]) == {"none", "carbon-first"} and fr["front"]
    assert suite["max_conservation_residual"] < 1e-3
    assert suite["max_conservation_residual_raw"] < 1e-3
    assert set(scn["conservation_residual_raw"]) == \
        set(scn["conservation_residual"])
    assert tgeo.geo_snapshot() is not None
    # Lanes drawn beforehand on the suite's device score as its own draw.
    kw = dict(scenarios=["spot-storm"],
              zone_region_index=cfg.cluster.zone_region_index, seed=0,
              steps=24, batch=2, dt_s=DT, device="cpu")
    drawn = pareto.scenario_lanes(**kw)
    assert pareto.run_geo_suite(policies=["carbon-first"], lanes=drawn,
                                **kw) == suite
    for bad, what in ((dict(scenarios=["nope"]), "unknown geo scenarios"),
                      (dict(policies=["teleport"]), "unknown geo policies"),
                      (dict(policies=[]), "no geo policies")):
        kw = dict(dict(scenarios=["calm"], policies=["none"]), **bad)
        with pytest.raises(ValueError, match=what):
            pareto.run_geo_suite(
                zone_region_index=cfg.cluster.zone_region_index,
                device="cpu", **kw)
