"""The port's scenario axis and adversarial search against the JAX package.

Standards:
- `search/params.py`: the config round trips exact, and the canonical
  JSON, the digest and `derived()` equal to JAX's on the same cells (the
  port's ``*_rho64`` additions rounding to JAX's ``*_rho``); the bounds
  refusals JAX's, message for message;
- the three ``*_lanes_p`` transforms, fed the unit normals JAX draws from
  its own keys, within 1e-6 of JAX's vmapped ``packed_*_lanes_p`` blocks
  at Z = 3 (one region) and Z = 4 (two): relative, and absolute against
  each row's largest magnitude. JAX scans by `associative_scan`, the
  port by doubling, so their latents round in another order, and the
  region sigmas (30 g/kWh here) scale that rounding;
- the port's axis against the port's own config-baked source: an S = 1
  stream, packed and blocked, bitwise the baked stream of the same cell
  and seed at random points of the box, the hand-named scenarios' cells
  and both presets; each cell of an S = 4 stream bitwise its own baked
  stream too (each cell's operations are the baked ones, elementwise);
  the S = 1 summary, whole and streamed in blocks, bitwise the baked
  stream's (plain version);
- JAX's S-axis stream at the JAX scorer's CPU geometry through the port's
  plain `packed_mode_summary`: every field within 2e-3 relative per
  cluster of JAX's scorer summary (`tests/test_megakernel.py:100-109`);
- the CEM loop of both packages driven by one stub scorer: the same
  history, best params, digest, name and minted document;
- the minted codec across the packages, its refusals, and
  `replay_minted` reproducing the recorded value exactly;
- every rejection before any stream is made; the mode registry's
  vocabulary JAX's.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.search.adversarial as jadv
import ccka_tpu.search.params as jparams
import ccka_tpu.sim.lanes as jlanes
import ccka_tpu.workloads.scenarios as jscen
from ccka_tpu.faults.process import packed_fault_lanes_p as jfault_p
from ccka_tpu.regions.process import packed_region_lanes_p as jregion_p
from ccka_tpu.signals.synthetic import _ar1_device as jar1
from ccka_tpu.workloads.process import packed_workload_lanes_p as jwl_p
from ccka_tpu_torch import PRESETS
from ccka_tpu_torch import config as tcfg
from ccka_tpu_torch.faults.process import fault_lanes_p
from ccka_tpu_torch.regions.process import region_lanes_p
from ccka_tpu_torch.search import adversarial as adv
from ccka_tpu_torch.search import params as tparams
from ccka_tpu_torch.search.axis import ScenarioAxisSource, summary_cells
from ccka_tpu_torch.search.params import (PARAM_NAMES, SEARCH_BOUNDS,
                                          ScenarioParams, validate_bounds)
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim import streaming as stm
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.workloads import scenarios as tscen
from ccka_tpu_torch.workloads.process import workload_lanes_p

T, T_PAD, B, S = 48, 64, 8, 3
FIELD_TOL = 2e-3     # tests/test_megakernel.py:100-109


def _box_cells(n: int, seed: int) -> jparams.ScenarioParams:
    """``n`` cells uniform in the middle of the box (every mechanism
    live), as JAX's ScenarioParams."""
    rng = np.random.default_rng(seed)
    lo = np.asarray([SEARCH_BOUNDS[k][0] for k in PARAM_NAMES])
    hi = np.asarray([SEARCH_BOUNDS[k][1] for k in PARAM_NAMES])
    nat = lo + (0.2 + 0.6 * rng.uniform(size=(n, len(PARAM_NAMES)))) * (
        hi - lo)
    return jparams.ScenarioParams.from_array(nat).clip_to_bounds()


def _twin(p) -> ScenarioParams:
    return ScenarioParams.from_array(p.to_array())


# ---- params


@pytest.mark.parametrize("seed", [3, 9])
def test_params_digest_and_derived_equal_jax(seed):
    jp = _box_cells(4, seed)
    tp = _twin(jp)
    assert tp.to_json() == jp.to_json()
    assert tp.digest() == jp.digest() and tp.digest(2) == jp.digest(2)
    assert jparams.params_digest(tp.to_json()) == tp.digest()
    jd, td = jp.derived(), tp.derived()
    assert set(jd) == set(td)
    for fam in jd:
        extra = set(td[fam]) - set(jd[fam])
        assert extra == {k for k in td[fam] if k.endswith("_rho64")}
        for k, v in jd[fam].items():
            assert td[fam][k].dtype == v.dtype == np.float32
            assert np.array_equal(td[fam][k], v), (fam, k)
        for k in extra:
            assert np.array_equal(td[fam][k].astype(np.float32),
                                  jd[fam][k[:-2]])


def test_params_round_trips_clip_and_bounds_refusals():
    faults = tcfg.FAULT_PRESETS["severe"]
    wl = tscen.WORKLOAD_SCENARIOS["flash-crowd"].workloads
    geo = tcfg.GeoConfig(enabled=True, price_storm_frac=0.1)
    p = ScenarioParams.from_config(faults=faults, workloads=wl, geo=geo)
    back = p.to_config(0, base_faults=faults, base_workloads=wl,
                       base_geo=geo)
    assert back == (faults, wl, geo)
    cells = _twin(_box_cells(3, 5))
    assert ScenarioParams.from_json(cells.to_json()).to_json() \
        == cells.to_json()
    assert ScenarioParams.stack([cells.row(i) for i in range(3)]).to_json() \
        == cells.to_json()
    wild = ScenarioParams.from_array(cells.to_array() * 3.7 - 1.3)
    once = wild.clip_to_bounds()
    assert once.clip_to_bounds().to_json() == once.to_json()
    for p_ in (once.to_array(),):
        lo = np.asarray([SEARCH_BOUNDS[k][0] for k in PARAM_NAMES])
        hi = np.asarray([SEARCH_BOUNDS[k][1] for k in PARAM_NAMES])
        assert (p_ >= lo).all() and (p_ <= hi).all()
    for bad in ({"bogus": (0, 1)}, {"storm_hazard": (2.0, 1.0)},
                {"storm_frac": (0.0, 0.9)}):
        with pytest.raises(ValueError) as te:
            validate_bounds(bad)
        with pytest.raises(ValueError) as je:
            jparams.validate_bounds(bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="exactly the searchable knobs"):
        ScenarioParams({"storm_hazard": np.zeros(1)})


# ---- the three lane transforms, fed JAX's draws


def _jnormals(key, shape):
    k0, k1 = jax.random.split(key)
    return (jax.random.normal(k0, (1,) + shape[1:], jnp.float32),
            jax.random.normal(k1, shape, jnp.float32))


def _torch_pairs(pairs):
    return tuple(tuple(torch.from_numpy(np.array(x)) for x in pr)
                 for pr in pairs)


def _assert_block(got: torch.Tensor, want) -> float:
    """The port's [T_pad, rows, S, B] block against JAX's
    [S, T_pad, rows, B]: within 1e-6 relative, and absolute within 1e-6
    of each row's largest magnitude. Returns the worst difference in
    those units."""
    a = got.permute(2, 0, 1, 3).numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(b).max(axis=(0, 1, 3), keepdims=True), 1.0)
    err = np.abs(a - b) / (1e-6 * (np.abs(b) + scale))
    assert err.max() <= 1.0, (float(err.max()), np.unravel_index(
        err.argmax(), err.shape))
    return float(err.max()) * 1e-6


GEO_LIVE = dict(price_dev_sigma=0.05, carbon_dev_sigma_g_kwh=30.0,
                capacity_pods=40.0, capacity_deny_window_frac=0.1,
                capacity_deny_frac=0.7, migratable_inference_pods=3.0,
                migratable_batch_pods=2.0, migratable_background_pods=1.0)


@pytest.fixture(scope="module")
def jscorer():
    """One JAX scorer for the module (its first score compiles for about
    ten seconds): the default preset at its CPU geometry (96 ticks, inner
    4, deterministic), its geo section live beyond the storm."""
    return jadv.ScenarioScorer(
        jcfg.default_config(), policy="rule", seed=5,
        base_geo=jcfg.GeoConfig(enabled=True, **GEO_LIVE))


@pytest.fixture(scope="module")
def jstream(jscorer):
    """(cells, JAX's S-cell stream, JAX's summary of it) at the scorer's
    geometry."""
    jp = _box_cells(S, 29)
    jscorer.source.set_params(jp)
    stream = jscorer.source.packed_trace_device(
        jscorer.steps, jscorer.key, S * jscorer.inner,
        t_chunk=jscorer.t_chunk)
    return jp, stream, jscorer.mode_fn(stream, jscorer.seed)


def _jax_draws(key, T_: int, Z: int, B_: int, R: int):
    """JAX's draws for each family from its keys (``split(fold_in(key,
    TAG), n)``, then ``split`` per latent; eager, so each shape compiles
    once), and the spot noise the faults couple to."""
    ks, _, _ = jax.random.split(key, 3)
    price_dev = jax.jit(lambda k: jar1(k, (T_, Z, B_), rho=0.97, sigma=0.04,
                                       axis=0))(ks)

    def keys(name: str, n: int):
        return jax.random.split(jax.random.fold_in(
            key, jlanes.LANE_FAMILIES[name].key_tag), n)

    rk = keys("regions", 8)              # kp ks kc kcap kd ki kb kg
    return (torch.from_numpy(np.array(price_dev)),
            *(_torch_pairs(d) for d in (
                [_jnormals(k, (T_, B_)) for k in keys("faults", 4)],
                [_jnormals(k, (T_, B_)) for k in keys("workloads", 5)],
                [_jnormals(rk[i], (T_, R, B_))
                 for i in (0, 1, 2, 4, 5, 6, 7)])))


@pytest.mark.parametrize("preset", ["default", "multiregion"])
def test_lane_transforms_from_jax_draws(preset, request):
    """Each family's ``*_lanes_p`` fed the unit normals JAX draws gives
    JAX's ``packed_*_lanes_p`` blocks over S cells, at Z = 3 (the default
    preset, one region: the blocks of JAX's scorer stream, its families
    vmapped by `ccka_tpu/search/axis.py`) and Z = 4 (multiregion, two
    regions, per-trace clock offsets: JAX's cores vmapped here)."""
    jc = jcfg.PRESETS[preset]()
    Z = jc.cluster.n_zones
    jgeo = jcfg.GeoConfig(enabled=True, **GEO_LIVE).bound_to(jc.cluster)
    tgeo = tcfg.GeoConfig(**{f.name: getattr(jgeo, f.name)
                             for f in dataclasses.fields(jgeo)})
    R = tgeo.n_regions
    assert R == (1 if preset == "default" else 2)
    if preset == "default":
        jscorer = request.getfixturevalue("jscorer")
        jp, stream, _ = request.getfixturevalue("jstream")
        key, T_, T_pad, B_ = (jscorer.key, jscorer.steps, jscorer.steps,
                              jscorer.inner)
        clock = dict(dt_s=30.0, start_unix_s=0.0, start_offset_s=None)
        x = np.asarray(stream).reshape(T_pad, -1, S, B_).transpose(
            2, 0, 1, 3)                             # [S, T_pad, rows, B]
        lo = [jlanes.exo_rows(Z)]
        for fam in ("faults", "workloads", "regions"):
            lo.append(lo[-1] + jlanes.LANE_FAMILIES[fam].rows(Z))
        want = [x[:, :, a:b] for a, b in zip(lo, lo[1:])]
        price_dev, fdraws, wdraws, rdraws = _jax_draws(key, T_, Z, B_, R)
    else:
        jp = _box_cells(S, 11)
        key, T_, T_pad, B_ = jax.random.key(4), T, T_PAD, B
        clock = dict(dt_s=30.0, start_unix_s=3600.0,
                     start_offset_s=np.arange(B, dtype=np.float32) * 997.0)
        price_dev, fdraws, wdraws, rdraws = _jax_draws(key, T_, Z, B_, R)
        jpd = jnp.asarray(price_dev.numpy())
        jd = {fam: {k: jnp.asarray(v) for k, v in d.items()}
              for fam, d in jp.derived().items()}
        cores = (
            ("faults", lambda d: jfault_p(None, d, key, T, T_PAD, Z, B,
                                          price_dev=jpd)),
            ("workloads", lambda d: jwl_p(None, d, key, T, T_PAD, Z, B,
                                          **clock)),
            ("regions", lambda d: jregion_p(jgeo, d, key, T, T_PAD, Z, B,
                                            **clock)))
        # JAX's cores over the S cells, vmapped with the key closed over,
        # compiled side by side.
        with ThreadPoolExecutor(len(cores)) as pool:
            want = list(pool.map(lambda c: np.asarray(
                jax.jit(jax.vmap(c[1]))(jd[c[0]])), cores))
    td = _twin(jp).derived()
    got = fault_lanes_p(td["faults"], fdraws, T_, T_pad, Z,
                        price_dev=price_dev)
    worst = {"faults": _assert_block(got, want[0])}
    assert float(got[:T_, Z + 2].max()) == 1.0       # outages present
    worst["workloads"] = _assert_block(workload_lanes_p(
        td["workloads"], wdraws, T_, T_pad, Z, **clock), want[1])
    got = region_lanes_p(tgeo, td["regions"], rdraws, T_, T_pad, Z, **clock)
    worst["regions"] = _assert_block(got, want[2])
    print(f"\n# {preset}: *_lanes_p from JAX's draws, worst difference "
          f"(relative to value + row scale): {worst}")
    storm_rows = got[:T_, 0:Z] - got[:T_, 0:Z].amin(dim=2, keepdim=True)
    assert float(storm_rows.abs().max()) > 0    # the cells differ


# ---- the axis against the port's own baked source


def _sources(cfg, cells, s: int):
    """(baked source of cell s, S = 1 axis source of it, axis source of
    every cell), the sections from cell s's config."""
    fa, wl, geo = cells.to_config(s)
    geo = geo.bound_to(cfg.cluster)
    baked = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                  cfg.signals, faults=fa, workloads=wl,
                                  extra_lanes={"regions": geo})
    kw = dict(faults=fa, workloads=wl, geo=geo)
    return (baked, ScenarioAxisSource(cfg.cluster, cfg.workload, cfg.sim,
                                      cfg.signals, cells.row(s), **kw),
            ScenarioAxisSource(cfg.cluster, cfg.workload, cfg.sim,
                               cfg.signals, cells, **kw))


def _named_cells() -> ScenarioParams:
    """The hand-named scenarios' cells (their workloads and fault preset,
    the default geo storm)."""
    return ScenarioParams.stack(
        ScenarioParams.from_config(
            faults=(tcfg.FAULT_PRESETS[sc.fault_preset]
                    if sc.fault_preset else None),
            workloads=sc.workloads, geo=tcfg.GeoConfig(enabled=True))
        for sc in tscen.WORKLOAD_SCENARIOS.values())


@pytest.mark.parametrize("preset,cells", [
    ("default", "random"), ("multiregion", "random"),
    ("default", "hand-named")])
def test_axis_streams_bitwise_the_baked_source(preset, cells):
    """S = 1, packed and blocked (block 1 of 32-tick blocks), bitwise the
    baked stream of the cell at each point; every cell of the S-cell
    stream bitwise its own baked stream (so the bitwise claim is not
    only S = 1's)."""
    cfg = PRESETS[preset]()
    cells = (_twin(_box_cells(4, 17)) if cells == "random"
             else _named_cells())
    inner = 5
    for s in range(cells.S):
        baked, one, every = _sources(cfg, cells, s)
        want = baked.packed_trace_device(T, 7, inner, t_pad=T_PAD,
                                         device="cpu")
        assert want.shape[1] == 104
        assert torch.equal(one.packed_trace_device(
            T, 7, inner, t_pad=T_PAD, device="cpu"), want), s
        got = every.packed_trace_device(T, 7, cells.S * inner, t_pad=T_PAD,
                                        device="cpu")
        assert torch.equal(got[:, :, s * inner:(s + 1) * inner], want), s
        assert torch.equal(
            one.packed_block_trace_device(32, 7, inner, 1, t_chunk=16,
                                          device="cpu"),
            baked.packed_block_trace_device(32, 7, inner, 1, t_chunk=16,
                                            device="cpu")), s


def test_s1_summaries_bitwise_the_baked_source():
    """The plain version on the S = 1 axis stream, whole and streamed in
    blocks (`sim/streaming.py`, the CARRY route's plain step), bitwise
    the same on the baked stream; an S = 2 summary's cells are its
    columns (`summary_cells`)."""
    cfg = PRESETS["default"]()
    cells = _twin(_box_cells(2, 23))
    baked, one, every = _sources(cfg, cells, 1)
    fa, wl, geo = cells.to_config(1)
    params = SimParams.from_config(dataclasses.replace(
        cfg, faults=fa, workloads=wl, geo=geo), device="cpu")
    inner = 4
    for mode in ("rule", "carbon"):
        a = mk.packed_mode_summary(
            params, cfg.cluster, mode,
            one.packed_trace_device(T, 3, inner, device="cpu"), T, 5,
            stochastic=True)
        b = mk.packed_mode_summary(
            params, cfg.cluster, mode,
            baked.packed_trace_device(T, 3, inner, device="cpu"), T, 5,
            stochastic=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), mode
    kw = dict(key=3, batch=inner, T=T, block_T=16, seed=5, t_chunk=16,
              device="cpu")
    a, _ = stm.streaming_rollout_summary(one, params, cfg.cluster, "rule",
                                         **kw)
    b, _ = stm.streaming_rollout_summary(baked, params, cfg.cluster, "rule",
                                         **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    two = mk.packed_mode_summary(
        params, cfg.cluster, "rule",
        every.packed_trace_device(T, 3, 2 * inner, device="cpu"), T, 5,
        stochastic=False)
    per = summary_cells(two, 2)
    for f, v in per.items():
        x = getattr(two, f).double().numpy()
        np.testing.assert_array_equal(v, x.reshape(2, inner).mean(axis=1))


# ---- JAX's scorer against the port's plain version


def test_jax_axis_stream_through_the_port_matches_jax_s_scorer(jscorer,
                                                              jstream):
    """JAX's S-cell stream at its scorer's CPU geometry (96 ticks, inner
    4, deterministic) through the port's plain `packed_mode_summary`:
    every field within 2e-3 per cluster of JAX's scorer summary, and the
    per-cell objectives likewise."""
    _, stream, want = jstream
    cfg = PRESETS["default"]()
    params = SimParams.from_config(dataclasses.replace(
        cfg, faults=tcfg.FaultsConfig(enabled=True),
        workloads=tcfg.WorkloadsConfig(enabled=True),
        geo=tcfg.GeoConfig(enabled=True)), device="cpu")
    got = mk.packed_mode_summary_fn(
        params, cfg.cluster, "rule", T=jscorer.steps, stochastic=False)(
        torch.from_numpy(np.array(stream)), jscorer.seed)
    worst = {}
    for f in got._fields:
        a = getattr(got, f).double().numpy()
        b = np.asarray(getattr(want, f), np.float64)
        worst[f] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6)))
    assert max(worst.values()) <= FIELD_TOL, worst
    cells = summary_cells(got, S)
    for f, v in jadv.summary_cells(want, S).items():
        np.testing.assert_allclose(cells[f], v, rtol=FIELD_TOL, atol=1e-6)
    print(f"\n# JAX's axis stream through the port: worst field "
          f"{max(worst, key=worst.get)} {max(worst.values()):.3g}")


# ---- the CEM loop, one stub scorer for both packages


class _Stub:
    """A scorer whose objectives are a fixed function of the parameters:
    both packages' loops see the same numbers, so their histories, picks
    and mints must agree to the bit."""

    def __init__(self, pkg_params, sections):
        self.P = pkg_params
        self.base_faults, self.base_workloads, self.base_geo = sections
        self.steps, self.inner, self.t_chunk, self.b_block = 96, 4, 32, 4
        self.seed, self.evals = 5, 0
        self.on_tpu = self.on_card = False
        w = np.linspace(-1.0, 1.0, len(PARAM_NAMES))
        self.w = w / np.abs(w).sum()

    def score(self, params) -> dict:
        x = params.to_array()
        self.evals += x.shape[0]
        base = np.tanh(x @ self.w)
        return {"usd_per_slo_hour": 0.3 + base,
                "slo_attainment": 0.9 - 0.1 * base,
                "inf_slo_violations": x[:, 0] * 2.0,
                "inf_queue_mean": x[:, 1], "inf_dropped": x[:, 2],
                "batch_deadline_misses": x[:, 3] + base,
                "batch_backlog_mean": x[:, 4]}

    def score_scenario(self, sc) -> dict:
        faults = sc.faults
        p = self.P.ScenarioParams.from_config(
            faults=faults, workloads=sc.workloads, geo=sc.geo)
        return {k: float(v[0]) for k, v in self.score(p).items()}


@pytest.mark.parametrize("kw", [
    dict(iters=3, pop=6, seed=23, intensity="moderate"),
    dict(iters=2, pop=4, seed=7, objective="slo_attainment",
         bounds={"storm_hazard": (0.5, 2.0)}, elite_frac=0.5)],
    ids=["moderate", "attainment"])
def test_cem_loops_agree_on_one_stub(kw):
    jres = jadv.search_scenarios(
        jcfg.default_config(), scorer=_Stub(jparams, (
            jcfg.FaultsConfig(enabled=True),
            jcfg.WorkloadsConfig(enabled=True),
            jcfg.GeoConfig(enabled=True))), **kw)
    tres = adv.search_scenarios(
        PRESETS["default"](), scorer=_Stub(tparams, (
                tcfg.FaultsConfig(enabled=True),
                tcfg.WorkloadsConfig(enabled=True),
                tcfg.GeoConfig(enabled=True))), **kw)
    assert tres.history == jres.history
    assert np.array_equal(tres.best_params.to_array(),
                          jres.best_params.to_array())
    assert tres.scenario.params_digest == jres.scenario.params_digest
    assert tres.scenario.name == jres.scenario.name
    assert (tres.best_value, tres.dominates) == (jres.best_value,
                                                 jres.dominates)
    assert json.dumps(tres.to_doc(), sort_keys=True) == json.dumps(
        jres.to_doc(), sort_keys=True)


# ---- the minted codec and replay


def _jax_minted_doc() -> dict:
    p = _box_cells(1, 31)
    fa, wl, geo = p.to_config(0)
    sc = jscen.Scenario(name="minted-test-cell", description="t",
                        workloads=wl, faults=fa, geo=geo,
                        params_json=p.to_json(), params_digest=p.digest(),
                        minted_by="test")
    sc.validate()
    return sc.to_doc()


def test_minted_codec_across_packages_and_its_refusals(tmp_path):
    doc = _jax_minted_doc()
    sc = tscen.scenario_from_doc(doc)
    assert sc.minted and sc.to_doc() == doc
    assert jscen.scenario_from_doc(sc.to_doc()).to_doc() == doc
    src = tscen.scenario_source(PRESETS["default"](), sc)
    assert src.packed_rows() == 104
    tampered = dict(doc)
    vals = json.loads(doc["params_json"])
    vals["inf_rate"] = [0.0]
    tampered["params_json"] = json.dumps(vals, sort_keys=True,
                                         separators=(",", ":"))
    for pkg in (tscen, jscen):
        with pytest.raises(ValueError, match="tampered"):
            pkg.scenario_from_doc(tampered)
        with pytest.raises(ValueError, match="BOTH"):
            pkg.scenario_from_doc(dict(doc, params_digest=""))
    (tmp_path / "a.json").write_text(json.dumps({"scenario": doc}))
    assert set(tscen.load_minted_scenarios(str(tmp_path))) == {
        "minted-test-cell"}
    (tmp_path / "b.json").write_text(json.dumps(dict(doc, name="mixed")))
    with pytest.raises(ValueError, match="collides"):
        tscen.load_minted_scenarios(str(tmp_path))


def test_port_search_mints_a_document_jax_loads_and_replay_is_exact():
    cfg = PRESETS["default"]()
    scorer = adv.ScenarioScorer(cfg, policy="carbon", steps=T,
                                inner_batch=3, t_chunk=16, seed=5,
                                device="cpu")
    res = adv.search_scenarios(cfg, policy="carbon", iters=2, pop=3,
                               seed=29, intensity="moderate", scorer=scorer)
    assert [s["S"] for s in scorer.stages] == [3, 3, 1, 1, 1, 1, 1]
    assert res.settings["backend"] == "cpu" and res.evals == 11
    doc = json.loads(json.dumps(res.to_doc()))      # through the disk
    assert jscen.scenario_from_doc(doc["scenario"]).params_digest \
        == res.scenario.params_digest
    cells = adv.replay_minted(cfg, doc, device="cpu")
    assert cells[res.objective] == res.best_value
    assert cells == res.best_cells
    with pytest.raises(ValueError, match="no mint provenance"):
        adv.replay_minted(cfg, dict(doc, scenario=tscen.WORKLOAD_SCENARIOS[
            "mixed"].to_doc()), device="cpu")


# ---- rejections up front, and the registries


def test_rejections_come_before_any_stream(monkeypatch):
    cfg = PRESETS["default"]()

    def no_stream(*a, **k):
        raise AssertionError("a stream was made")

    monkeypatch.setattr(ScenarioAxisSource, "_cells", no_stream)
    monkeypatch.setattr(adv, "ScenarioScorer", no_stream)
    for kw, msg in ((dict(objective="profit"), "objective"),
                    (dict(intensity="apocalyptic"), "intensity"),
                    (dict(bounds={"bogus": (0, 1)}),
                     "unknown scenario params"),
                    (dict(bounds={"storm_hazard": (3.0, 1.0)}),
                     "storm_hazard"),
                    (dict(iters=0), "iters"), (dict(pop=1), "pop")):
        with pytest.raises(ValueError, match=msg):
            adv.search_scenarios(cfg, device="cpu", **kw)
    monkeypatch.undo()
    monkeypatch.setattr(ScenarioAxisSource, "_cells", no_stream)
    with pytest.raises(ValueError, match="search policy"):
        adv.search_scenarios(cfg, policy="flagship", device="cpu")
    src = ScenarioAxisSource(cfg.cluster, cfg.workload, cfg.sim,
                             cfg.signals, _twin(_box_cells(3, 1)),
                             faults=tcfg.FaultsConfig(enabled=True))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="divisible"):
        src.packed_trace_device(T, 0, 7, device="cpu")
    with pytest.raises(TypeError, match="ScenarioParams"):
        src.set_params({"storm_hazard": [1.0]})


def test_mode_and_lane_registries():
    assert lanes.mode_names() == jlanes.mode_names()
    with pytest.raises(ValueError, match=r"unknown packed mode 'mlp' — have "
                       r"\('rule', 'carbon', 'neural', 'plan'\)"):
        mk.packed_mode_summary_fn(None, None, "mlp", T=8)
    lanes.register_mode("test-mode")
    try:
        with pytest.raises(ValueError, match="already registered"):
            lanes.register_mode("test-mode")
        with pytest.raises(ValueError, match="no packed_summary engine"):
            lanes.mode_engine("test-mode", "packed_summary")
        lanes.provide_mode_engine("test-mode", "block_summary", len)
        assert lanes.mode_engine("test-mode", "block_summary") is len
        with pytest.raises(ValueError, match="already has a block_summary"):
            lanes.provide_mode_engine("test-mode", "block_summary", len)
        with pytest.raises(ValueError, match="unknown engine slot"):
            lanes.provide_mode_engine("test-mode", "lax_summary", len)
    finally:
        lanes.unregister_mode("test-mode")
    assert "test-mode" not in lanes.mode_names()
    for fam in lanes.LANE_FAMILIES:
        assert callable(lanes.lane_param_generator(fam.name))
    with pytest.raises(ValueError, match="unknown lane family"):
        lanes.lane_param_generator("nope")
    with pytest.raises(ValueError, match="already has a param generator"):
        lanes.provide_lane_param_generator("faults", len)
