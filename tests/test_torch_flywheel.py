"""The port's continual-learning flywheel artifacts against the JAX
package's (`train/mining.py`, `train/flywheel.py`).

- mining on `tests/test_flywheel.py`'s ledger fixture shapes (plus an
  off-peak regret row), with and without a minted dir written by the
  port's codec: cells, scores and evidence equal to JAX's, exactly;
- `curriculum_from_cells` and `curriculum_digest` equal;
- `write_provenance` files byte-identical across the packages; each
  package's `load_provenance` accepts the other's file and refuses
  tamper, a missing field and a curriculum mismatch with JAX's message;
- `promotion_gates` equal to JAX's dict over its refusal axes and the
  five shadow outcomes;
- `Flywheel.evaluate` on one shared worlds block (spot rate 0, as
  `tests/test_torch_factory.py` sets it, so JAX's deterministic
  interpret kernel and the port's stochastic plain version run the same
  dynamics): every number of the rows within 1e-5 relative (plus the
  rows' own rounding quantum, 1e-6), the challenger loaded from a
  JAX-written npz whose digest the port re-derives; under the rule
  incumbent and under a checkpoint incumbent;
- a flywheel root written by one package is read, promoted and rolled
  back by the other, the params digests bitwise.

JAX's `Flywheel.distill` (its planner and interpret-mode kernels, about
85 s at `tests/test_flywheel.py`'s TINY geometry on the CPU) does not run
here: the evaluation's JAX cell is built around the port's factory cell
(its report and rule column), and the JAX-written root's artifacts are
made with the JAX package's own writers.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.train.checkpoint as jckpt
import ccka_tpu.train.flywheel as jfw
import ccka_tpu.train.mining as jmine
import ccka_tpu_torch.config as tcfg
import ccka_tpu_torch.train.checkpoint as tckpt
import ccka_tpu_torch.train.flywheel as tfw
import ccka_tpu_torch.train.mining as tmine
from ccka_tpu.sim import EpisodeSummary as JSummary
from ccka_tpu.train import factory as jfactory
from ccka_tpu_torch import bridge
from ccka_tpu_torch.models import ActorCritic, latent_dim
from ccka_tpu_torch.search.params import (PARAM_NAMES, SEARCH_BOUNDS,
                                          ScenarioParams)
from ccka_tpu_torch.train import factory as tfactory
from ccka_tpu_torch.workloads import scenarios as tscen

_RATE0 = {"sim.spot_interruption_rate_hr": 0.0}
# The port's distill geometry for the root-exchange test (about 3 s a
# generation on the CPU).
TINY = dict(steps=16, block_T=16, t_chunk=16, pairs_base=2, pairs_max=2,
            iterations=10, seed=7)


def _write_jsonl(path, rows):
    with open(path, "w", encoding="utf-8") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """`tests/test_flywheel.py`'s hand-built decision, tournament and
    incident rows, with off-peak rows whose shadow beat the live policy
    and a second board row (the mine reads the last)."""
    d = tmp_path_factory.mktemp("ledgers")
    decisions = [
        {"t": t,
         "objective": {"total": 1.0,
                       "shares": {"cost": 0.1, "carbon": 0.1,
                                  "slo_pending": 0.3,
                                  "slo_violation": 0.5,
                                  "migration": 0.0},
                       "by_class": {"class0": 0.8, "class1": 0.2}},
         "shadow": {"diverged": t % 2 == 0,
                    "objective": {"total": 0.8}},
         "exo": {"is_peak": True}}
        for t in range(8)]
    decisions += [
        {"t": 8 + t,
         "objective": {"total": 0.7 + 0.1 * t,
                       "shares": {"cost": 0.4, "carbon": 0.2,
                                  "slo_pending": 0.4,
                                  "slo_violation": 0.0},
                       "by_class": {"class0": 0.1, "class1": 0.3}},
         "shadow": {"diverged": True, "objective": {"total": 0.75}},
         "exo": {"is_peak": False}}
        for t in range(3)]
    board = {"kind": "board", "t": 7, "window_ticks": 8, "policy": "rule",
             "board": {"carbon": {
                 "win_rate": 0.25, "wins": 2, "comparisons": 8,
                 "classes": {"inference": {"win_rate": 0.75,
                                           "comparisons": 8},
                             "batch": {"win_rate": 0.25,
                                       "comparisons": 8},
                             "background": {"win_rate": 0.0,
                                            "comparisons": 8}}}}}
    older = dict(board, t=3, window_ticks=4)
    return {
        "decisions": _write_jsonl(d / "decisions.jsonl", decisions),
        "tournament": _write_jsonl(d / "tournament.jsonl", [older, board]),
        "incidents": _write_jsonl(d / "incidents.jsonl", [
            {"kind": "incident", "id": 1, "t": 5, "trigger": "slo_burn"},
            {"kind": "incident", "id": 2, "t": 6,
             "trigger": "policy_divergence"}]),
    }


@pytest.fixture(scope="module")
def minted_dir(tmp_path_factory):
    """Two minted scenarios written with the port's codec."""
    d = tmp_path_factory.mktemp("minted")
    rng = np.random.default_rng(31)
    lo = np.asarray([SEARCH_BOUNDS[k][0] for k in PARAM_NAMES])
    hi = np.asarray([SEARCH_BOUNDS[k][1] for k in PARAM_NAMES])
    cells = ScenarioParams.from_array(
        lo + (0.2 + 0.6 * rng.uniform(size=(2, len(PARAM_NAMES))))
        * (hi - lo)).clip_to_bounds()
    for i, name in enumerate(("minted-b", "minted-a")):
        p = cells.row(i)
        fa, wl, geo = p.to_config(0)
        sc = tscen.Scenario(name=name, description="t", workloads=wl,
                            faults=fa, geo=geo, params_json=p.to_json(),
                            params_digest=p.digest(), minted_by="test")
        sc.validate()
        (d / f"{name}.json").write_text(json.dumps({"scenario":
                                                    sc.to_doc()}))
    return str(d)


MINE_CASES = {
    "no evidence": dict(top_k=6),
    "decisions only": dict(surfaces=("decisions",), top_k=6),
    "all three": dict(surfaces=("decisions", "tournament", "incidents"),
                      top_k=8),
    "all three, severe column": dict(
        surfaces=("decisions", "tournament", "incidents"),
        intensities=("off", "moderate", "severe"), top_k=12),
    "all three and minted": dict(
        surfaces=("decisions", "tournament", "incidents"), minted=True,
        top_k=5),
}


@pytest.mark.parametrize("case", sorted(MINE_CASES))
def test_mining_matches_jax(case, ledgers, minted_dir):
    spec = MINE_CASES[case]
    kw = {f"{s}_path": ledgers[s] for s in spec.get("surfaces", ())}
    kw.update(top_k=spec["top_k"],
              minted_dir=minted_dir if spec.get("minted") else "")
    if "intensities" in spec:
        kw["intensities"] = spec["intensities"]
    got = [dataclasses.asdict(c) for c in tmine.mine_weakness_cells(**kw)]
    want = [dataclasses.asdict(c) for c in jmine.mine_weakness_cells(**kw)]
    assert got == want and got
    assert json.dumps(got) == json.dumps(want)
    if spec.get("minted"):
        assert [c["scenario"] for c in got[:2]] == ["minted-a", "minted-b"]
    assert (tmine.CLASS_SCENARIOS, tmine.TENANT_REGIMES,
            tmine.MINTED_SCORE_BONUS) == (jmine.CLASS_SCENARIOS,
                                          jmine.TENANT_REGIMES,
                                          jmine.MINTED_SCORE_BONUS)


def _cells(pkg, rows):
    return [pkg.WeaknessCell(*row) for row in rows]


CURRICULA = {
    "merged duplicate": ([("flash-crowd", "off", "inference", "peak", 3.0),
                          ("mixed", "off", "background", "peak", 1.0),
                          ("flash-crowd", "off", "batch", "peak", 1.5)],
                         dict(pairs_base=4, pairs_max=16)),
    "defaults": ([("batch-backfill", "moderate", "batch", "offpeak",
                   0.123456789),
                  ("mixed", "moderate", "background", "offpeak", 0.05)],
                 {}),
    "one cell": ([("mixed", "off", "background", "peak", 1.0)],
                 dict(pairs_base=3, pairs_max=6)),
}


@pytest.mark.parametrize("case", sorted(CURRICULA))
def test_curriculum_and_digest_match_jax(case):
    rows, kw = CURRICULA[case]
    got = tmine.curriculum_from_cells(_cells(tmine, rows), **kw)
    want = jmine.curriculum_from_cells(_cells(jmine, rows), **kw)
    assert got == want
    assert tmine.curriculum_digest(got) == jmine.curriculum_digest(want)
    for pkg in (tmine, jmine):
        with pytest.raises(ValueError, match="empty weakness-cell"):
            pkg.curriculum_from_cells([])


def _record():
    cur = tmine.curriculum_from_cells(
        _cells(tmine, [("mixed", "off", "background", "peak", 1.0)]))
    return {"generation": 1,
            "parent": {"name": "rule", "digest": "", "path": ""},
            "curriculum": cur,
            "curriculum_digest": tmine.curriculum_digest(cur),
            "ledger_window": {"rows": 8, "incidents": {"slo_burn": 1}},
            "seeds": {"base": 7, "generation": 1, "distill": 8},
            "checkpoint": "challenger.npz",
            "checkpoint_digest": "ab" * 32, "minted": []}


def test_provenance_files_are_byte_identical_and_cross_load(tmp_path):
    paths = {}
    for name, pkg in (("t", tfw), ("j", jfw)):
        paths[name] = str(tmp_path / f"{name}.json")
        pkg.write_provenance(paths[name], _record())
    with open(paths["t"], "rb") as a, open(paths["j"], "rb") as b:
        assert a.read() == b.read()
    assert tfw.load_provenance(paths["j"]) == jfw.load_provenance(
        paths["t"])


def _tampered(path):
    rec = tfw.write_provenance(path, _record())
    rec["checkpoint_digest"] = "00" * 32     # edit after signing
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(rec, fh)


def _partial(path):
    rec = _record()
    del rec["seeds"]
    jfw.write_provenance(path, rec)        # digest-valid but partial


def _wrong_pin(path):
    tfw.write_provenance(path, dict(_record(), curriculum_digest="0" * 64))


@pytest.mark.parametrize("make,match", [
    (_tampered, "tampered"), (_partial, "missing required"),
    (_wrong_pin, "curriculum digest")],
    ids=["tampered", "missing field", "curriculum mismatch"])
def test_provenance_refusals_are_jax_s(make, match, tmp_path):
    path = str(tmp_path / "prov.json")
    make(path)
    msgs = []
    for pkg in (tfw, jfw):
        with pytest.raises(ValueError, match=match) as e:
            pkg.load_provenance(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _rows(ratio=0.95, rel=0.0, pairs=4):
    return [{"scenario": "mixed", "intensity": "off", "pairs": pairs,
             "challenger_vs_incumbent_usd_per_slo_hour": ratio,
             "class_deltas": {"inference": {"rel_delta": rel},
                              "batch": {"rel_delta": 0.0},
                              "background": {"rel_delta": -0.01}}},
            {"scenario": "flash-crowd", "intensity": "moderate",
             "pairs": 2 * pairs,
             "challenger_vs_incumbent_usd_per_slo_hour": ratio + 0.01,
             "class_deltas": {"inference": {"rel_delta": rel / 2},
                              "batch": {"rel_delta": 0.02}}}]


def _board(usd=0.0, slo=0.0, rate=0.0, comps=16):
    return {"win_rate": rate, "comparisons": comps,
            "classes": {"inference": {"comparisons": comps,
                                      "usd_delta": usd, "slo_delta": slo},
                        "batch": {"comparisons": 0, "usd_delta": -9.0}}}


_PROV = {"record_digest": "d" * 64}
GATE_CASES = {
    "clean": (_rows(), dict(provenance=_PROV)),
    "no improvement": (_rows(ratio=1.01), dict(provenance=_PROV)),
    "class regression": (_rows(rel=0.08), dict(provenance=_PROV)),
    "empty": ([], dict(provenance=_PROV)),
    "missing provenance": (_rows(), {}),
    "history regressions": (_rows(), dict(
        provenance=_PROV,
        history_regressions=[{"kind": "recovery_invariant", "round": 9},
                             {"kind": "headline", "round": 9}])),
    "history clean": (_rows(), dict(
        provenance=_PROV, history_regressions=[{"kind": "headline"}])),
    "shadow no comparisons": (_rows(), dict(provenance=_PROV,
                                            shadow_board=_board(comps=0))),
    "shadow class harm": (_rows(), dict(provenance=_PROV,
                                        shadow_board=_board(usd=-0.5))),
    "shadow non-inferior": (_rows(), dict(provenance=_PROV,
                                          shadow_board=_board(usd=1e-7))),
    "shadow win": (_rows(), dict(provenance=_PROV,
                                 shadow_board=_board(usd=0.5, rate=0.8))),
    "shadow material loss": (_rows(), dict(
        provenance=_PROV, shadow_board=_board(usd=0.5, rate=0.2))),
    "shadow empty board": (_rows(), dict(provenance=_PROV,
                                         shadow_board={})),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_promotion_gates_match_jax(case):
    rows, kw = GATE_CASES[case]
    got = tfw.promotion_gates(rows, **kw)
    assert got == jfw.promotion_gates(rows, **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jfw.promotion_gates(rows, **kw), sort_keys=True)
    assert got["eligible"] is (case in ("clean", "history clean",
                                        "shadow non-inferior",
                                        "shadow win"))


# ---- the paired evaluation on one worlds block

EVAL_SCENARIO, EVAL_INTENSITY = "mixed", "moderate"
EVAL = dict(pairs=4, steps=32, block_T=32, t_chunk=32, seed=5)


def _random_params(F: int, A: int, seed: int, bias: float) -> dict:
    """An ActorCritic params tree (the checkpoints' layout), its actor
    head pushed off the neutral action by ``bias``."""
    net = ActorCritic(F, A, generator=torch.Generator().manual_seed(seed))
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    key = next(k for k in state if k.startswith("actor_mean")
               and k.endswith("bias"))
    state[key] += bias
    return bridge.actor_critic_to_flax(state)


def _write_live(pkg_ckpt, root, params, name="gen-001"):
    """A live checkpoint and its pointer, as a promotion leaves them."""
    path = os.path.join(root, "live.npz")
    pkg_ckpt.save_params_npz(path, params)
    _tree, meta = pkg_ckpt.load_params_npz(path)
    with open(os.path.join(root, "live.json"), "w", encoding="utf-8") as fh:
        json.dump({"name": name, "generation": 1,
                   "digest": meta[pkg_ckpt.PARAMS_DIGEST_KEY],
                   "parent": {"name": "rule", "digest": ""}}, fh)


def _numbers(rows):
    out = {}
    for i, row in enumerate(rows):
        for k, v in row.items():
            if k == "class_deltas":
                for cls, d in v.items():
                    for f in ("challenger", "incumbent", "rel_delta"):
                        out[f"{i}.{cls}.{f}"] = d[f]
            elif isinstance(v, float):
                out[f"{i}.{k}"] = v
    return out


@pytest.mark.parametrize("incumbent", ["rule", "checkpoint"])
def test_evaluate_matches_jax_on_shared_worlds(incumbent, tmp_path,
                                               monkeypatch):
    jc = jcfg.PRESETS["default"]().with_overrides(**_RATE0)
    tc = tcfg.PRESETS["default"]().with_overrides(**_RATE0)
    scen = tscen.resolve_scenarios([EVAL_SCENARIO])[EVAL_SCENARIO]
    src = tfactory._cell_source(tc, scen, EVAL_INTENSITY)
    stream = tfactory._cell_stream(
        src, steps=EVAL["steps"], block_T=EVAL["block_T"],
        t_chunk=EVAL["t_chunk"], pairs=EVAL["pairs"], key=EVAL["seed"],
        device="cpu")
    assert stream.shape[1] == 40          # exo 16, faults 8, workloads 16
    A = latent_dim(tc.cluster)
    cell = tfactory.produce_cell(
        tc, scen, EVAL_INTENSITY, worlds=stream,
        plans=torch.zeros(EVAL["pairs"], EVAL["steps"], A), device="cpu",
        **EVAL)
    F = cell.dataset.obs.shape[-1]
    ck = str(tmp_path / "challenger.npz")
    jckpt.save_params_npz(ck, _random_params(F, A, 3, 0.8))
    j_params, j_meta = jckpt.load_params_npz(ck)
    t_params, t_meta = tckpt.load_params_npz(ck)
    assert t_meta == j_meta and t_meta[tckpt.PARAMS_DIGEST_KEY] == \
        tckpt.params_digest(t_params)

    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    tf, jf = tfw.Flywheel(tc, troot, device="cpu"), jfw.Flywheel(jc, jroot)
    if incumbent == "checkpoint":
        inc = _random_params(F, A, 4, -0.5)
        _write_live(jckpt, jroot, inc)
        _write_live(tckpt, troot, inc)
        assert tf.incumbent()[0] == jf.incumbent()[0] == "gen-001"
    got = tf.evaluate(t_params, [cell], streams=[stream])

    monkeypatch.setattr(jfactory, "_cell_stream",
                        lambda *a, **k: jnp.asarray(stream.numpy()))
    jrule = JSummary(*(jnp.asarray(x.numpy()) for x in cell.rule_summary))
    jcell = jfactory.FactoryCell(EVAL_SCENARIO, EVAL_INTENSITY, None, None,
                                 None, jrule, dict(cell.report))
    want = jf.evaluate(j_params, [jcell])

    assert [{k: v for k, v in r.items() if not isinstance(v, float)
             and k != "class_deltas"} for r in got] == \
        [{k: v for k, v in r.items() if not isinstance(v, float)
          and k != "class_deltas"} for r in want]
    g, w = _numbers(got), _numbers(want)
    assert set(g) == set(w) and len(g) == 11
    for k in g:
        assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]) + 1e-6, (k, g[k], w[k])
    # The challenger acts off the rule: its column is not the rule's.
    assert g["0.background.challenger"] != g["0.background.incumbent"]


# ---- one root, two packages


def _constructed_decision(pkg, prov):
    """An eligible decision from constructed rows: the mechanics below
    need a promotion to land, not a challenger that earned one."""
    decision = pkg.promotion_gates(_rows(), provenance=prov)
    assert decision["eligible"]
    return decision


def _jax_generation(root, gen, params, parent):
    """Generation ``gen``'s artifacts written with the JAX package's
    writers, as its `distill` lays them out."""
    gdir = os.path.join(root, "generations", f"gen-{gen:03d}")
    os.makedirs(gdir, exist_ok=True)
    ckpt = os.path.join(gdir, "challenger.npz")
    cur = jmine.curriculum_from_cells(
        _cells(jmine, [("mixed", "off", "background", "peak", 1.0)]))
    jckpt.save_params_npz(ckpt, params, meta={"generation": gen})
    _tree, meta = jckpt.load_params_npz(ckpt)
    return jfw.write_provenance(os.path.join(gdir, "provenance.json"), {
        "generation": gen, "teacher": "mpc", "parent": parent,
        "curriculum": cur, "curriculum_digest": jmine.curriculum_digest(cur),
        "ledger_window": {"rows": 0}, "seeds": {"base": 7},
        "checkpoint": "challenger.npz",
        "checkpoint_digest": meta[jckpt.PARAMS_DIGEST_KEY], "minted": []})


def _digest(params):
    return tckpt.params_digest(params)


def _dims(tc) -> tuple[int, int]:
    """(observation, latent) widths of the config's policy net."""
    from ccka_tpu_torch.sim.megakernel import _obs_dim
    return (_obs_dim(tc.cluster.n_pools, tc.cluster.n_zones),
            latent_dim(tc.cluster))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_roots_are_interchangeable(writer, tmp_path):
    """Generations 1 and 2 written by ``writer`` (the port's `distill` at
    a tiny geometry on the CPU, or the JAX package's writers), then
    promoted, read and rolled back alternately by the two packages: every
    status equal across the packages, every restored params digest the
    one its promotion recorded."""
    tc = tcfg.default_config()
    root = str(tmp_path / "fw")
    tf = tfw.Flywheel(tc, root, device="cpu", **TINY)
    jf = jfw.Flywheel(jcfg.default_config(), root, **TINY)
    if writer == "port":
        cells = tf.mine(top_k=1)
        prov1 = tf.distill(cells, generation=1)["provenance"]
    else:
        prov1 = _jax_generation(root, 1, _random_params(*_dims(tc), 5, 0.1),
                                {"name": "rule", "digest": "", "path": ""})
    assert tf.status() == jf.status()
    assert tf.status()["generations"][0]["provenance"] == "verified"

    # gen-1 promoted by JAX, read by the port.
    jf.promote(1, _constructed_decision(jfw, prov1))
    name, params = tf.incumbent()
    assert name == "gen-001" and _digest(params) == prov1[
        "checkpoint_digest"]
    assert tf.status() == jf.status()

    # gen-2, warm-started on gen-1, promoted by the port.
    if writer == "port":
        rep2 = tf.distill(cells, generation=2)
        prov2 = rep2["provenance"]
        assert rep2["parent"] == {"name": "gen-001",
                                  "digest": prov1["checkpoint_digest"]}
    else:
        prov2 = _jax_generation(
            root, 2, _random_params(*_dims(tc), 6, 0.2),
            {"name": "gen-001", "digest": prov1["checkpoint_digest"],
             "path": jf.live_npz})
    live2 = tf.promote(2, _constructed_decision(tfw, prov2))
    assert live2["parent"]["digest"] == prov1["checkpoint_digest"]
    name, params = jf.incumbent()
    assert name == "gen-002" and _digest(params) == prov2[
        "checkpoint_digest"]
    assert tf.status() == jf.status()

    # The port rolls gen-2 back to gen-1 bitwise; JAX reads it and rolls
    # gen-1 back to the rule.
    restored = tf.rollback(incident={"id": 1, "t": 3})
    assert restored["name"] == "gen-001"
    name, params = jf.incumbent()
    assert name == "gen-001" and _digest(params) == prov1[
        "checkpoint_digest"]
    assert tf.status() == jf.status()
    assert jf.rollback()["name"] == "rule"
    assert tf.incumbent() == ("rule", None)
    for pkg_fw in (tf, jf):
        with pytest.raises(ValueError, match="nothing is promoted"):
            pkg_fw.rollback()
    assert tf.status() == jf.status()
