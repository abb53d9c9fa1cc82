"""The port's FlywheelRunner and `flywheel` command line on the CPU.

- one generation at a tiny geometry (3 tenants, 4 ticks a service run,
  one curriculum cell of 2 pairs x 16 ticks, 10 Adam iterations): a
  seeded rerun through `run` in a fresh root and scratch dir gives the
  same record (mined cells, curriculum and checkpoint digests,
  evaluation rows, the shadow board's counts and the decision), and the
  divergence watch demotes a promoted challenger to its rule parent;
- the tick cache keys a backend by identity and builds the roster's
  lanes inside: two shadow runs with different slotted checkpoints
  score each checkpoint's own lane (each board equal to a cold-cache
  run's of the same checkpoint, the two boards apart);
- the paired evaluation: the rule column a cell was labeled with is
  bitwise the rule rollout of the stream `evaluate` regenerates from the
  cell's seed, under the cell's recorded dynamics; regenerating and
  passing that stream give the same rows;
- `flywheel status | mine | promote` print JSON equal to the JAX
  package's command line on the same root and ledgers (paths aside);
  unknown intensities and teachers, and a promotion without a recorded
  decision, are refused with JAX's message before any work; `flywheel
  distill --device cpu` writes the decision `promote` applies.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import ccka_tpu.train.checkpoint as jckpt
import ccka_tpu_torch.config as tcfg
from ccka_tpu.cli import main as jmain
from ccka_tpu_torch.cli import main as tmain
from ccka_tpu_torch.harness import service
from ccka_tpu_torch.harness.flywheel import CHALLENGER_LANE, FlywheelRunner
from ccka_tpu_torch.sim.megakernel import packed_mode_summary
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train import factory
from ccka_tpu_torch.train import flywheel as tfw
from ccka_tpu_torch.train.checkpoint import params_digest, save_params_npz

from test_torch_flywheel import (_constructed_decision, _dims,
                                 _jax_generation, _random_params,
                                 ledgers)  # noqa: F401  (a fixture)

FW = dict(steps=16, block_T=16, t_chunk=16, pairs_base=2, pairs_max=2,
          iterations=10, seed=7)
RUNNER = dict(n_tenants=3, record_ticks=4, shadow_ticks=4, watch_ticks=4,
              top_k=1, seed=211)


def _runner(tmp_path, tag: str):
    cfg = tcfg.default_config()
    fw = tfw.Flywheel(cfg, str(tmp_path / tag / "root"), device="cpu",
                      **FW)
    return FlywheelRunner(cfg, fw, scratch=str(tmp_path / tag / "runs"),
                          **RUNNER)


def test_seeded_rerun_is_bitwise_and_divergence_rolls_back(tmp_path):
    """The rerun goes through `run`; the watch demotes a promotion made
    with an eligible decision from constructed rows (a ten-iteration
    challenger does not earn one), so it runs whatever the gates
    decided."""
    a = _runner(tmp_path, "a")
    assert a.profiles == ["healthy", "batch", "slow"]
    g1 = a.generation(1)
    assert len(g1["mined_cells"]) == 1 and len(g1["eval"]) == 1
    assert g1["shadow_board"]["comparisons"] > 0
    assert set(g1["shadow_board"]["classes"]) == {"inference", "batch",
                                                  "background"}
    assert g1["ledger_window"]["rows"] == RUNNER["n_tenants"] * RUNNER[
        "record_ticks"]
    b = _runner(tmp_path, "b")
    arc = b.run(generations=1)
    assert json.dumps(arc["generations"], sort_keys=True) == json.dumps(
        [g1], sort_keys=True)
    assert arc["promotions"] == int(g1["promoted"])
    assert arc["status"]["incumbent"] == ("gen-001" if g1["promoted"]
                                          else "rule")
    assert ("rollback" in arc) == g1["promoted"]
    assert arc.get("status_after_rollback", arc["status"]) \
        == b.fw.status()

    # The watch: the promoted challenger against its rule shadow; the
    # rule parent is restored by clearing the live files.
    if not g1["promoted"]:
        with pytest.raises(ValueError, match="nothing is promoted"):
            a.fw.rollback()
        prov = tfw.load_provenance(
            os.path.join(a.fw.gen_dir(1), "provenance.json"))
        a.fw.promote(1, _constructed_decision(tfw, prov))
    assert a.fw.incumbent()[0] == "gen-001"
    rb = a.divergence_rollback()
    assert rb["watch"]["incumbent"] == "gen-001"
    assert rb["rolled_back"] and rb["demoted"] == "gen-001"
    assert rb["watch"]["incidents"]["policy_divergence"] == 1
    assert rb["restored"] == {"name": "rule", "digest": ""}
    assert not os.path.exists(a.fw.live_npz)
    assert not os.path.exists(a.fw.live_json)
    assert a.fw.status()["incumbent"] == "rule"
    if g1["promoted"]:
        assert arc["rollback"] == rb


def test_shadow_scores_the_newly_slotted_checkpoint(tmp_path):
    runner = _runner(tmp_path, "s")
    cfg = runner.cfg
    paths = {}
    for name, seed, bias in (("a", 3, 1.5), ("b", 4, -1.5)):
        paths[name] = str(tmp_path / f"{name}.npz")
        save_params_npz(paths[name], _random_params(*_dims(cfg), seed,
                                                    bias))
    try:
        board_a = runner.shadow(paths["a"])["board"][CHALLENGER_LANE]
        board_b = runner.shadow(paths["b"])["board"][CHALLENGER_LANE]
        service._compiled_service_tick.cache_clear()
        cold_b = _runner(tmp_path, "cold").shadow(paths["b"])[
            "board"][CHALLENGER_LANE]
    finally:
        tfw.set_challenger_checkpoint("")
    assert board_b == cold_b
    assert board_a != board_b
    assert board_b["comparisons"] == RUNNER["n_tenants"] * RUNNER[
        "shadow_ticks"]


def test_evaluate_pairs_the_labeled_rule_column(tmp_path):
    cfg = tcfg.default_config()
    fw = tfw.Flywheel(cfg, str(tmp_path / "fw"), device="cpu", **FW)
    cells = fw.mine(top_k=2)
    rep = fw.distill(cells, generation=1)
    assert [c.report["seed"] for c in rep["produced"]] == [
        FW["seed"] + 1000, FW["seed"] + 1010]
    streams = []
    params = SimParams.from_config(cfg, device="cpu")
    for cell in rep["produced"]:
        r = cell.report
        assert r["stochastic"] is True
        stream = factory._cell_stream(
            factory._cell_source(cfg, fw._resolve_scenario(cell.scenario),
                                 cell.intensity),
            steps=r["steps"], block_T=r["block_T"], t_chunk=r["t_chunk"],
            pairs=r["pairs"], key=r["seed"], device="cpu")
        rule = packed_mode_summary(params, cfg.cluster, "rule", stream,
                                   r["steps"], r["seed"], stochastic=True)
        for got, want in zip(rule, cell.rule_summary):
            assert torch.equal(got, want)
        streams.append(stream)
    ch, _ = jckpt.load_params_npz(rep["checkpoint"])
    rows = fw.evaluate(ch, rep["produced"])
    assert rows == fw.evaluate(ch, rep["produced"], streams=streams)
    assert [r["challenger_vs_incumbent_usd_per_slo_hour"] for r in rows] \
        == [r["challenger_vs_rule_usd_per_slo_hour"] for r in rows]
    assert rep["provenance"]["checkpoint_digest"] == params_digest(ch)


# ---- the command line


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _both(argv_j, argv_t):
    jrc, jout, _ = _run(jmain, argv_j)
    trc, tout, terr = _run(tmain, argv_t)
    assert jrc == trc == 0, terr[-2000:]
    return json.loads(jout), json.loads(tout)


def test_cli_status_and_mine_print_jax_s_json(tmp_path, ledgers):  # noqa: F811
    root = str(tmp_path / "fw")
    want, got = _both(["flywheel", "status", "--root", root],
                      ["flywheel", "status", "--root", root])
    assert got == want and got["incumbent"] == "rule"
    argv = ["flywheel", "mine", "--root", root,
            "--decisions", ledgers["decisions"],
            "--tournament", ledgers["tournament"],
            "--incidents", ledgers["incidents"], "--top-k", "5",
            "--intensities", "off,moderate,severe"]
    want, got = _both(argv, argv)
    assert got == want and len(got) == 5
    # A generation written with JAX's writers: status verifies it alike.
    cfg = tcfg.default_config()
    _jax_generation(root, 1, _random_params(*_dims(cfg), 5, 0.1),
                    {"name": "rule", "digest": "", "path": ""})
    want, got = _both(["flywheel", "status", "--root", root],
                      ["flywheel", "status", "--root", root])
    assert got == want
    assert got["generations"][0]["provenance"] == "verified"


def test_cli_promote_prints_jax_s_json(tmp_path):
    cfg = tcfg.default_config()
    src = str(tmp_path / "src")
    prov = _jax_generation(src, 1, _random_params(*_dims(cfg), 5, 0.1),
                           {"name": "rule", "digest": "", "path": ""})
    with open(os.path.join(src, "generations", "gen-001", "decision.json"),
              "w", encoding="utf-8") as fh:
        json.dump({"decision": _constructed_decision(tfw, prov),
                   "eval": []}, fh)
    out = {}
    for name, main in (("j", jmain), ("t", tmain)):
        root = str(tmp_path / name)
        shutil.copytree(src, root)
        rc, text, _ = _run(main, ["flywheel", "promote", "--root", root,
                                  "--generation", "1"])
        assert rc == 0
        out[name] = json.loads(text.replace(root, "<root>"))
        live, _meta = jckpt.load_params_npz(os.path.join(root, "live.npz"))
        assert params_digest(live) == prov["checkpoint_digest"]
    assert out["t"] == out["j"] and out["t"]["name"] == "gen-001"


REFUSALS = {
    "unknown intensity": (["flywheel", "mine", "--intensities",
                           "off,catastrophic"], "unknown fault intensities"),
    "empty intensities": (["flywheel", "mine", "--intensities", ","],
                          "unknown fault intensities"),
    "unknown teacher": (["flywheel", "distill", "--teacher", "oracle"],
                        "unknown teacher"),
    "no decision": (["flywheel", "promote", "--generation", "3"],
                    "refused"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cli_refusals_are_jax_s_and_come_first(case, tmp_path):
    argv, match = REFUSALS[case]
    root = str(tmp_path / "fw")
    msgs = []
    for main in (jmain, tmain):
        with pytest.raises(SystemExit, match=match) as e:
            _run(main, [*argv, "--root", root])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    if case != "no decision":
        assert not os.path.exists(root)   # refused before the root exists
    else:
        assert os.listdir(os.path.join(root, "generations")) == []


def test_cli_distill_writes_the_decision_promote_applies(tmp_path):
    root = str(tmp_path / "fw")
    rc, out, _ = _run(tmain, ["flywheel", "distill", "--root", root,
                              "--top-k", "1", "--steps", "16",
                              "--pairs-base", "2", "--pairs-max", "2",
                              "--iters", "5", "--seed", "3",
                              "--device", "cpu"])
    assert rc == 0
    doc = json.loads(out)
    with open(doc["decision_path"], encoding="utf-8") as fh:
        rec = json.load(fh)
    assert rec == {"decision": doc["decision"], "eval": doc["eval"]}
    assert len(doc["eval"]) == 1 and np.isfinite(
        doc["eval"][0]["challenger_vs_incumbent_usd_per_slo_hour"])
    argv = ["flywheel", "promote", "--root", root, "--generation", "1"]
    if doc["decision"]["eligible"]:
        assert _run(tmain, argv)[0] == 0
        assert tfw.Flywheel(tcfg.default_config(), root).incumbent()[0] \
            == "gen-001"
    else:
        with pytest.raises(SystemExit, match="promotion refused"):
            _run(tmain, argv)
        assert not os.path.exists(os.path.join(root, "live.npz"))
