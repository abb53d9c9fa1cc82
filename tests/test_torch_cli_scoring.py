"""The port's scoring and training subcommands against the JAX
package's: deterministic ``evaluate`` within 1e-5 relative (the
flagship at its batch-mean standard), ``forecast-eval`` within 1e-5
(ridge 1e-4) plus the report's rounding, ``distill-factory`` on JAX's
worlds and plans at `tests/test_torch_factory.py`'s standard, ``train
--backend mpc`` objectives within 3e-4 and its plan through ``observe``,
``train --backend ppo``'s state directory, ``capture`` round trips and
``report`` / ``obs`` on the same files. Helpers and the other
subcommands: `tests/test_torch_cli.py`."""

from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.cli import main as jmain
from ccka_tpu_torch.cli import main as tmain
from test_torch_cli import CPU, _both, _close, _json_out, _run


# Fields that read the per-tick SLO gate: a cluster-tick whose latency
# sits at the gate can flip on a last-bit difference of the policy.
SLO_GATED = ("slo_attainment", "slo_hours", "usd_per_slo_hour",
             "objective_usd", "vs_rule_objective", "vs_rule_usd_per_slo_hour",
             "per_trace")


def test_deterministic_evaluate_matches_jax():
    """rule and carbon within 1e-5 relative."""
    want, got = _both(["evaluate", "--backends", "rule,carbon", "--days",
                       "0.01", "--traces", "3", "--deterministic"])
    for name, row in want.items():
        assert got[name].pop("backend") == row.pop("backend")
    _close(got, want, 1e-5, atol=1e-6)


def test_deterministic_evaluate_flagship_matches_jax():
    """The shipped flagship (ppo) at its batch-mean standard
    (`tests/test_torch_fault_board.py`): 1e-3, its counters near zero
    2e-2. Its bf16-trained policy puts a cluster-tick's latency at the SLO
    gate, where a last-bit difference flips it (measured: one tick of the
    84, trace 0, moving the attainment by 1/84 and the $/SLO-hour and the
    objective by 2.4 %): the gated fields are held to at most one flipped
    cluster-tick and 3e-2."""
    from test_torch_fault_board import FLAGSHIP_LOOSE

    traces, ticks = 3, 28
    want, got = _both(["--preset", "multiregion", "evaluate", "--backends",
                       "rule,ppo", "--days", "0.01", "--traces",
                       str(traces), "--deterministic"])
    for name, row in want.items():
        got[name].pop("backend")
        row.pop("backend")
    _close(got["rule"], want["rule"], 1e-5, atol=1e-6)
    flips = sum(abs(g - w) * ticks for g, w in zip(
        got["ppo"]["per_trace"]["slo_attainment"],
        want["ppo"]["per_trace"]["slo_attainment"]))
    assert flips <= 1 + 1e-3
    # One tick of a trace's 28 moves its own row by up to 1/28 of its
    # attainment and 6 % of its $/SLO-hour, the means by a third of that.
    _close(got["ppo"].pop("per_trace"), want["ppo"].pop("per_trace"), 7e-2)
    gated = {k: (got["ppo"].pop(k), want["ppo"].pop(k))
             for k in SLO_GATED if k != "per_trace"}
    _close(got["ppo"], want["ppo"], 1e-3, atol=1e-6, loose=FLAGSHIP_LOOSE)
    _close({k: g for k, (g, _w) in gated.items()},
           {k: w for k, (_g, w) in gated.items()}, 3e-2, atol=1e-6)


def test_stochastic_evaluate_keys_and_finite_values():
    want, got = _both(["evaluate", "--backends", "rule,carbon", "--days",
                       "0.01", "--traces", "2"])
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        assert all(math.isfinite(v) for v in got[name].values()
                   if isinstance(v, float))


# ---- forecast-eval, distill-factory, train, capture, report, obs


def test_forecast_eval_matches_jax(tmp_path):
    argv = ["--preset", "multiregion", "forecast-eval", "--steps", "400",
            "--horizon", "8", "--stride", "48", "--history", "96"]
    want, got = _both(argv)
    _close(got, want, 1e-4, atol=2e-5)
    want, got = _both(argv + ["--per-horizon", "--forecasters",
                              "persistence,seasonal-naive"])
    _close(got, want, 1e-5, atol=1e-6)


def test_distill_factory_matches_jax_on_its_worlds_and_plans(
        monkeypatch, tmp_path):
    """The CLI's sweep with each cell's worlds and plans taken from
    JAX's own cell (the factory test's seams), spot interruptions off:
    the dataset at the factory test's standard."""
    from ccka_tpu.train import factory as jfactory
    from ccka_tpu.workloads.scenarios import resolve_scenarios as jresolve
    from ccka_tpu_torch.train import factory

    rate0 = ["--set", "sim.spot_interruption_rate_hr=0"]
    jc = jcfg.default_config().with_overrides(
        **{"sim.spot_interruption_rate_hr": 0.0})
    original, jcells = factory.produce_cell, []

    def seeded(cfg, scenario, intensity, **kw):
        jscen = jresolve([scenario.name])[scenario.name]
        geo = dict(steps=kw["steps"], block_T=kw["block_T"],
                   t_chunk=kw["t_chunk"])
        jcell = jfactory.produce_cell(jc, jscen, intensity,
                                      pairs=kw["pairs"], iters=kw["iters"],
                                      seed=kw["seed"], teacher=kw["teacher"],
                                      **geo)
        jcells.append(jcell)
        worlds = np.array(jfactory._cell_stream(
            jfactory._cell_source(jc, jscen, intensity), pairs=kw["pairs"],
            key=jax.random.key(kw["seed"]), **geo))
        return original(cfg, scenario, intensity,
                        worlds=torch.from_numpy(worlds),
                        plans=torch.from_numpy(np.array(
                            jcell.plan_latents)), **kw)

    monkeypatch.setattr(factory, "produce_cell", seeded)
    out = str(tmp_path / "ds.npz")
    rc, text, err = _run(tmain, rate0 + [
        "distill-factory", "--scenarios", "mixed", "--intensities", "off",
        "--pairs", "2", "--steps", "48", "--iters", "1",
        "--student-iterations", "2", "--out", out, *CPU])
    assert rc == 0, err[-2000:]
    report = _json_out(text)
    assert report["pairs_total"] == 2 and report["dataset_path"] == out
    assert math.isfinite(report["student"]["final_actor_mse"])
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    want = jcells[0].dataset
    np.testing.assert_allclose(got["obs"], np.asarray(want.obs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["returns"], np.asarray(want.returns),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["target"], np.asarray(want.target))
    with pytest.raises(SystemExit, match="teacher"):
        _run(tmain, ["distill-factory", "--teacher", "oracle", *CPU])


def test_train_mpc_then_observe_with_its_plan(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want, got = _both(["train", "--backend", "mpc", "--iterations", "4",
                       "--checkpoint-dir", jdir])
    _run(tmain, ["train", "--backend", "mpc", "--iterations", "4",
                 "--checkpoint-dir", tdir, *CPU])
    _close(got, want, 3e-4)
    want, got = (_json_out(_run(jmain, ["observe", "--backend", "mpc",
                                        "--checkpoint", jdir])[1]),
                 _json_out(_run(tmain, ["observe", "--backend", "mpc",
                                        "--checkpoint", tdir, *CPU])[1]))
    _close(got, want, 3e-4, atol=3e-4)
    with pytest.raises(SystemExit, match="cannot load the mpc plan"):
        _run(tmain, ["observe", "--backend", "mpc", "--checkpoint",
                     str(tmp_path / "absent"), *CPU])


def test_train_ppo_state_directory_serves_observe_and_simulate(tmp_path):
    """PPO's state directory (the checkpoints' flax layout) loads in
    observe and simulate, as its npz twin does."""
    from ccka_tpu_torch.train.checkpoint import load_state, save_params_npz
    from ccka_tpu_torch.train.ppo import PPOBackend

    ckpt, runlog = str(tmp_path / "ppo"), str(tmp_path / "ppo.jsonl")
    rc, out, err = _run(tmain, [
        "--set", "train.batch_clusters=4", "--set", "train.unroll_steps=8",
        "train", "--iterations", "1", "--checkpoint-dir", ckpt,
        "--runlog", runlog, *CPU])
    assert rc == 0 and "ppo params ->" in err
    assert all(math.isfinite(v) for v in json.loads(
        out.splitlines()[0]).values())
    params = load_state(ckpt)
    npz = str(tmp_path / "ppo.npz")
    save_params_npz(npz, params)
    views = [_json_out(_run(tmain, ["observe", "--backend", "ppo",
                                    "--checkpoint", c, *CPU])[1])
             for c in (ckpt, npz)]
    assert views[0] == views[1] and views[0]["backend"] == "ppo"
    rc, out, _ = _run(tmain, ["simulate", "--backend", "ppo",
                              "--checkpoint", ckpt, "--clusters", "2",
                              "--days", "0.002", *CPU])
    assert rc == 0 and math.isfinite(_json_out(out)["cost_usd"])
    assert isinstance(PPOBackend(tcfg.default_config(), params,
                                 device="cpu"), PPOBackend)
    rc, summary, _ = _run(tmain, ["obs", "summarize", runlog])
    assert rc == 0 and _json_out(summary)["kind"] == "ppo-train"


def test_capture_round_trips_into_either_replay_source(tmp_path):
    from ccka_tpu.signals.replay import ReplaySignalSource as JReplay
    from ccka_tpu_torch.signals.replay import ReplaySignalSource

    paths = {"port": str(tmp_path / "t.npz"), "jax": str(tmp_path / "j.npz")}
    want, got = _both(["--preset", "multiregion", "capture", "--steps", "48",
                       "--seed", "4", "--out", paths["port"]])
    assert {**got, "out": ""} == {**want, "out": ""}
    _run(jmain, ["--preset", "multiregion", "capture", "--steps", "48",
                 "--seed", "4", "--out", paths["jax"]])
    for path in paths.values():
        jt = JReplay.from_file(path).trace(48)
        tt = ReplaySignalSource.from_file(path).trace(48, device="cpu")
        for f in jt._fields:
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)))
    # The two packages assemble the same noise in float32 each: the
    # files agree to its last bits.
    with np.load(paths["port"]) as a, np.load(paths["jax"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)


def test_report_and_obs_read_the_same_files_as_jax(tmp_path):
    from ccka_tpu_torch.obs.runlog import RunLog

    tele = str(tmp_path / "tele.jsonl")
    assert _run(tmain, ["run", "--ticks", "3", "--interval", "0",
                        "--telemetry", tele, *CPU])[0] == 0
    log = str(tmp_path / "run.jsonl")
    rl = RunLog(log, kind="probe", meta={"seed": 1}, echo=False)
    for i in range(4):
        rl.event("iter", iteration=i, loss=1.0 / (i + 1))
    rl.close()
    with open(log, "a") as fh:
        fh.write('{"torn": ')  # a live writer's torn last line
    for argv in (["report", "--telemetry", tele],
                 ["obs", "summarize", log], ["obs", "tail", log, "-n", "2"]):
        assert _run(tmain, argv) == _run(jmain, argv), argv
    for argv in (["report", "--telemetry", str(tmp_path / "none")],
                 ["obs", "tail", str(tmp_path / "none")]):
        with pytest.raises(SystemExit) as jerr:
            _run(jmain, argv)
        with pytest.raises(SystemExit) as terr:
            _run(tmain, argv)
        assert str(terr.value) == str(jerr.value)


