"""The port's replay-flagship and carbon-frontier trainers against the JAX
scripts.

`scripts/torch_train_replay_flagship.py` and
`scripts/torch_train_carbon_frontier.py` are held to
`scripts/train_replay_flagship.py` and `scripts/train_carbon_frontier.py`
on the same inputs: the holdout split of the committed 9-day store
bitwise; each script's `main` at ``--generations 0`` with the shipped
checkpoint as its init and the world draws off (the frameworks' draws
differ: threefry against Philox), its selection scoreboard and ratios at
the standard of `tests/test_torch_cli_scoring.py::
test_deterministic_evaluate_flagship_matches_jax`; then each twin's `main`
end to end on the CPU at a tiny size. The JAX scripts are imported from
`scripts/` by path; their module-level names (`split_sources`, `imitate`,
`distill_teacher`, `heldout_traces`, `evaluate_backend`) are
monkeypatched, never edited.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import ccka_tpu_torch.config as tcfg
from ccka_tpu_torch.obs.runlog import RUNLOG_EVENTS, read_runlog
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.train.checkpoint import PARAMS_DIGEST_KEY, load_params_npz
from test_torch_scripts_data import load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment")
RULE_RTOL = 1e-5
# The flagship's standard (test_deterministic_evaluate_flagship_matches_
# jax): 1e-3 on its continuous fields, 3e-2 on the SLO-gated ones, at
# most one flipped cluster-tick of attainment.
PPO_RTOL, GATED_RTOL = 1e-3, 3e-2


def run_main(mod, argv, **kw) -> dict:
    """A script's ``main`` with its stdout captured, parsed as JSON."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(argv, **kw) == 0
    return json.loads(out.getvalue())


def torch_batch(traces) -> ExogenousTrace:
    """A list of JAX traces as one [n, T, ...] batch of the port."""
    return ExogenousTrace(*(torch.as_tensor(np.stack(
        [np.asarray(getattr(tr, f)) for tr in traces]))
        for f in ExogenousTrace._fields))


def leaves(tree: dict, prefix: str = "") -> dict:
    """{path: array} of a nested params tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def close(got: float, want: float, rtol: float, what: str) -> None:
    assert abs(got - want) <= 1e-6 + rtol * abs(want), (what, got, want)


def check_scoreboard(got: dict, want: dict, ticks: int, n: int) -> None:
    """rule and teacher within RULE_RTOL; the flagship (ppo) at its
    standard."""
    for who in ("rule", "teacher"):
        for k in HEADLINE:
            close(got[who][k], want[who][k], RULE_RTOL, f"{who}.{k}")
    flips = abs(got["ppo"]["slo_attainment"]
                - want["ppo"]["slo_attainment"]) * ticks * n
    assert flips <= 1 + 1e-3
    close(got["ppo"]["g_co2_per_kreq"], want["ppo"]["g_co2_per_kreq"],
          PPO_RTOL, "ppo.g_co2_per_kreq")
    for k in ("usd_per_slo_hour", "slo_attainment"):
        close(got["ppo"][k], want["ppo"][k], GATED_RTOL, f"ppo.{k}")


@pytest.fixture(scope="module")
def replay_jax():
    return load_script("train_replay_flagship")


@pytest.fixture(scope="module")
def replay_port():
    return load_script("torch_train_replay_flagship")


@pytest.fixture(scope="module")
def frontier_jax():
    return load_script("train_carbon_frontier")


@pytest.fixture(scope="module")
def frontier_port():
    return load_script("torch_train_carbon_frontier")


# ---- the replay flagship


def test_split_sources_is_bitwise_jax(replay_jax, replay_port):
    jtrain, jsel = replay_jax.split_sources(replay_jax.TRAIN_TRACE, 2880)
    train, sel = replay_port.split_sources(replay_port.TRAIN_TRACE, 2880,
                                           device="cpu")
    assert replay_port.TRAIN_TRACE == replay_jax.TRAIN_TRACE
    assert sel.is_peak.shape == (len(jsel), 2880) == (5, 2880)
    for f in ExogenousTrace._fields:
        for i, tr in enumerate(jsel):
            assert np.array_equal(getattr(sel, f)[i].numpy(),
                                  np.asarray(getattr(tr, f))), (f, i)
        assert np.array_equal(getattr(train._trace, f).numpy(),
                              np.asarray(getattr(jtrain._trace, f))), f
    assert train._trace.steps == jtrain._trace.steps == 6 * 2880
    assert train.meta().description == jtrain._meta.description


def test_replay_selection_of_the_shipped_params_matches_jax(
        monkeypatch, tmp_path, replay_jax, replay_port):
    """Both mains at --generations 0, the shipped replay checkpoint as the
    init, scored on 2 holdout windows cut to 96 ticks, world draws off."""
    from ccka_tpu.train.evaluate import evaluate_backend as jeval
    from ccka_tpu_torch.train.evaluate import evaluate_backend as teval

    ticks, n = 96, 2
    params, shipped = load_params_npz(replay_port.OUT)
    jtrain, jsel = replay_jax.split_sources(replay_jax.TRAIN_TRACE, 2880)
    train, sel = replay_port.split_sources(replay_port.TRAIN_TRACE, 2880,
                                           device="cpu")
    jsel = [tr.slice_steps(0, ticks) for tr in jsel[:n]]
    sel = ExogenousTrace(*(x[:n, :ticks] for x in sel))
    init = lambda *a, **k: (params, [{"actor_mse": 0.0}])  # noqa: E731
    for mod, split, ev in ((replay_jax, (jtrain, jsel), jeval),
                           (replay_port, (train, sel), teval)):
        monkeypatch.setattr(mod, "split_sources",
                            lambda *a, split=split, **k: split)
        monkeypatch.setattr(mod, "imitate", init)
        monkeypatch.setattr(mod, "evaluate_backend",
                            functools.partial(ev, stochastic=False))
    argv = ["--generations", "0", "--runlog", ""]
    want = run_main(replay_jax, argv + ["--out", str(tmp_path / "j.npz")])
    got = run_main(replay_port, argv + ["--out", str(tmp_path / "t.npz"),
                                        "--device", "cpu"])
    assert set(got) == set(want)
    check_scoreboard(got["selection_scoreboard"],
                     want["selection_scoreboard"], ticks, n)
    for k in ("worst_window_usd_ratio", "worst_window_co2_ratio"):
        close(got[k], want[k], GATED_RTOL, k)
    for k in ("selected", "selected_iteration", "wins_both",
              "all_windows_win", "selection_windows", "train_trace",
              "es_seeds", "traces_per_gen", "cem_engine"):
        assert got[k] == want[k], k
    saved, meta = load_params_npz(str(tmp_path / "t.npz"))
    assert set(meta) == set(shipped) | {PARAMS_DIGEST_KEY}
    assert leaves(saved).keys() == leaves(params).keys()
    assert all(np.array_equal(a, leaves(params)[k])
               for k, a in leaves(saved).items())


def test_replay_main_end_to_end_on_the_cpu(tmp_path, replay_port):
    """A day of 48 ticks (dt 1800 s), a 9-day store from the trace twin,
    the lax engine, 2 generations in 2 chunks, 1 ES seed, 5 distillation
    iterations."""
    traces = load_script("torch_make_replay_trace")
    cfg = tcfg.default_config().with_overrides(**{
        "sim.dt_s": 1800.0, "train.batch_clusters": 8,
        "train.unroll_steps": 8})
    store = str(tmp_path / "replay_train_9day.npz")
    assert traces.main(["--variant", "train9"], cfg=cfg, out=store) == 0
    runlog, out = tmp_path / "replay.jsonl", tmp_path / "replay.npz"
    doc = run_main(replay_port, [
        "--generations", "2", "--eval-every", "1", "--es-seeds", "1",
        "--distill-iterations", "5", "--engine", "lax", "--popsize", "3",
        "--traces", "4", "--runlog", str(runlog), "--out", str(out),
        "--device", "cpu"], cfg=cfg, train_path=store)
    params, meta = load_params_npz(str(out))
    _, shipped = load_params_npz(replay_port.OUT)
    assert set(meta) == set(shipped) | {PARAMS_DIGEST_KEY}
    assert doc["checkpoint"] == str(out)
    assert set(params) == {"params"} and all(
        np.isfinite(v).all() for v in params["params"]["actor_mean"].values())
    records = read_runlog(str(runlog), strict=True)
    assert all(r["event"] in RUNLOG_EVENTS for r in records)
    names = [r["name"] for r in records if r["event"] == "eval"]
    assert names == ["init", "seed0@gen1", "seed0@gen2"]
    assert meta["selected"] in names
    assert sum(r["event"] == "gen" for r in records) == 2
    assert meta["selection_windows"] == 5 and meta["train_trace"] == (
        "replay_train_9day.npz")


# ---- the carbon frontier


def test_frontier_eval_of_the_shipped_flagship_matches_jax(
        monkeypatch, tmp_path, frontier_jax, frontier_port):
    """Both mains at --generations 0, the shipped multiregion flagship as
    the init, scored on JAX's selection traces (3 x 48 ticks), world draws
    off: the ratios at the flagship's standard, feasibility equal."""
    import ccka_tpu.config as jcfg
    from ccka_tpu.signals.synthetic import SyntheticSignalSource
    from ccka_tpu.train.evaluate import evaluate_backend as jeval
    from ccka_tpu.train.evaluate import heldout_traces as jheld
    from ccka_tpu_torch.train.evaluate import evaluate_backend as teval
    from ccka_tpu_torch.train.flagship import flagship_checkpoint_path

    ticks, n = 48, 3
    cfg = jcfg.multi_region_config()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    jtraces = jheld(src, steps=ticks, n=n, seed0=20_000)
    params, _ = load_params_npz(flagship_checkpoint_path(
        tcfg.multi_region_config()))
    init = lambda *a, **k: (params, [{"actor_mse": 0.0}])  # noqa: E731
    for mod, traces, ev in ((frontier_jax, jtraces, jeval),
                            (frontier_port, torch_batch(jtraces), teval)):
        monkeypatch.setattr(mod, "heldout_traces",
                            lambda *a, traces=traces, **k: traces)
        monkeypatch.setattr(mod, "distill_teacher", init)
        monkeypatch.setattr(mod, "evaluate_backend",
                            functools.partial(ev, stochastic=False))
    argv = ["--generations", "0", "--eval-steps", str(ticks)]
    want = run_main(frontier_jax, argv + ["--out", str(tmp_path / "j.npz")])
    got = run_main(frontier_port, argv + ["--out", str(tmp_path / "t.npz"),
                                          "--device", "cpu"])
    assert set(got) == set(want)
    check_scoreboard(got["selection_scoreboard"],
                     want["selection_scoreboard"], ticks, n)
    (g,), (w,) = got["history"], want["history"]
    assert set(g) == set(w)
    assert g["feasible"] == w["feasible"] and g["generation"] == 0
    close(g["co2_ratio"], w["co2_ratio"], PPO_RTOL, "co2_ratio")
    close(g["co2_vs_teacher"], w["co2_vs_teacher"], PPO_RTOL,
          "co2_vs_teacher")
    for k in ("usd_ratio", "slo_attainment"):
        close(g[k], w[k], GATED_RTOL, k)
    for k in ("frontier_claimed", "wins_both", "selected_iteration",
              "fitness", "selection_seed0", "family"):
        assert got[k] == want[k], k
    assert got["checkpoint"] == str(tmp_path / "t.npz")


@pytest.mark.parametrize("out,claimed,where", [
    ("runs/mine.npz", True, "runs/mine.npz"),
    ("", True, os.path.join("ccka_tpu_torch", "checkpoints",
                            "ppo_flagship_multiregion_frontier.npz")),
    ("", False, os.path.join("runs", "mr_frontier_unclaimed.npz"))])
def test_frontier_output_path_rule(out, claimed, where, frontier_port):
    path = frontier_port.out_path(out, claimed, tcfg.multi_region_config())
    if out:
        assert path == out
    else:
        assert path == os.path.join(ROOT, where)


def test_frontier_main_end_to_end_on_the_cpu(monkeypatch, tmp_path,
                                             frontier_port):
    """--eval-steps 48, 2 generations in 2 chunks of 128 traces through the
    mega engine's plain versions, the ES windows cut from a day to 48
    ticks and its population to 4 (the script trains on full days)."""
    from ccka_tpu_torch.train.cem import cem_refine

    def short(cfg, params, source, *, cem, **kw):
        return cem_refine(cfg, params, source,
                          cem=cem._replace(eval_steps=48, popsize=4), **kw)

    monkeypatch.setattr(frontier_port, "cem_refine", short)
    cfg = tcfg.multi_region_config().with_overrides(**{
        "train.batch_clusters": 8, "train.unroll_steps": 8})
    out = tmp_path / "frontier.npz"
    doc = run_main(frontier_port, [
        "--generations", "2", "--eval-every", "1", "--traces-per-gen", "128",
        "--eval-steps", "48", "--distill-iterations", "5", "--out", str(out),
        "--device", "cpu"], cfg=cfg)
    params, meta = load_params_npz(str(out))
    assert [h["generation"] for h in meta["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["cem_fitness"]) for h in meta["history"][1:])
    assert meta["selected_iteration"] in (0, 1, 2)
    assert meta["frontier_claimed"] == doc["frontier_claimed"]
    assert isinstance(meta["frontier_claimed"], bool)
    assert all(np.isfinite(v).all()
               for v in params["params"]["actor_mean"].values())


@pytest.mark.parametrize("name,argv", [
    ("torch_zone_spread_probe", ["--steps", "8", "--traces", "1"]),
    ("torch_train_replay_flagship", ["--generations", "0"]),
    ("torch_train_carbon_frontier", ["--generations", "0"])])
def test_twins_run_on_the_card_by_default(name, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_script(name).main(argv)
