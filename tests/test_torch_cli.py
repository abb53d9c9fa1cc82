"""The port's command line against the JAX package's: each ported
subcommand through ``ccka_tpu_torch.cli.main([..., "--device", "cpu"])``
and ``ccka_tpu.cli.main`` with the same argv. This file holds the
profile commands, ``show-config``, ``observe``, ``simulate``, the
device rule and the helpers (`tests/test_torch_observatory.py` holds
``perf``, ``bench-diff`` and ``scaling-curve``);
`tests/test_torch_cli_scoring.py` holds evaluate, forecast-eval,
distill-factory, train, capture, report and obs, and
`tests/test_torch_cli_boards.py` the boards.

Standards: the profile commands and ``show-config`` byte for byte;
``observe`` within 1e-6 (rule, carbon, ppo) and 3e-4 (mpc: the two
planners' float sums, `tests/test_torch_mpc.py`); deterministic
``simulate`` within 1e-5 relative (ppo over a fleet at the flagship's
1e-3), stochastic runs the same keys and finite values (the two
frameworks draw from different streams); a stream with lanes scored
by the packed entry. Without a GPU every subcommand that runs torch
work exits naming the device unless asked for the CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from ccka_tpu.cli import main as jmain
from ccka_tpu_torch import cli
from ccka_tpu_torch.cli import main as tmain

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
DAY_48 = "0.02084"  # 60 ticks of 30 s


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _json_out(text: str):
    return json.loads(text[text.index("{"):])


def _both(argv, port_extra=CPU):
    """(JAX's, the port's) parsed JSON stdout for one argv."""
    jrc, jout, _ = _run(jmain, argv)
    trc, tout, terr = _run(tmain, list(argv) + list(port_extra))
    assert jrc == trc == 0, terr[-2000:]
    return _json_out(jout), _json_out(tout)


def _close(got, want, rtol: float, atol: float = 0.0, path: str = "",
           loose=()):
    """Nested JSON documents: the same keys and types, numbers within
    ``rtol`` relative (``atol`` absolute; keys in ``loose`` 2e-2
    relative), everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            _close(got[k], want[k], 2e-2 if k in loose else rtol, atol,
                   f"{path}.{k}", loose)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rtol, atol, f"{path}[{i}]", loose)
    elif isinstance(want, bool) or not isinstance(want, (int, float)):
        assert got == want, (path, got, want)
    else:
        assert isinstance(got, (int, float)), path
        assert abs(got - want) <= atol + rtol * abs(want), (path, got, want)


# ---- the profile commands and the config


@pytest.mark.parametrize("argv", [
    ["show-config"], ["--preset", "multiregion", "show-config"],
    ["--set", "sim.dt_s=15", "show-config"],
    ["offpeak"], ["offpeak", "--json"], ["peak"], ["peak", "--json"],
    ["reset"], ["reset", "--json"],
    ["--preset", "multiregion", "offpeak"],
    ["--preset", "multiregion", "peak", "--json"],
], ids=lambda a: " ".join(a))
def test_profile_commands_and_config_byte_identical(argv):
    assert _run(tmain, argv) == _run(jmain, argv)


def test_bad_override_and_config_errors_match():
    for argv in (["--set", "sim.dt_s", "show-config"],
                 ["--config", "x.json", "--preset", "multiregion",
                  "show-config"]):
        with pytest.raises(SystemExit) as jerr:
            _run(jmain, argv)
        with pytest.raises(SystemExit) as terr:
            _run(tmain, argv)
        assert str(terr.value) == str(jerr.value)
    argv = ["--set", "sim.dt_s=-1", "show-config"]
    (jrc, _, jerr_), (trc, _, terr_) = _run(jmain, argv), _run(tmain, argv)
    assert jrc == trc == 2 and "config error" in terr_


# ---- observe


@pytest.mark.parametrize("preset,backend,rtol", [
    ("default", "rule", 1e-6), ("default", "carbon", 1e-6),
    ("multiregion", "carbon", 1e-6), ("multiregion", "ppo", 1e-6),
    ("default", "mpc", 3e-4)])
def test_observe_matches_jax(preset, backend, rtol):
    want, got = _both(["--preset", preset, "observe", "--backend", backend])
    _close(got, want, rtol, atol=rtol)


# ---- simulate


@pytest.mark.parametrize("backend,clusters,preset", [
    ("rule", 4, "default"), ("carbon", 4, "default"),
    ("neutral", 4, "default"), ("carbon", 4, "multiregion"),
    ("rule", 1, "default"), ("neutral", 1, "multiregion")])
def test_deterministic_simulate_matches_jax(backend, clusters, preset):
    want, got = _both(["--preset", preset, "simulate", "--backend", backend,
                       "--clusters", str(clusters), "--days", DAY_48,
                       "--seed", "3"])
    _close(got, want, 1e-5, atol=1e-6)
    assert got["clusters"] == clusters and got["backend"] == backend


def test_stochastic_simulate_keys_and_finite_values():
    for extra in ([], ["--device-traces"]):
        want, got = _both(["simulate", "--clusters", "4", "--days", DAY_48,
                           "--stochastic", *extra])
        assert set(got) == set(want)
        assert all(math.isfinite(v) for v in got.values()
                   if isinstance(v, float))


def test_simulate_ppo_stays_on_the_plain_rollout():
    """ppo over a fleet is the plain rollout under PPOBackend.action_fn
    (the MLP kernel computes the kernel's numerics instead); batch means
    at the flagship's standard, 1e-3."""
    want, got = _both(["--preset", "multiregion", "simulate", "--backend",
                       "ppo", "--clusters", "3", "--days", DAY_48])
    _close(got, want, 1e-3, atol=1e-5)


@pytest.mark.parametrize("lanes", [
    {"faults.enabled": "true", "faults.preempt_storm_hazard": "4",
     "faults.ice_frac": "0.2"},
    {"workloads.enabled": "true", "workloads.inference_rate_pods": "30"}],
    ids=["faults", "workloads"])
def test_simulate_scores_a_lane_stream_through_the_packed_entries(
        lanes, capsys):
    """A config whose stream carries lanes is synthesized packed, as the
    boards do, and scored by the packed entry (on the CPU its plain
    version with the lanes threaded through): the report is that entry's
    means. neutral goes through the same entry."""
    from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.types import SimParams

    sets = [a for k, v in lanes.items() for a in ("--set", f"{k}={v}")]
    argv = sets + ["simulate", "--clusters", "4", "--days", DAY_48,
                   "--seed", "2", *CPU]
    rc, out, _ = _run(tmain, argv)
    assert rc == 0
    cfg = cli._load_config(cli._build_parser().parse_args(argv))
    src = cli._source(cfg)
    stream = src.packed_trace_device(60, 2 + 7919, 4, device="cpu")
    assert stream.shape[1] > 8  # the lane block is there
    want = mk.megakernel_summary_from_packed(
        SimParams.from_config(cfg, device="cpu"),
        offpeak_action(cfg.cluster, "cpu"), peak_action(cfg.cluster, "cpu"),
        stream, 60, 2, stochastic=False)
    assert _json_out(out) == json.loads(json.dumps(
        cli.simulate_report(want, "rule", 4, float(DAY_48))))
    rc, out, _ = _run(tmain, sets + ["--preset", "default", "simulate",
                                     "--backend", "neutral", "--clusters",
                                     "4", "--days", DAY_48, *CPU])
    assert rc == 0 and math.isfinite(_json_out(out)["cost_usd"])


def test_simulate_refusals_match_jax(tmp_path):
    for argv in (["simulate", "--backend", "mpc", "--clusters", "2"],
                 ["simulate", "--device-traces"],
                 ["simulate", "--backend", "rule", "--forecaster",
                  "persistence"]):
        with pytest.raises(SystemExit) as jerr:
            _run(jmain, argv)
        with pytest.raises(SystemExit) as terr:
            _run(tmain, argv + CPU)
        assert str(terr.value) == str(jerr.value), argv


def test_simulate_profile_dir_writes_a_trace(tmp_path):
    rc, _, _ = _run(tmain, ["simulate", "--clusters", "2", "--days", "0.002",
                            "--profile-dir", str(tmp_path / "prof"), *CPU])
    assert rc == 0
    assert any(name.endswith(".json") for _d, _s, files in
               os.walk(tmp_path / "prof") for name in files)


# ---- the device rule


@pytest.mark.parametrize("backend", ("rule", "carbon", "neutral"))
def test_simulate_mesh_equals_simulate(backend):
    """``simulate --mesh`` (a one-shard mesh on the CPU, as on one card)
    prints what ``simulate`` prints; a single cluster refuses it, as JAX's
    command line does."""
    argv = ["--preset", "multiregion", "simulate", "--clusters", "16",
            "--days", "0.002", "--stochastic", "--backend", backend, *CPU]
    rc, want, _ = _run(tmain, argv)
    rc_m, got, _ = _run(tmain, [*argv, "--mesh"])
    assert rc == rc_m == 0 and got == want
    if backend == "rule":
        with pytest.raises(SystemExit, match="batch-path"):
            _run(tmain, ["simulate", "--mesh", *CPU])


def test_simulate_mesh_builds_a_backend_per_device(monkeypatch):
    """``simulate --mesh`` with a plain-rollout backend (ppo) on a
    two-shard mesh asks ``make_backend`` for each mesh device's action
    function (a backend's tensors live on one device) and prints what
    ``simulate`` prints, within 1e-5 relative: a shard's net sees half
    the rows, and a product's sums may group differently by batch
    size."""
    import ccka_tpu_torch.parallel as tpar

    argv = ["--preset", "multiregion", "simulate", "--clusters", "16",
            "--days", "0.002", "--stochastic", "--backend", "ppo", *CPU]
    rc, want, _ = _run(tmain, argv)
    made = []
    real = cli.make_backend

    def make_backend(*a, device=None, **kw):
        made.append(str(device))
        return real(*a, device=device, **kw)

    monkeypatch.setattr(cli, "make_backend", make_backend)
    mesh = tpar.make_mesh(devices=["cpu"] * 2)
    monkeypatch.setattr(tpar, "make_mesh", lambda cfg, device=None: mesh)
    rc_m, got, _ = _run(tmain, [*argv, "--mesh"])
    assert rc == rc_m == 0 and made == ["cpu", "cpu"]
    got, want = json.loads(got), json.loads(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert math.isclose(got[k], v, rel_tol=1e-5, abs_tol=1e-12), k
        else:
            assert got[k] == v, k


DEVICE_ARGV = {
    "observe": ["observe"], "simulate": ["simulate", "--clusters", "4"],
    "evaluate": ["evaluate", "--backends", "rule"],
    "train": ["train", "--checkpoint-dir", "x"],
    "forecast-eval": ["forecast-eval"], "chaos-eval": ["chaos-eval"],
    "scenario-eval": ["scenario-eval"],
    "distill-factory": ["distill-factory"],
    "capture": ["capture", "--out", "x.npz"],
    "run": ["run", "--ticks", "1"], "recover-eval": ["recover-eval"],
    "overload-eval": ["overload-eval", "--tenants", "2"],
    "fleet --service": ["fleet", "--service", "default"],
    "geo": ["geo", "--steps", "8"],
    "scenario-search": ["scenario-search", "--iters", "1", "--pop", "2"],
    "flywheel distill": ["flywheel", "distill", "--top-k", "1"],
}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="this host has a CUDA device")
@pytest.mark.parametrize("name", sorted(DEVICE_ARGV))
def test_torch_subcommands_refuse_the_cpu_unless_asked(name):
    with pytest.raises(SystemExit) as err:
        _run(tmain, DEVICE_ARGV[name])
    assert "--device cuda" in str(err.value)
    assert "no CUDA device" in str(err.value)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="this host has a CUDA device")
def test_python_dash_m_names_the_missing_device(tmp_path):
    env = {**os.environ, "PYTHONPATH": _ROOT}

    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m", "ccka_tpu_torch", *argv],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300)

    pre = run("preroll")
    assert pre.returncode == 1 and "[FAIL] torch-device" in pre.stdout
    sim = run("simulate", "--clusters", "4", "--days", "0.002")
    assert sim.returncode != 0 and "--device cuda" in sim.stderr
    assert run("preroll", "--device", "cpu").returncode == 0
    ok = run("simulate", "--clusters", "4", "--days", "0.002", "--device",
             "cpu")
    assert ok.returncode == 0 and json.loads(ok.stdout)["clusters"] == 4


# ---- the fleet, bare and behind the service layer


def test_fleet_reports_jax_s_keys():
    """`fleet` without --service: JAX's report keys, finite values, every
    dry-run apply through (the two frameworks sample other traces)."""
    argv = ["fleet", "--clusters", "8", "--ticks", "4"]
    want, got = _both(argv)
    assert set(got) == set(want)
    assert (got["clusters"], got["ticks"], got["applied_frac"]) == (8, 4,
                                                                   1.0)
    assert all(math.isfinite(v) for v in got.values())
    want, got = _both(["--preset", "multiregion", "fleet", "--clusters",
                       "4", "--ticks", "2", "--backend", "ppo"])
    assert set(got) == set(want) and got["applied_frac"] == 1.0


def test_fleet_service_refusals_are_jax_s():
    for argv, msg in (
            (["--service", "nope"], "unknown service preset"),
            (["--service", "default", "--profiles", "bogus"],
             "unknown tenant profiles"),
            (["--service", "default", "--obs", "nope"], "unknown obs preset"),
            (["--service", "off", "--obs", "default"], "ENABLED --service")):
        errs = []
        for main, extra in ((jmain, []), (tmain, CPU)):
            with pytest.raises(SystemExit, match=msg) as e:
                main(["fleet", "--clusters", "2", "--ticks", "1", *argv,
                      *extra])
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("argv", [
    ["fleet", "--service", "default", "--clusters", "2", "--ticks", "1"],
    ["overload-eval", "--tenants", "2", "--intensities", "off",
     "--slow-fracs", "0", "--policies", "rule", "--ticks", "4"]],
    ids=["fleet --service default", "overload-eval"])
def test_formerly_unported_commands_now_run(argv):
    """The two commands that exited 2 before the service layer was
    ported now run (their JAX comparisons: test_torch_service.py and
    test_torch_overload.py)."""
    rc, out, err = _run(tmain, argv + CPU)
    assert rc == 0, err[-2000:]
    assert "not ported" not in err and _json_out(out)


def test_scenario_search_mints_what_scenarios_lists_as_jax_does(tmp_path):
    """`scenario-search` on the CPU mints a document; `scenarios
    --minted-dir` lists it after the library in both packages alike, and
    a tampered copy exits naming the digest."""
    mint = tmp_path / "mint.json"
    rc, out, err = _run(tmain, ["scenario-search", "--iters", "1", "--pop",
                                "2", "--seed", "3", "--mint-out", str(mint),
                                *CPU])
    assert rc == 0, err[-2000:]
    doc = _json_out(out)
    assert json.loads(mint.read_text()) == doc
    assert doc["eval"]["backend"] == "cpu" and doc["evals"] == 2 + 1 + 4
    assert "# worst case: usd_per_slo_hour=" in err
    want, got = _both(["scenarios", "--minted-dir", str(mint)], [])
    assert got == want
    assert got["scenarios"][-1]["minted"]["params_digest"] == doc[
        "scenario"]["params_digest"]
    vals = json.loads(doc["scenario"]["params_json"])
    vals["batch_rate"] = [vals["batch_rate"][0] + 1.0]
    doc["scenario"]["params_json"] = json.dumps(vals, sort_keys=True,
                                                separators=(",", ":"))
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "m.json").write_text(json.dumps(doc))
    with pytest.raises(SystemExit, match="tampered"):
        _run(tmain, ["scenarios", "--minted-dir", str(bad)])


@pytest.mark.parametrize("argv", [
    ["--policy", "flagship"], ["--objective", "profit"],
    ["--intensity", "apocalyptic"], ["--bound", "bogus=0:1"],
    ["--bound", "storm_hazard"], ["--bound", "storm_hazard=a:b"]])
def test_scenario_search_refusals_are_jax_s(argv):
    """Unknown names and malformed bounds exit before any stream, with
    JAX's message."""
    errs = []
    for main, extra in ((jmain, []), (tmain, CPU)):
        with pytest.raises(SystemExit) as e:
            main(["scenario-search", *argv, *extra])
        errs.append(str(e.value))
    assert errs[0] == errs[1] and errs[0].startswith("ccka: ")


@pytest.mark.parametrize("flag", [["--obs", "default"],
                                  ["--incidents-out", "x.jsonl"],
                                  ["--decisions-out", "x.jsonl"]])
def test_fleet_obs_flags_refuse_without_the_service(flag):
    argv = ["fleet", "--clusters", "2", "--ticks", "1", *flag]
    for main, extra in ((jmain, []), (tmain, CPU)):
        with pytest.raises(SystemExit, match="ENABLED --service"):
            main(argv + extra)


# ---- geo: the Pareto scoreboard


@pytest.fixture
def geo_snapshots(monkeypatch):
    """Run geo tests without leaving a published geo snapshot behind in
    either package (other files hold the service's skip values)."""
    from ccka_tpu.regions import geo as jgeo
    from ccka_tpu_torch.regions import geo as tgeo

    monkeypatch.setattr(tgeo, "_GEO_SNAPSHOT", None)
    monkeypatch.setattr(jgeo, "_GEO_SNAPSHOT", None)


GEO_ARGV = ["--preset", "multiregion", "geo", "--steps", "16", "--batch",
            "2", "--scenarios", "spot-storm,calm"]


def test_geo_json_is_the_direct_suite(geo_snapshots):
    from ccka_tpu_torch.config import PRESETS
    from ccka_tpu_torch.regions.migrate import GEO_POLICIES
    from ccka_tpu_torch.regions.pareto import run_geo_suite

    rc, out, _ = _run(tmain, GEO_ARGV + ["--json"] + CPU)
    cfg = PRESETS["multiregion"]()
    want = run_geo_suite(scenarios=["spot-storm", "calm"],
                         policies=sorted(GEO_POLICIES),
                         zone_region_index=cfg.cluster.zone_region_index,
                         seed=0, steps=16, batch=2, dt_s=cfg.sim.dt_s,
                         device="cpu")
    assert rc == 0 and json.loads(out) == json.loads(json.dumps(want))


@pytest.mark.parametrize("flag,value", [("--scenarios", "nope"),
                                        ("--policies", "teleport")])
def test_geo_unknown_names_exit_as_jax_s(geo_snapshots, flag, value):
    argv = ["--preset", "multiregion", "geo", flag, value]
    with pytest.raises(SystemExit) as jerr:
        _run(jmain, argv)
    with pytest.raises(SystemExit) as terr:
        _run(tmain, argv + CPU)
    assert str(terr.value) == str(jerr.value)
    assert "unknown geo" in str(terr.value)


def test_geo_renders_as_jax_s(geo_snapshots, monkeypatch):
    """JAX's `_cmd_geo` and the port's render the port's record (the JAX
    suite swapped for it) to the same text on stdout and stderr."""
    import ccka_tpu.regions.pareto as jpareto

    rc, out, _ = _run(tmain, GEO_ARGV + ["--json"] + CPU)
    record = json.loads(out)
    monkeypatch.setattr(jpareto, "run_geo_suite", lambda **kw: record)
    jrc, jout, jerr = _run(jmain, GEO_ARGV)
    trc, tout, terr = _run(tmain, GEO_ARGV + CPU)
    assert rc == jrc == trc == 0
    assert tout == jout and terr == jerr
    assert "== spot-storm" in tout and "conservation residual" in tout
