"""The device-time observatory of the port (`ccka_tpu_torch/obs/
costmodel.py`, `obs/bench_history.py`, the `perf`, `bench-diff` and
`scaling-curve` subcommands) against the JAX package's.

- The roofline arithmetic (`achieved_roofline_fraction`,
  `crosscheck_bytes` with its warning text) and `render_program_table`:
  equal to JAX's on one grid of inputs.
- `bench_history` and the two host-only subcommands: byte-identical
  JSON, CSV, stdout and exit codes on a temporary copy of the repo's
  records (`tests/conftest.py` appends to `data/lane_times.json`, so the
  copy takes the committed content) and on the synthetic records of
  `tests/test_perf_obs.py`.
- `attribute`: an analytic row, an "unavailable" row, a failing call
  that raises; `program_table`'s join with the mode's dispatches.
- `perf --device cpu --json`: its keys, occupancy sums, each mode's
  summary bitwise an unwatched run, the service's perf gauges fed by the
  published snapshot, JAX's unknown-mode message.
- `rollout_cost` at B = 32768 x T = 2880, stochastic, against the bound
  column of PERF.md's kernel table at its printed precision and against
  `chip_smoke.py::lane_bound` (and its rule bound) exactly; no bound and no fraction without a card's
  rates; a bandwidth reading above the card's stated rate raises.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess

import pytest
import torch

from ccka_tpu.cli import main as jmain
from ccka_tpu.obs import bench_history as jbh
from ccka_tpu.obs import costmodel as jcm
from ccka_tpu_torch import PRESETS
from ccka_tpu_torch.cli import main as tmain
from ccka_tpu_torch.obs import bench_history as tbh
from ccka_tpu_torch.obs import costmodel as tcm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = tcm.DEVICE_RATES["NVIDIA H100 80GB HBM3"]
B_MAIN, T_DAY = 32768, 2880


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(autouse=True)
def _clean_registry():
    """The program registry and the pipeline snapshot are process-wide:
    each test leaves them empty (a service test in the same worker reads
    the snapshot)."""
    tcm.clear_registry()
    yield
    tcm.clear_registry()


# ---- the roofline arithmetic and the table ---------------------------------


@pytest.mark.parametrize("seconds", (0.0, -1.0, 2e-3, 0.5))
def test_achieved_roofline_fraction_matches_jax(seconds):
    for nbytes in (None, 0.0, 3e9):
        for flops in (None, 0.0, 4e12):
            for peak in (None, 67e12):
                kw = dict(bytes_accessed=nbytes, bandwidth_bytes_per_s=2e12,
                          flops=flops, peak_flops_per_s=peak)
                assert (tcm.achieved_roofline_fraction(seconds, **kw)
                        == jcm.achieved_roofline_fraction(seconds, **kw))


@pytest.mark.parametrize("tolerance", (2.0, 4.0))
def test_crosscheck_bytes_matches_jax(tolerance):
    for hand in (0.0, 1e6, 3.3e9):
        for other in (None, 1e5, 1e6, 2.5e6, 1e10):
            msgs = {"jax": [], "port": []}
            want = jcm.crosscheck_bytes("megakernel.mode.rule", hand, other,
                                        tolerance=tolerance,
                                        warn=msgs["jax"].append)
            got = tcm.crosscheck_bytes("megakernel.mode.rule", hand, other,
                                       tolerance=tolerance,
                                       warn=msgs["port"].append)
            assert got == want and msgs["port"] == msgs["jax"]


def test_render_program_table_matches_jax():
    rows = []
    for i, (disp, flops, nbytes, peak, ach, analysis) in enumerate((
            (None, None, None, None, None, "unattributed"),
            (0, 12.5, 999, 1000, None, "unavailable"),
            (3, 4.2e12, 3.3e9, 8.1e10, 0.1875, "analytic"),
            (7, 1.5e9, 2.2e6, 5e3, 1.0, "xla"),
            (12, 7, 12345678, 1e15, 0.00004, "analytic"))):
        row = {"name": f"megakernel.mode.{i}" + "x" * (10 * i),
               "dispatches": disp, "compiles": 0, "flops": flops,
               "bytes_accessed": nbytes, "peak_memory_bytes": peak,
               "analysis": analysis}
        if ach is not None:
            row["achieved_roofline_fraction"] = ach
        rows.append(row)
    assert tcm.render_program_table(rows) == jcm.render_program_table(rows)
    assert tcm.render_program_table([]) == jcm.render_program_table([])


# ---- the bench history and its two subcommands -----------------------------


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A copy of the repo's records with the committed lane times."""
    root = tmp_path_factory.mktemp("records")
    for name in os.listdir(ROOT):
        if name.startswith(("BENCH_r", "MULTICHIP_r")) \
                and name.endswith(".json"):
            shutil.copy(os.path.join(ROOT, name), root / name)
    os.makedirs(root / "data")
    lanes = subprocess.run(["git", "show", "HEAD:data/lane_times.json"],
                           cwd=ROOT, capture_output=True, text=True)
    if lanes.returncode == 0:
        (root / "data" / "lane_times.json").write_text(lanes.stdout)
    else:  # a checkout without git history: the file as it stands
        shutil.copy(os.path.join(ROOT, "data", "lane_times.json"),
                    root / "data" / "lane_times.json")
    return str(root)


def test_bench_history_matches_jax(records, tmp_path):
    history = tbh.load_bench_history(records)
    assert json.dumps(history) == json.dumps(
        jbh.load_bench_history(records))
    assert history["records"] and history["lane"]
    assert (json.dumps(tbh.bench_diff(history, max_lane_slowdown=1.2,
                                      max_headline_drop=0.1))
            == json.dumps(jbh.bench_diff(jbh.load_bench_history(records),
                                         max_lane_slowdown=1.2,
                                         max_headline_drop=0.1)))
    curve = tbh.scaling_curve(records)
    assert json.dumps(curve) == json.dumps(jbh.scaling_curve(records))
    got = tbh.write_scaling_csv(curve, str(tmp_path / "port.csv"))
    want = jbh.write_scaling_csv(jbh.scaling_curve(records),
                                 str(tmp_path / "jax.csv"))
    with open(got, "rb") as g, open(want, "rb") as w:
        assert g.read() == w.read()


def _perf_records():
    from test_perf_obs import _good_perf_record

    bad_occ = _good_perf_record()
    bad_occ["modes"]["rule"]["occupancy"]["fractions"] = {
        "generation": 0.6, "kernel": 0.6, "host": 0.2}
    out_of_band = _good_perf_record()
    out_of_band["modes"]["plan"]["achieved_roofline_fraction"] = 1.6
    partial = _good_perf_record()
    del partial["modes"]["carbon"]
    no_bitwise = _good_perf_record()
    no_bitwise["observatory"]["bitwise_all"] = False
    low_imbalance = _good_perf_record()
    low_imbalance["mesh8"]["shard_imbalance"] = 0.8
    return {"good": json.dumps(_good_perf_record()),
            "bad occupancy": json.dumps(bad_occ),
            "fraction out of band": json.dumps(out_of_band),
            "partial": json.dumps(partial),
            "bitwise false": json.dumps(no_bitwise),
            "imbalance below one": json.dumps(low_imbalance),
            "unreadable": "{torn json"}


@pytest.mark.parametrize("name", sorted(_perf_records()))
def test_bench_diff_on_synthetic_records_matches_jax(name, tmp_path):
    (tmp_path / "BENCH_r90.json").write_text(_perf_records()[name])
    root = str(tmp_path)
    want = jbh.bench_diff(jbh.load_bench_history(root))
    got = tbh.bench_diff(tbh.load_bench_history(root))
    assert json.dumps(got) == json.dumps(want)
    assert got["ok"] == (name == "good")
    j = _run(jmain, ["bench-diff", "--root", root])
    t = _run(tmain, ["bench-diff", "--root", root])
    assert t == j and t[0] == (0 if name == "good" else 1)


@pytest.mark.parametrize("argv", (
    ["bench-diff"], ["bench-diff", "--history-only"],
    ["bench-diff", "--max-lane-slowdown", "1.01", "--max-headline-drop",
     "0.01"],
    ["scaling-curve", "--json"], ["scaling-curve"]),
    ids=" ".join)
def test_host_subcommands_match_jax(argv, records, tmp_path):
    extra = (["--out", str(tmp_path / "{}.csv")]
             if argv[0] == "scaling-curve" else [])
    runs = {}
    for who, main in (("jax", jmain), ("port", tmain)):
        runs[who] = _run(main, argv + ["--root", records]
                         + [a.format(who) for a in extra])
    (jrc, jout, jerr), (trc, tout, terr) = runs["jax"], runs["port"]
    assert trc == jrc and tout == jout
    assert terr == jerr.replace("jax.csv", "port.csv")
    if extra:
        assert ((tmp_path / "port.csv").read_bytes()
                == (tmp_path / "jax.csv").read_bytes())


@pytest.mark.parametrize("cmd", ("bench-diff", "scaling-curve"))
def test_host_subcommands_refuse_an_empty_root_as_jax(cmd, tmp_path):
    argv = [cmd, "--root", str(tmp_path / "nowhere"),
            *(["--out", str(tmp_path / "c.csv")]
              if cmd == "scaling-curve" else [])]
    with pytest.raises(SystemExit) as jerr:
        _run(jmain, argv)
    with pytest.raises(SystemExit) as terr:
        _run(tmain, argv)
    assert str(terr.value) == str(jerr.value)


# ---- attribution -----------------------------------------------------------


def test_attribute_rows():
    calls = []
    rec = tcm.attribute("test.analytic", lambda x, k=1: calls.append(k),
                        torch.zeros(4), k=2,
                        cost=tcm.Cost(flops=10, bytes_accessed=64))
    assert calls == [2]
    assert rec.to_dict() == {"name": "test.analytic", "flops": 10.0,
                             "bytes_accessed": 64.0,
                             "peak_memory_bytes": None,
                             "analysis": "analytic", "error": None}
    rec = tcm.attribute("test.uncounted", lambda: None)
    assert (rec.flops, rec.bytes_accessed, rec.analysis) == (
        None, None, "unavailable")
    assert tcm.registered("test.uncounted") is rec

    def broken():
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        tcm.attribute("test.broken", broken, cost=tcm.Cost(flops=1.0))
    assert tcm.registered("test.broken") is None
    names = [r["name"] for r in tcm.program_table()]
    assert {"test.analytic", "test.uncounted"} <= set(names)
    assert "test.broken" not in names


def test_program_table_joins_the_mode_dispatches():
    from ccka_tpu_torch.obs.compile import stats_for
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.types import SimParams

    cfg = PRESETS["default"]()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    stream = src.packed_trace_device(16, 7, 16, device="cpu")
    kfn = mk.packed_mode_summary_fn(SimParams.from_config(cfg, "cpu"),
                                    cfg.cluster, "rule", T=16,
                                    stochastic=False)
    before = stats_for("megakernel.mode.rule").calls
    kfn(stream, 0)
    kfn(stream, 1)
    cost = tcm.rollout_cost(cfg, "rule", 16, 16, stochastic=False)
    rec = tcm.attribute("megakernel.mode.rule", kfn, stream, 0, cost=cost)
    row = {r["name"]: r for r in tcm.program_table()}["megakernel.mode.rule"]
    assert row["dispatches"] - before == 3  # two calls and attribute's
    assert row["compiles"] == 0
    assert (row["flops"], row["bytes_accessed"], row["analysis"]) == (
        cost.flops, float(cost.bytes_accessed), "analytic")
    assert rec.peak_memory_bytes is None  # the CPU


# ---- perf ------------------------------------------------------------------


def test_perf_cpu_json(tmp_path):
    from ccka_tpu_torch import config as tcfg
    from ccka_tpu_torch.cli import perf_record
    from ccka_tpu_torch.harness.service import fleet_service_from_config
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.types import SimParams

    rc, out, _ = _run(tmain, ["perf", "--steps", "128", "--batch", "32",
                              "--modes", "rule,plan", "--repeats", "2",
                              "--device", "cpu", "--json"])
    assert rc == 0
    doc = json.loads(out)
    assert set(doc) == {"platform", "virtual", "device", "steps", "batch",
                        "bandwidth_bytes_per_s", "modes", "programs"}
    assert (doc["platform"], doc["virtual"], doc["steps"], doc["batch"]) \
        == ("cpu", True, 128, 32)
    for m in doc["modes"].values():
        assert set(m) == {"occupancy", "kernel_seconds",
                          "achieved_roofline_fraction"}
        assert m["occupancy"]["repeats"] == 2
        assert sum(m["occupancy"]["fractions"].values()) == pytest.approx(
            1.0, abs=2e-6)
        assert m["achieved_roofline_fraction"] is None  # no card rates
    rows = {r["name"]: r for r in doc["programs"]}
    cfg = PRESETS["default"]()
    for mode in ("rule", "plan"):
        row = rows[f"megakernel.mode.{mode}"]
        cost = tcm.rollout_cost(cfg, mode, 32, 128, stochastic=False,
                                plan_broadcast=True)
        assert row["dispatches"] >= 3 and row["analysis"] == "analytic"
        assert (row["flops"], row["bytes_accessed"]) == (
            cost.flops, float(cost.bytes_accessed))
    assert rows["perf.packed_generation"]["bytes_accessed"] \
        == 128 * 16 * 32 * 4

    # The observatory does not change results: each mode's measured
    # summary bitwise an unwatched run on the same stream and seed.
    summaries: dict = {}
    perf_record(cfg, ["rule", "plan"], steps=128, batch=32, repeats=2,
                device="cpu", summaries=summaries)
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    params = SimParams.from_config(cfg, "cpu")
    for mode, s in summaries.items():
        assert sum(s["ledger"].fractions().values()) == pytest.approx(
            1.0, abs=1e-12)
        stream = src.packed_trace_device(128, s["stream_seed"], 32,
                                         device="cpu")
        want = mk.packed_mode_summary(params, cfg.cluster, mode, stream,
                                      128, s["seed"], stochastic=False)
        assert all(torch.equal(a, b) for a, b in zip(s["summary"], want))

    # The snapshot (the first mode's rounded fractions, as JAX's probe
    # publishes them) feeds the service's perf gauges.
    snap = tcm.pipeline_snapshot()
    assert snap["occupancy"] == pytest.approx(
        summaries["rule"]["ledger"].fractions(), abs=5e-7)
    ct = cfg.with_overrides(**{"sim.horizon_steps": 16})
    svc = fleet_service_from_config(
        ct, RulePolicy(ct.cluster, device="cpu"), 2,
        service=tcfg.SERVICE_PRESETS["default"],
        obs=tcfg.ObsConfig(enabled=True, dump_dir=str(tmp_path / "d"),
                           incident_log_path=str(tmp_path / "i.jsonl")),
        horizon_ticks=8, device="cpu", log_fn=lambda _m: None)
    rep = svc.run(2)[-1]
    svc.close()
    assert rep.pipeline_occupancy == snap["occupancy"]
    assert rep.achieved_roofline_fraction is None
    assert rep.program_dispatches_total >= 6


def test_perf_refuses_an_unknown_mode_as_jax():
    with pytest.raises(SystemExit) as jerr:
        _run(jmain, ["perf", "--modes", "rule,quantum"])
    with pytest.raises(SystemExit) as terr:
        _run(tmain, ["perf", "--modes", "rule,quantum", "--device", "cpu"])
    assert str(terr.value) == str(jerr.value)
    assert "unknown perf mode(s) ['quantum']" in str(terr.value)


# ---- the count -------------------------------------------------------------


def _lane_flags(name: str) -> dict:
    """(faults, workloads) of a fault intensity, a workload scenario or
    "plain", as `chip_smoke.py::lane_bound` reads them."""
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    sc = WORKLOAD_SCENARIOS.get(name)
    return dict(faults=(sc is None and name != "plain")
                or bool(sc and sc.fault_preset), workloads=sc is not None)


@pytest.fixture(scope="module")
def smoke():
    """`chip_smoke.py` as a module (its main path runs only as a
    script)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def flagship():
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    backend, _ = load_flagship_backend(PRESETS["multiregion"](),
                                       device="cpu")
    return backend.params


# PERF.md's kernel table, bound column (B = 32768 x T = 2880, stochastic):
# row 1 on the default preset, the rest multiregion with the shipped
# flagship.
BOUNDS = {
    ("default", "rule", "plain"): ("2.4790", "operations"),
    ("multiregion", "carbon", "plain"): ("3.4115", "operations"),
    ("multiregion", "neural", "plain"): ("17.6292", "operations"),
    ("multiregion", "plan", "plain"): ("3.7195", "bytes"),
    ("multiregion", "rule", "severe"): ("3.4199", "operations"),
    ("multiregion", "carbon", "severe"): ("3.6988", "operations"),
    ("multiregion", "neural", "severe"): ("17.9166", "operations"),
    ("multiregion", "plan", "severe"): ("4.5083", "bytes"),
    ("multiregion", "rule", "flash-crowd"): ("3.4819", "operations"),
    ("multiregion", "carbon", "flash-crowd"): ("3.7213", "operations"),
    ("multiregion", "neural", "flash-crowd"): ("17.9391", "operations"),
    ("multiregion", "plan", "flash-crowd"): ("4.0575", "bytes"),
    ("multiregion", "rule", "mixed"): ("3.7298", "operations"),
    ("multiregion", "carbon", "mixed"): ("4.0087", "operations"),
    ("multiregion", "neural", "mixed"): ("18.2264", "operations"),
    ("multiregion", "plan", "mixed"): ("4.8463", "bytes"),
}


@pytest.mark.parametrize("preset,mode,stream", sorted(BOUNDS),
                         ids=["-".join(k) for k in sorted(BOUNDS)])
def test_rollout_cost_reproduces_the_kernel_table(preset, mode, stream,
                                                  flagship, smoke):
    cfg = PRESETS[preset]()
    net = flagship if mode == "neural" else None
    cost = tcm.rollout_cost(cfg, mode, B_MAIN, T_DAY, stochastic=True,
                            net_params=net, rates=H100,
                            **_lane_flags(stream))
    assert (f"{cost.bound_ms:.4f}", cost.bound_by) == BOUNDS[
        preset, mode, stream]
    # The script's count, the yardstick of the table, on the same inputs.
    policy = "mlp" if mode == "neural" else mode
    want = smoke.lane_bound(cfg, policy, stream, net, B=B_MAIN, T=T_DAY)
    got = (cost.bound_ms, cost.bound_by, cost.terms, cost.tick_ops)
    assert got == want
    if preset == "default":
        assert got[:3] == smoke.bound(
            smoke.rollout_bytes(cfg.cluster.n_zones, B_MAIN, T_DAY),
            {"tick": (cost.tick_ops * B_MAIN * T_DAY,
                      smoke.F32_UNFUSED_OPS_PER_S, "float32")})
    assert cost.set_by == ("hbm" if cost.bound_by == "bytes"
                           else "float32")
    assert cost.terms["bytes"] == pytest.approx(
        cost.bytes_accessed / 3.35e12 * 1e3, rel=1e-15)
    assert cost.flops == sum(ops for ops, _, _ in cost.op_terms.values())
    # Against its own bound a run at the bound is at fraction 1.
    assert cost.achieved_fraction(cost.bound_ms / 1e3) == pytest.approx(
        1.0, rel=1e-12)


def test_no_rates_no_bound(monkeypatch):
    cfg = PRESETS["default"]()
    cost = tcm.rollout_cost(cfg, "rule", 1024, 360, stochastic=True)
    assert cost.rates is None
    assert (cost.bound_ms, cost.bound_by, cost.terms, cost.set_by) == (
        None, None, None, None)
    assert cost.achieved_fraction(1e-3, 3e12) is None
    assert cost.flops > 0 and cost.bytes_accessed > 0
    assert tcm.device_rates("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert tcm.device_rates("cuda") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tcm.device_rates("cuda") is H100


def test_bandwidth_above_the_stated_rate_raises(monkeypatch):
    monkeypatch.setattr(tcm, "_BW_CACHE", {})
    monkeypatch.setattr(tcm, "device_rates", lambda dev: tcm.DeviceRates(
        hbm_bytes_per_s=1.0, f32_ops_per_s=1.0, bf16_tensor_ops_per_s=1.0))
    with pytest.raises(RuntimeError, match="above 1.05 x its stated"):
        tcm.measured_stream_bandwidth("cpu")
    assert tcm._BW_CACHE == {}
