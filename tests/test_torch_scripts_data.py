"""The port's replay-trace and zone-probe scripts against the JAX scripts.

`scripts/torch_make_replay_trace.py` draws the same PCG64 stream in the
same order as `scripts/make_replay_trace.py`: every variant's arrays are
bitwise the JAX script's and the committed store's, and its meta the JAX
script's. `scripts/torch_zone_spread_probe.py` is held to
`scripts/zone_spread_probe.py` on the same JAX-made held-out traces with
the world draws off (the frameworks' draws differ: threefry against
Philox): every unrounded number within 1e-4 relative, the verdicts and
the keys equal. The JAX scripts are imported from `scripts/` by path;
their module-level names (`heldout_traces`, `evaluate_backend`, `round`)
are monkeypatched, never edited.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu_torch.signals.base import ExogenousTrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each variant's seed, days and path in the JAX script.
JAX_NAMES = {"eval": ("SEED", "DAYS", "OUT"),
             "train": ("TRAIN_SEED", "TRAIN_DAYS", "OUT_TRAIN"),
             "eval5": ("EVAL5_SEED", "EVAL5_DAYS", "OUT_EVAL5"),
             "train9": ("TRAIN9_SEED", "TRAIN9_DAYS", "OUT_TRAIN9")}
PROBE_RTOL = 1e-4


def _chip_smoke():
    """`chip_smoke.py` as a module (its main path runs only as a script):
    its phase-21 helpers load the scripts and flatten their documents."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _chip_smoke()
load_script = _SMOKE.twin_script      # scripts/<name>.py as a module
json_leaves = _SMOKE.json_leaves      # {path: leaf} of a JSON document


@pytest.fixture(scope="module")
def traces_jax():
    return load_script("make_replay_trace")


@pytest.fixture(scope="module")
def traces_port():
    return load_script("torch_make_replay_trace")


def _meta(m) -> dict:
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("variant", JAX_NAMES)
def test_trace_twin_is_bitwise_jax_and_the_committed_store(
        variant, traces_jax, traces_port):
    seed, days, path = traces_port.VARIANTS[variant]
    assert (seed, days, path) == tuple(getattr(traces_jax, name)
                                       for name in JAX_NAMES[variant])
    got, gmeta = traces_port.build_trace(tcfg.default_config(), seed=seed,
                                         days=days)
    want, wmeta = traces_jax.build_trace(jcfg.default_config(), seed=seed,
                                         days=days)
    assert got.steps == int(days * 86400 / 30)
    with np.load(path) as stored:
        for field in ExogenousTrace._fields:
            g = getattr(got, field).numpy()
            w = np.asarray(getattr(want, field))
            assert g.dtype == w.dtype == stored[field].dtype == np.float32
            assert np.array_equal(g, w), field
            assert np.array_equal(g, stored[field]), field
        stored_meta = json.loads(bytes(stored["__meta__"]).decode())
    assert _meta(gmeta) == _meta(wmeta)
    # The committed 2-day store predates the script's present wording:
    # its arrays are reproduced, its description is older.
    mine = dict(_meta(gmeta), zones=list(gmeta.zones))
    if variant == "eval":
        assert stored_meta.pop("description").endswith("cloudy day 2")
        assert mine.pop("description").endswith("cloudy alt days")
    assert stored_meta == mine


def test_trace_twin_main_round_trips_through_both_loaders(tmp_path,
                                                          traces_port):
    from ccka_tpu.signals.replay import load_trace as jload
    from ccka_tpu_torch.signals.replay import load_trace

    out = str(tmp_path / "replay_2day.npz")
    assert traces_port.main(["--variant", "eval"], out=out) == 0
    want, wmeta = traces_port.build_trace(tcfg.default_config())
    got, gmeta = load_trace(out)
    jgot, jmeta = jload(out)
    for field in ExogenousTrace._fields:
        assert torch.equal(getattr(got, field), getattr(want, field))
        assert np.array_equal(np.asarray(getattr(jgot, field)),
                              getattr(want, field).numpy())
    assert _meta(gmeta) == _meta(wmeta) == _meta(jmeta)


# ---- the zone-spread probe


@pytest.fixture(scope="module")
def probe_jax():
    return load_script("zone_spread_probe")


@pytest.fixture(scope="module")
def probe_port():
    return load_script("torch_zone_spread_probe")


@pytest.mark.parametrize("zone", range(3))
def test_zone_pin_action_matches_jax(zone, probe_jax, probe_port):
    jc, tc = jcfg.default_config().cluster, tcfg.default_config().cluster
    want = probe_jax.zone_pin_action(jc, zone)
    got = probe_port.zone_pin_action(tc, zone, device="cpu")
    for field in got._fields:
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field))), field
    assert float(got.zone_weight[:, zone].min()) == 1.0
    assert float(got.zone_weight.sum()) == tc.n_pools


def test_run_probe_matches_jax_on_shared_traces(monkeypatch, probe_jax,
                                                probe_port):
    """Both probes on JAX's held-out traces (3 x 96 ticks), world draws
    off: every unrounded number within PROBE_RTOL relative, flags, keys
    and the verdict equal."""
    from ccka_tpu.signals.synthetic import SyntheticSignalSource
    from ccka_tpu.train.evaluate import evaluate_backend as jeval
    from ccka_tpu.train.evaluate import heldout_traces as jheld
    from ccka_tpu_torch.train.evaluate import evaluate_backend as teval

    cfg = jcfg.default_config()
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    jtraces = jheld(src, steps=96, n=3, seed0=10_000)
    monkeypatch.setattr(probe_jax, "heldout_traces", lambda *a, **k: jtraces)
    monkeypatch.setattr(probe_jax, "evaluate_backend",
                        functools.partial(jeval, stochastic=False))
    monkeypatch.setattr(probe_jax, "round", lambda x, nd=None: x,
                        raising=False)
    monkeypatch.setattr(probe_port, "evaluate_backend",
                        functools.partial(teval, stochastic=False))
    want = probe_jax.run_probe(96, 3, 10_000)
    shared = ExogenousTrace(*(torch.as_tensor(np.stack(
        [np.asarray(getattr(tr, f)) for tr in jtraces]))
        for f in ExogenousTrace._fields))
    got = probe_port.run_probe(96, 3, 10_000, device="cpu", traces=shared,
                               digits=None)
    g, w = json_leaves(got), json_leaves(want)
    assert set(g) == set(w)
    for path, wv in w.items():
        if isinstance(wv, (bool, str)) or not isinstance(wv, (int, float)):
            assert g[path] == wv, path
        else:
            assert abs(g[path] - wv) <= PROBE_RTOL * abs(wv), (path, g[path],
                                                               wv)
    assert got["probes"].keys() == {"neutral", "carbon", "pin:us-east-2a",
                                    "pin:us-east-2b", "pin:us-east-2c"}
    # Rounded, the record carries the committed artifact's keys (its
    # lists hold 5 traces, these 3).
    with open(os.path.join(ROOT, "data", "zone_spread_probe.json")) as fh:
        committed = json.load(fh)
    rounded = probe_port.run_probe(96, 3, 10_000, device="cpu",
                                   traces=shared)
    keys = lambda d: {re.sub(r"\[\d+\]", "[]", k)  # noqa: E731
                      for k in json_leaves(d)}
    assert keys(rounded) == keys(committed) == keys(got)
    assert rounded["probes"]["carbon"]["co2_ratio"] == round(
        got["probes"]["carbon"]["co2_ratio"], 4)


def test_probe_main_writes_the_artifact(tmp_path, capsys, probe_port):
    out = tmp_path / "probe" / "zone_spread_probe.json"
    assert probe_port.main(["--steps", "8", "--traces", "2", "--out",
                            str(out), "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == doc
    assert (doc["eval_steps"], doc["n_traces"], doc["seed0"]) == (8, 2,
                                                                  10_000)
    assert isinstance(doc["any_probe_monetizes_carbon"], bool)
    assert len(doc["probes"]["neutral"]["co2_ratio_per_trace"]) == 2
