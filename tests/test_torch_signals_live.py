"""The port's signal plane against the JAX package's: the live clients and
`LiveSignalSource` over in-process HTTP (the fake backend of
`tests/test_http_integration.py`, localhost sockets only), the retry
budget, stale marking and the persistence forecast, the scrape fan-in,
the replay store both ways, and the per-tick views every source serves
(tick, forecast, history with its left padding).

Signals are host arithmetic in float32 on both sides: the per-tick
views and replayed windows must agree exactly; the synthetic traces,
assembled in torch and in numpy, within float32 rounding (rtol 1e-6)."""

from __future__ import annotations

import dataclasses
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.signals import live as jlive
from ccka_tpu.signals import replay as jreplay
from ccka_tpu.signals import transport as jtransport
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu_torch.signals import live, replay, transport
from ccka_tpu_torch.signals.base import ExogenousTrace, TraceMeta
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from test_http_integration import _FakeBackendHandler

RTOL = 1e-6
FIELDS = ExogenousTrace._fields


@pytest.fixture(scope="module")
def backend():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _FakeBackendHandler)
    server.requests = []  # type: ignore[attr-defined]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def _np(tr) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in zip(FIELDS, tr)}


def _same(a, b, rtol: float = 0.0):
    a, b = _np(a), _np(b)
    for k in FIELDS:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=0.0,
                                   err_msg=k)


def _cfgs(url: str, key: str = "test-key", **extra):
    over = {"signals.prometheus_url": url, "signals.opencost_url": url,
            "signals.carbon_url": url, "signals.carbon_api_key": key,
            **extra}
    return (jcfg.default_config().with_overrides(**over),
            tcfg.default_config().with_overrides(**over))


def test_clients_over_http_equal_the_reference(backend):
    _, url = backend
    for mod in (live, jlive):
        prom = mod.PrometheusClient(url)
        assert prom.query('sum(kube_pod_status_phase{phase="Running"})') \
            == [({}, 56.0)]
        labels, times, vals = prom.query_range("x", 0.0, 300.0, 30.0)[0]
        assert labels == {"phase": "Running"} and vals[0] == 10.0
        slo = mod.SLOMetricsClient(prom, namespace="nov-22").snapshot()
        assert slo == pytest.approx({"latency_p95_ms": 180.0, "rps": 240.0,
                                     "queue_depth": 4.0})
        oc = mod.OpenCostClient(url)
        assert oc.node_prices_hr() == {"node-a": 0.10, "node-b": 0.30}
        good = mod.CarbonIntensityClient(url, "test-key", "US-CAL-CISO",
                                         400.0)
        assert good.latest() == 123.0 + len("US-CAL-CISO") and good.last_ok
        bad = mod.CarbonIntensityClient(url, "wrong", "US-CAL-CISO", 400.0)
        assert bad.latest() == 400.0 and not bad.last_ok
        with pytest.raises(mod.SignalUnavailable, match="error response"):
            mod.PrometheusClient(url + "/error").query("up")
        with pytest.raises(mod.SignalUnavailable, match="non-JSON"):
            mod.PrometheusClient(url + "/nonjson").query("up")


def test_live_source_tick_trace_forecast_equal_the_reference(backend):
    _, url = backend
    cj, ct = _cfgs(url)
    js = jlive.LiveSignalSource(cj.cluster, cj.workload, cj.sim, cj.signals,
                                start_unix_s=9 * 3600.0)
    ts = live.LiveSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals,
                               start_unix_s=9 * 3600.0)
    for t in (0, 3):
        got = ts.tick(t, seed=2, device="cpu")
        _same(got, js.tick(t, seed=2), RTOL)
        assert got.demand_pods[0].tolist() == [5.0, 5.0]
        assert not ts.last_scrape_stale and not js.last_scrape_stale
    # The backfilled history and the persistence-of-anomaly forecast.
    _same(ts.trace(8, seed=2, device="cpu"), js.trace(8, seed=2), RTOL)
    _same(ts.history(5, 8, seed=2, device="cpu"), js.history(5, 8, seed=2),
          RTOL)
    fc = ts.forecast(4, 16, seed=2, device="cpu")
    _same(fc, js.forecast(4, 16, seed=2), RTOL)
    assert fc.steps == 16
    assert ts.slo_snapshot() == pytest.approx(js.slo_snapshot())


def test_unreachable_endpoints_mark_the_tick_stale():
    """Every family falls back to its prior and the tick is stale; the
    retries stay within the deadline (no sleep past it)."""
    cj, ct = _cfgs("http://127.0.0.1:1", **{
        "signals.request_timeout_s": 0.3, "signals.fetch_retries": 1,
        "signals.fetch_backoff_s": 0.01})
    js = jlive.LiveSignalSource(cj.cluster, cj.workload, cj.sim, cj.signals,
                                start_unix_s=0.0)
    ts = live.LiveSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals,
                               start_unix_s=0.0)
    t0 = time.monotonic()
    got = ts.tick(1, device="cpu")
    assert time.monotonic() - t0 < 10.0
    _same(got, js.tick(1), RTOL)
    assert ts.last_scrape_stale and js.last_scrape_stale
    np.testing.assert_allclose(got.carbon_g_kwh.numpy(),
                               ct.signals.carbon_default_g_kwh)


@pytest.mark.parametrize("retries,deadline", [(3, 10.0), (5, 0.5), (0, 1.0)])
def test_retrying_fetch_backoff_within_deadline(retries, deadline):
    """The same jittered backoff schedule as the reference, cut at the
    deadline, re-raising the last transport error."""
    def run(mod):
        clock = [0.0]
        sleeps, calls = [], []

        def fetch(url, headers):
            calls.append(url)
            raise OSError("connection refused")

        def sleep(s):
            sleeps.append(s)
            clock[0] += s

        rf = mod.RetryingFetch(fetch, retries=retries, backoff_s=0.2,
                               deadline_s=deadline, sleep=sleep,
                               clock=lambda: clock[0])
        with pytest.raises(OSError, match="refused"):
            rf("http://x", {})
        return sleeps, len(calls), clock[0]

    got, want = run(live), run(jlive)
    assert got == want
    assert got[2] <= deadline + 1e-12
    # Success after one failure costs exactly one sleep.
    n = [0]

    def flaky(url, headers):
        n[0] += 1
        if n[0] == 1:
            raise TimeoutError("slow")
        return b"ok"

    slept = []
    assert live.RetryingFetch(flaky, retries=2, sleep=slept.append)(
        "u", {}) == b"ok" and len(slept) == 1


def test_spot_feed_and_interruption_feed_parse_alike():
    hist = {"SpotPriceHistory": [
        {"AvailabilityZone": "us-east-2a", "SpotPrice": "0.031",
         "Timestamp": "2026-01-01T00:00:00Z"},
        {"AvailabilityZone": "us-east-2a", "SpotPrice": "0.035",
         "Timestamp": "2026-01-01T01:00:00Z"},
        {"AvailabilityZone": "us-east-2b", "SpotPrice": "junk"}]}
    import json

    def runner(argv):
        if argv[1] == "ec2":
            return 0, json.dumps(hist)
        if argv[2] == "receive-message":
            body = {"detail-type": "EC2 Spot Instance Interruption Warning",
                    "detail": {"instance-id": "i-1"}, "region": "us-east-2"}
            return 0, json.dumps({"Messages": [
                {"ReceiptHandle": "h", "Body": json.dumps(body)},
                {"ReceiptHandle": "g", "Body": "not json"}]})
        return 0, ""

    for mod in (live, jlive):
        assert mod.SpotPriceClient("us-east-2", "m5.large",
                                   runner=runner).latest_by_zone() == {
            "us-east-2a": 0.035}
        w = mod.SpotInterruptionFeed("q", region="us-east-2",
                                     runner=runner).poll()
        assert [(x.instance_id, x.action) for x in w] == [
            ("i-1", "terminate")]


def test_scrape_fan_in_matches_the_reference():
    """ok / failing / hung tenants: the same (ok, timed_out) per tenant,
    the hung one abandoned at the budget edge and failed fast after."""
    gate = threading.Event()

    def ok():
        return b"x"

    def bad():
        raise OSError("down")

    def hung():
        gate.wait(5.0)
        return b"late"

    out = {}
    for name, mod in (("t", transport), ("j", jtransport)):
        fan = mod.ScrapeFanIn([ok, bad, hung], workers=4)
        try:
            first = fan.fan_in([0, 1, 2], budget_s=0.2)
            again = fan.fan_in([2], budget_s=0.05)
            out[name] = (first, again, fan.stragglers(),
                         fan.completed_total, fan.failed_total,
                         fan.abandoned_total)
        finally:
            fan.close()
    gate.set()
    assert out["t"] == out["j"]
    assert out["t"][0] == {0: (True, False), 1: (False, False),
                           2: (False, True)}


def test_replay_npz_round_trips_both_ways(tmp_path):
    cfg = jcfg.default_config()
    jtr = JSource(cfg.cluster, cfg.workload, cfg.sim, cfg.signals).trace(
        64, seed=4)
    meta = TraceMeta("synthetic", 12.0, 30.0, ("a", "b", "c"), "d")
    jmeta = jreplay.TraceMeta("synthetic", 12.0, 30.0, ("a", "b", "c"), "d")
    # JAX writes, the port reads; the port writes, JAX reads.
    jreplay.save_trace(str(tmp_path / "j.npz"), jtr, jmeta)
    ttr, tmeta = replay.load_trace(str(tmp_path / "j.npz"))
    _same(ttr, jtr)
    assert dataclasses.astuple(tmeta) == dataclasses.astuple(meta)
    replay.save_trace(str(tmp_path / "t.npz"), ttr, tmeta)
    back, bmeta = jreplay.load_trace(str(tmp_path / "t.npz"))
    _same(back, jtr)
    assert (bmeta.source, bmeta.zones, bmeta.dt_s) == ("synthetic",
                                                       ("a", "b", "c"), 30.0)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    arrays = {k: v for k, v in _np(jtr).items()}
    _same(replay.trace_from_arrays(arrays, 30.0, ("a",))[0], jtr)


@pytest.mark.parametrize("offset", [0, 700, 5000])
def test_replay_source_from_file_equals_the_reference(offset):
    path = "data/replay_2day.npz"
    js = jreplay.ReplaySignalSource.from_file(path, offset_steps=offset)
    ts = replay.ReplaySignalSource.from_file(path, offset_steps=offset)
    assert dataclasses.astuple(ts.meta()) == dataclasses.astuple(js.meta())
    stored = ts._trace.steps
    for steps in (16, stored + 40):        # a slice and a tiled horizon
        _same(ts.trace(steps, device="cpu"), js.trace(steps))
    _same(ts.batch_trace(24, [0, 1, 9], device="cpu"),
          js.batch_trace(24, [0, 1, 9]))
    _same(ts.tick(33, device="cpu"), js.tick(33))
    _same(ts.forecast(30, 12, device="cpu"), js.forecast(30, 12))
    _same(ts.history(3, 10, device="cpu"), js.history(3, 10))
    # The device window samplers are ported (tests/test_torch_replay_
    # device.py holds them against the reference's windows).
    win = ts.batch_trace_device(8, torch.Generator(), 4, device="cpu")
    assert tuple(win.is_peak.shape) == (4, 8)


@pytest.mark.parametrize("preset", ["default", "multiregion"])
def test_synthetic_tick_forecast_history_equal_the_reference(preset):
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    js = JSource(cj.cluster, cj.workload, cj.sim, cj.signals,
                 start_unix_s=8 * 3600.0 + 58 * 60)
    ts = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals,
                               start_unix_s=8 * 3600.0 + 58 * 60)
    assert ts.supports_device_traces and not ts.last_scrape_stale
    for t in (0, 4, 200):                   # 200 grows the cache twice
        _same(ts.tick(t, seed=5, device="cpu"), js.tick(t, seed=5), RTOL)
    assert [float(ts.tick(t, seed=5, device="cpu").is_peak[0])
            for t in range(6)] == [0.0] * 4 + [1.0] * 2
    _same(ts.forecast(10, 32, seed=5, device="cpu"),
          js.forecast(10, 32, seed=5), RTOL)
    # History: full, then left-padded by repeating the first tick.
    _same(ts.history(40, 16, seed=5, device="cpu"),
          js.history(40, 16, seed=5), RTOL)
    h = ts.history(2, 8, seed=5, device="cpu")
    _same(h, js.history(2, 8, seed=5), RTOL)
    assert h.steps == 8 and torch.equal(h.demand_pods[0], h.demand_pods[5])
    # The cache serves the same numbers as the uncached batch path.
    full = ts.batch_trace(300, [5], device="cpu")
    _same(ts.trace(300, seed=5, device="cpu"),
          ExogenousTrace(*(x[0] for x in full)))


def test_make_signal_source_dispatch(tmp_path):
    ct = tcfg.default_config()
    assert isinstance(live.make_signal_source(
        ct.cluster, ct.workload, ct.sim, ct.signals), SyntheticSignalSource)
    rp = ct.with_overrides(**{"signals.backend": "replay",
                              "signals.replay_path": "data/replay_2day.npz"})
    assert isinstance(live.make_signal_source(
        rp.cluster, rp.workload, rp.sim, rp.signals),
        replay.ReplaySignalSource)
    from ccka_tpu_torch.config import ConfigError
    bad = ct.with_overrides(**{"signals.backend": "replay",
                               "signals.replay_path": str(tmp_path / "no")})
    with pytest.raises(ConfigError, match="cannot load replay"):
        live.make_signal_source(bad.cluster, bad.workload, bad.sim,
                                bad.signals)
