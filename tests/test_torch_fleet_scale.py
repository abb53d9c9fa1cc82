"""The port's fleet-scale record and chunked dispatch against the JAX
package's.

- chunked tenant-axis dispatch (one k-tenant tick replayed for every
  chunk, reading its rows of the resident stream through a row offset)
  is bitwise the unchunked tick on the deterministic clock — reports,
  patch streams, held rows, ledgers — at N = 64 in chunks of 16, and
  reads the stream in place (no chunk copies its rows);
- the scrape fan-in's deadline-abandon contract against a real hung
  socket (`signals/transport.ScrapeFanIn`), the cases of
  `tests/test_fleet_scale.py`;
- `fleet_scale_record` at a tiny sweep: its keys equal JAX's, its gates
  hold (vectorized bitwise object, chunked bitwise unchunked, healthy
  ratio exactly 1.0), and its validation messages are JAX's.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time

import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.harness.fleetscale as jfs
import ccka_tpu_torch.config as tcfg
from ccka_tpu_torch.harness import fleetscale as fs
from ccka_tpu_torch.harness.service import exo_rows
from ccka_tpu_torch.policy.rule import RulePolicy

# One fleet size for the sweep, the parity gates and the speedup pair:
# the JAX record then compiles two programs (N = 4 and its chunk).
TINY = dict(tenants=(4,), ticks=4, parity_n=4, chunk_parity_n=4,
            speedup_n=4, seed=211)


@pytest.fixture(scope="module")
def cfgs():
    o = {"sim.horizon_steps": 16}
    return (jcfg.default_config().with_overrides(**o),
            tcfg.default_config().with_overrides(**o))


def test_chunked_bitwise_unchunked_at_n64(cfgs):
    ct = cfgs[1]
    n = 64
    svc = dataclasses.replace(tcfg.SERVICE_PRESETS["default"],
                              admission_queue_cap=n - 8)
    profiles = ["healthy"] * 56 + ["slow", "flaky", "batch", "jittery"] * 2
    res = fs._run_paired(
        ct, RulePolicy(ct.cluster, device="cpu"), n, profiles, svc,
        ticks=6, seed=211, horizon=8,
        variants={"chunked": ("vectorized", 16),
                  "unchunked": ("vectorized", None)}, device="cpu")
    assert res["bitwise_identical"], res["mismatches"]
    assert res["variants"]["chunked"]["dispatch_chunk"] == 16


def test_exo_rows_reads_the_stream_in_place():
    """A chunk's exo rows are the unchunked slice's, gathered from the
    [N*T, ...] view of the resident stream (no copy of the stream)."""
    from ccka_tpu_torch.harness.fleet import exo_at
    from ccka_tpu_torch.sim.dynamics import ExoStep

    g = torch.Generator().manual_seed(0)
    xs = ExoStep(*(torch.rand(shape, generator=g) for shape in
                   ((12, 5, 3), (12, 5, 3), (12, 5, 3), (12, 5, 2),
                    (12, 5))))
    rows = torch.arange(4)
    for t in (0, 3, 7):
        whole = exo_at(xs, torch.tensor(t), 5)
        for row0 in (0, 4, 8):
            part = exo_rows(xs, torch.tensor(t), torch.tensor(row0), rows,
                            5)
            for a, b in zip(part, whole):
                assert torch.equal(a, b[row0:row0 + 4])
    for x in xs:
        assert x.view(-1, *x.shape[2:]).data_ptr() == x.data_ptr()


def test_fleet_scale_record_keys_equal_jax_and_gates_hold(cfgs):
    rec = fs.fleet_scale_record(cfgs[1], device="cpu", **TINY)
    want = jfs.fleet_scale_record(cfgs[0], **TINY)
    assert set(rec) == set(want)
    assert set(rec["cells"]) == set(want["cells"])
    for k, cell in want["cells"].items():
        assert set(rec["cells"][k]) == set(cell)
    for k in ("parity", "chunk_parity", "speedup", "invariants"):
        assert set(rec[k]) == set(want[k])
    for k in ("sweep_n", "scenarios", "dispatch_chunk", "ticks_per_run"):
        assert rec[k] == want[k]
    inv = rec["invariants"]
    assert inv["parity_bitwise"] and inv["chunk_parity_bitwise"]
    assert inv["healthy_ratio_exact_all"] and \
        inv["healthy_usd_ratio_max"] == 1.0
    assert rec["speedup"]["ratio"] > 0


@pytest.mark.parametrize("kw", [
    dict(intensity="nope"), dict(slow_profile="nope"),
    dict(service_preset="off"), dict(slow_frac=1.0), dict(cap_frac=0.0),
    dict(ticks=3), dict(parity_n=65), dict(tenants=(1, 4096)),
    dict(speedup_n=5)],
    ids=["intensity", "profile", "preset", "slow-frac", "cap-frac",
         "ticks", "parity-n", "tenants", "speedup-n"])
def test_validation_messages_equal_jax(cfgs, kw):
    with pytest.raises(ValueError) as want:
        jfs.fleet_scale_record(cfgs[0], **kw)
    with pytest.raises(ValueError) as got:
        fs.fleet_scale_record(cfgs[1], device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_chunk_constants_are_jax_s():
    assert (fs._CHUNK, fs._CHUNK_FROM) == (jfs._CHUNK, jfs._CHUNK_FROM)


# ---- the scrape fan-in's deadline-abandon contract --------------------------


@pytest.fixture()
def hung_server():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    conns = []
    stop = threading.Event()

    def accept_loop():
        srv.settimeout(0.1)
        while not stop.is_set():
            try:
                c, _ = srv.accept()
                conns.append(c)     # hold open, never respond
            except OSError:
                continue

    th = threading.Thread(target=accept_loop, daemon=True)
    th.start()
    yield port
    stop.set()
    th.join(timeout=2)
    for c in conns:
        c.close()
    srv.close()


def _hung_fetch(port, socket_timeout_s):
    def fetch():
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=socket_timeout_s) as s:
            s.settimeout(socket_timeout_s)
            s.sendall(b"GET /metrics\r\n")
            return s.recv(1024)     # never arrives
    return fetch


def test_hung_socket_abandoned_at_budget_edge_never_awaited(hung_server):
    from ccka_tpu_torch.signals.transport import ScrapeFanIn

    fan = ScrapeFanIn([_hung_fetch(hung_server, socket_timeout_s=1.5),
                       lambda: b"ok"], workers=4)
    try:
        t0 = time.monotonic()
        res = fan.fan_in([0, 1], budget_s=0.25)
        took = time.monotonic() - t0
        assert res[1] == (True, False)
        assert res[0] == (False, True)
        assert took < 1.0
        assert fan.abandoned_total == 1
        assert fan.stragglers() == [0]
        t0 = time.monotonic()
        assert fan.scrape(0, budget_s=5.0) == (False, True)
        assert time.monotonic() - t0 < 0.5
        deadline = time.monotonic() + 4.0
        while fan.stragglers() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert fan.stragglers() == []
    finally:
        fan.close()


def test_service_fans_in_through_a_transport(cfgs):
    """A service given a transport scrapes every ready tenant through it
    at once, each bounded by the scrape budget: a hung tenant times out
    and is counted, the rest are admitted."""
    from ccka_tpu_torch.harness.service import fleet_service_from_config
    from ccka_tpu_torch.signals.transport import http_scrape_fan_in

    ct = cfgs[1]
    calls = []

    def fetch(url, headers):
        calls.append(url)
        if url.endswith("/3"):
            time.sleep(0.5)     # past the 100 ms scrape budget
        return b"x"

    fan = http_scrape_fan_in([f"http://t/{i}" for i in range(4)],
                             fetch=fetch)
    svc = fleet_service_from_config(
        ct, RulePolicy(ct.cluster, device="cpu"), 4,
        service=tcfg.SERVICE_PRESETS["default"], horizon_ticks=8, seed=1,
        transport=fan, device="cpu")
    try:
        rep = svc.tick(0)
        assert rep.admitted == 3 and rep.scrape_failed == 1
        assert svc.scrape_timeouts_total == 1
        assert sorted(set(calls)) == [f"http://t/{i}" for i in range(4)]
    finally:
        svc.close()
        fan.close()
