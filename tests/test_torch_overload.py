"""The port's overload scoreboard against the JAX package's.

- the small grid's invariants (the cases of `tests/test_service.py`'s
  `TestOverloadScoreboard`): healthy tenants' paired $/SLO-hr ratio
  exactly 1.0, the null cell 1.0, the stressed cell shedding and opening
  breakers under injected chaos, latencies under the deadline;
- the record's keys equal JAX's on the same grid, cell by cell and row
  by row;
- every validation message equal to JAX's, word for word;
- `overload-eval` on a tiny grid exits 0, and unknown names are refused.
"""

from __future__ import annotations

import pytest

import ccka_tpu.config as jcfg
import ccka_tpu.harness.overload as jover
import ccka_tpu_torch.config as tcfg
from ccka_tpu_torch.harness.overload import overload_scoreboard
from test_torch_cli import CPU, _both, tmain

GRID = dict(policies=("rule",), tenants=(6,),
            intensities=("off", "severe"), slow_fracs=(0.0, 0.5), ticks=8,
            seed=5)


@pytest.fixture(scope="module")
def cfgs():
    o = {"sim.horizon_steps": 16}
    return (jcfg.default_config().with_overrides(**o),
            tcfg.default_config().with_overrides(**o))


@pytest.fixture(scope="module")
def board(cfgs):
    return overload_scoreboard(cfgs[1], device="cpu", **GRID)


def test_small_grid_invariants(board):
    inv = board["invariants"]
    assert inv["healthy_usd_ratio_max"] == 1.0
    assert inv["null_cell_ratio_max"] == 1.0
    # Latencies include real host time: one stray tick on a loaded
    # machine is allowed, as in the JAX package's own test.
    assert inv["deadline_violations_total"] <= 1
    cell = board["cells"]["n6/severe/slow0.5"]["rows"]["rule"]
    assert cell["healthy_bitwise_frac"] == 1.0
    assert cell["breaker_transitions"]["opened"] > 0
    assert cell["sheds_total"] > 0
    assert cell["latency_ms"]["p99"] < cell["latency_ms"]["max"] + 1
    assert board["cells"]["n6/severe/slow0.5"]["tick_deadline_ms"] \
        > cell["latency_ms"]["p99"]
    assert sum(cell["chaos_injected"][k] for k in
               ("timeouts", "transient_exits", "dropped", "rewrites")) > 0


def test_record_keys_equal_jax(cfgs, board):
    want = jover.overload_scoreboard(cfgs[0], **GRID)
    assert set(board) == set(want)
    assert set(board["cells"]) == set(want["cells"])
    assert set(board["invariants"]) == set(want["invariants"])
    for key, cell in want["cells"].items():
        mine = board["cells"][key]
        assert set(mine) == set(cell)
        assert {k: mine[k] for k in cell if k != "rows"} == \
            {k: v for k, v in cell.items() if k != "rows"}
        for p, row in cell["rows"].items():
            assert set(mine["rows"][p]) == set(row)
            assert set(mine["rows"][p]["latency_ms"]) == \
                set(row["latency_ms"])
    for k in ("engine", "service", "policies", "tenants", "cap_frac"):
        assert board[k] == want[k]
    assert want["invariants"]["healthy_usd_ratio_max"] == \
        board["invariants"]["healthy_usd_ratio_max"] == 1.0


@pytest.mark.parametrize("kw", [
    dict(intensities=("off", "nope"), policies=("rule",)),
    dict(slow_profile="nope", policies=("rule",)),
    dict(service_preset="nope", policies=("rule",)),
    dict(policies=("rule", "nope")),
    dict(service_preset="off", policies=("rule",)),
    dict(tenants=(), policies=("rule",)),
    dict(slow_fracs=(0.0, 1.0), policies=("rule",)),
    dict(tenants=(0,), policies=("rule",)),
    dict(cap_frac=0.0, policies=("rule",)),
    dict(ticks=3, policies=("rule",)),
    dict(policies=("flagship",), tenants=(2,), intensities=("off",),
         slow_fracs=(0.0,), ticks=4)],
    ids=["intensity", "profile", "preset", "policy", "off-gate",
         "empty-axis", "slow-frac", "tenants", "cap-frac", "ticks",
         "no-runnable-policy"])
def test_validation_messages_equal_jax(cfgs, kw):
    with pytest.raises(ValueError) as want:
        jover.overload_scoreboard(cfgs[0], **kw)
    with pytest.raises(ValueError) as got:
        overload_scoreboard(cfgs[1], device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_cli_overload_eval_small_board_and_refusals():
    """`overload-eval` on a tiny grid: JAX's record keys, the healthy
    ratio exactly 1.0; unknown names refused."""
    argv = ["overload-eval", "--tenants", "4", "--intensities", "off",
            "--slow-fracs", "0", "--policies", "rule", "--ticks", "4"]
    want, got = _both(argv)
    assert set(got) == set(want)
    assert got["cells"]["n4/off/slow0"]["rows"]["rule"][
        "healthy_usd_ratio_max"] == 1.0
    for argv, msg in ((["--intensities", "off,bogus"], "unknown chaos"),
                      (["--profile", "bogus"], "unknown tenant profile"),
                      (["--service", "bogus"], "unknown service preset"),
                      (["--policies", "rule,nope"], "unknown policies")):
        with pytest.raises(SystemExit, match=msg):
            tmain(["overload-eval", "--policies", "rule", "--ticks", "4",
                   *argv, *CPU])
