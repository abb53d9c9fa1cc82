"""The port's scoring boards through its command line against the JAX
package's: ``chaos-eval`` and ``scenario-eval`` at
`tests/test_torch_fault_board.py`'s standard on JAX's own streams, the
scenario listing byte for byte, the refusals word for word. Helpers and
the standards of the other subcommands: `tests/test_torch_cli.py`."""

from __future__ import annotations

import pytest

import ccka_tpu.config as jcfg
from ccka_tpu.cli import main as jmain
from ccka_tpu_torch.cli import main as tmain
from test_torch_cli import CPU, _json_out, _run


def _boards(monkeypatch, argv, rows_of):
    from test_torch_fault_board import assert_close, use_jax_streams

    rc, jout, _ = _run(jmain, argv)
    assert rc == 0
    use_jax_streams(monkeypatch, jcfg.PRESETS["multiregion"]())
    rc, tout, _ = _run(tmain, argv + CPU)
    assert rc == 0
    want, got = _json_out(jout), _json_out(tout)
    assert got["stochastic"] is False and got["policies"] == want["policies"]
    worst = 0.0
    for name, wboard in want[rows_of].items():
        gboard = got[rows_of][name]
        assert list(gboard["rows"]) == list(wboard["rows"])
        for p, row in wboard["rows"].items():
            assert set(gboard["rows"][p]) == set(row), (name, p)
            for k, v in row.items():
                worst = max(worst, assert_close(gboard["rows"][p][k], v,
                                                f"{name} {p} {k}", p, k))
    return want, got, worst


def test_chaos_eval_matches_jax_on_its_streams(monkeypatch):
    want, got, _ = _boards(monkeypatch, [
        "--preset", "multiregion", "chaos-eval", "--policies",
        "rule,carbon,flagship", "--intensities", "off,severe", "--traces",
        "8", "--steps", "32"], "intensities")
    assert got["degradation_curves"].keys() == \
        want["degradation_curves"].keys()
    assert got["degradation_curves"]["rule"][
        "vs_calm_usd_per_slo_hour"][-1] > 1.0


def test_scenario_eval_matches_jax_on_its_streams(monkeypatch):
    _boards(monkeypatch, [
        "--preset", "multiregion", "scenario-eval", "--policies",
        "rule,carbon,flagship", "--scenarios", "mixed",
        "--traces", "8", "--steps", "32"], "scenarios")


def test_board_refusals_match_jax():
    for argv in (["chaos-eval", "--intensities", "mild"],
                 ["chaos-eval", "--policies", "oracle"],
                 ["scenario-eval", "--scenarios", "nope"]):
        with pytest.raises(SystemExit) as jerr:
            _run(jmain, argv)
        with pytest.raises(SystemExit) as terr:
            _run(tmain, argv + CPU)
        assert str(terr.value).split(";")[0] == \
            str(jerr.value).split(";")[0], argv


def test_scenarios_listing_matches_jax():
    assert _run(tmain, ["scenarios"]) == _run(jmain, ["scenarios"])


