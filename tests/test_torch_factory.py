"""The port's MPC-distillation data factory against the JAX package's.

One cell (default preset, the "mixed" scenario's workload lanes under the
"moderate" fault intensity, 8 pairs x 48 ticks in blocks of 24) runs in
JAX's `produce_cell` (interpret-mode kernels on the CPU). Its worlds (the
block-wise packed stream of ``key(seed)``, regenerated here) and its
plans go to the port's `produce_cell` through ``worlds=`` and
``plans=``; the spot interruption rate is 0, so JAX's deterministic
interpret kernels and the port's stochastic plain versions run the same
dynamics. Held: the dataset's shapes, rows and clip, the playback and
rule summaries of the streaming labels; and, with the port's own planner
on the same worlds, the plans at the objective level.

Tolerances: observations and returns within 1e-5 relative (float
rounding of two simulators; measured 2e-6 and 4e-6), targets (the
plans, clipped) exactly, summaries within 1e-5 relative (measured 2e-7).
The planner is held as `tests/test_torch_mpc.py` holds it: each pair's
objective within 3e-4 relative of the JAX plan's.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.train import factory as jfactory
from ccka_tpu.workloads.scenarios import resolve_scenarios as jresolve
from ccka_tpu_torch.sim.megakernel import unpack_exo
from ccka_tpu_torch.sim.rollout import initial_state
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train import factory, mpc
from ccka_tpu_torch.workloads.scenarios import resolve_scenarios

_RATE0 = {"sim.spot_interruption_rate_hr": 0.0}
CELL = dict(pairs=8, steps=48, block_T=24, t_chunk=24, iters=3, seed=5)
SCENARIO, INTENSITY = "mixed", "moderate"


@functools.cache
def _cells():
    """JAX's cell, its worlds, and the port's cell on those worlds and
    plans."""
    jc = jcfg.PRESETS["default"]().with_overrides(**_RATE0)
    tc = tcfg.PRESETS["default"]().with_overrides(**_RATE0)
    jscen = jresolve([SCENARIO])[SCENARIO]
    jcell = jfactory.produce_cell(jc, jscen, INTENSITY, **CELL)
    worlds = np.array(jfactory._cell_stream(
        jfactory._cell_source(jc, jscen, INTENSITY), steps=CELL["steps"],
        block_T=CELL["block_T"], t_chunk=CELL["t_chunk"],
        pairs=CELL["pairs"], key=jax.random.key(CELL["seed"])))
    scen = resolve_scenarios([SCENARIO])[SCENARIO]
    cell = factory.produce_cell(
        tc, scen, INTENSITY, worlds=torch.from_numpy(worlds),
        plans=torch.from_numpy(np.array(jcell.plan_latents)), device="cpu",
        **CELL)
    return tc, scen, jcell, cell, worlds


def test_cell_dataset_matches_jax():
    _, _, jcell, cell, worlds = _cells()
    n, T = CELL["pairs"], CELL["steps"]
    assert worlds.shape[1] == 40          # exo 16, faults 8, workloads 16
    for name in ("obs", "target", "returns"):
        want = np.asarray(getattr(jcell.dataset, name))
        got = getattr(cell.dataset, name).numpy()
        assert got.shape == want.shape and got.shape[0] == n * T
        if name == "target":
            np.testing.assert_array_equal(got, want)
            assert np.abs(got).max() <= factory._TARGET_CLIP
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert cell.report["dataset_rows"] == jcell.report["dataset_rows"]
    assert cell.report["b_block"] == jcell.report["b_block"] == 8


def test_cell_labels_match_jax():
    """The streaming playback of the plans and the paired rule column."""
    _, _, jcell, cell, _ = _cells()
    for jsum, tsum in ((jcell.teacher_summary, cell.teacher_summary),
                       (jcell.rule_summary, cell.rule_summary)):
        for f in tsum._fields:
            np.testing.assert_allclose(
                getattr(tsum, f).numpy(), np.asarray(getattr(jsum, f)),
                rtol=1e-5, atol=1e-6, err_msg=f)
    assert cell.report["playback"]["pipeline"] == "double-buffered"
    assert cell.report["playback"]["n_blocks"] == 2
    assert abs(factory._paired_usd_ratio(cell.teacher_summary,
                                         cell.rule_summary)
               - jfactory._paired_usd_ratio(jcell.teacher_summary,
                                            jcell.rule_summary)) <= 1e-5


def test_cell_planner_matches_jax_at_the_objective():
    """The port's planner on the same worlds: every pair's plan objective
    within 3e-4 relative of the JAX plan's, both under the port's
    objective."""
    tc, scen, jcell, _, worlds = _cells()
    own = factory.produce_cell(tc, scen, INTENSITY,
                               worlds=torch.from_numpy(worlds), device="cpu",
                               **CELL)
    params = SimParams.from_config(tc, device="cpu")
    traces = unpack_exo(torch.from_numpy(worlds), CELL["steps"],
                        tc.cluster.n_zones)

    def objective(plans):
        with torch.no_grad():
            return mpc.plan_objective(params, tc.cluster, tc.train,
                                      initial_state(tc, CELL["pairs"], "cpu"),
                                      traces, plans)

    got = objective(own.plan_latents)
    want = objective(torch.from_numpy(np.array(jcell.plan_latents)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4)


def test_names_seeds_and_lane_widths_match_jax():
    for kw in (dict(scenarios=["nope"], intensities=["off"], teacher="mpc"),
               dict(scenarios=["mixed"], intensities=["loud"],
                    teacher="mpc"),
               dict(scenarios=["mixed"], intensities=[], teacher="mpc"),
               dict(scenarios=["mixed"], intensities=["off"],
                    teacher="oracle")):
        with pytest.raises(ValueError) as got:
            factory.validate_factory_names(**kw)
        with pytest.raises(ValueError) as want:
            jfactory.validate_factory_names(**kw)
        assert str(got.value) == str(want.value)
    assert set(factory.validate_factory_names(
        scenarios=["mixed", "flash-crowd"], intensities=["off", "severe"],
        teacher="mpc-rh")) == {"mixed", "flash-crowd"}
    for pairs in (1, 6, 64, 96, 256):
        assert factory.resolve_b_block(pairs, None) == \
            jfactory.resolve_b_block(pairs, None)
    with pytest.raises(ValueError, match="divide"):
        factory.resolve_b_block(6, 4)
    assert factory.cell_seed(3, 2, 1) == jfactory.cell_seed(3, 2, 1)
    tc = tcfg.PRESETS["default"]()
    with pytest.raises(ValueError, match="teacher"):
        factory.produce_cell(tc, resolve_scenarios(["mixed"])["mixed"],
                             "off", teacher="oracle", device="cpu")
    from ccka_tpu_torch.config import ConfigError
    from ccka_tpu_torch.parallel import make_mesh

    with pytest.raises(ConfigError, match="not divisible by 4 data shards"):
        factory.produce_cell(tc, resolve_scenarios(["mixed"])["mixed"],
                             "off", pairs=6, mesh=make_mesh(
                                 devices=["cpu"] * 4), device="cpu")


def test_factory_run_distill_and_naive_rate():
    """The sweep's own draws at a small size: two cells concatenated,
    the report's columns, the receding-horizon teacher, distillation on
    the dataset and the naive per-pair baseline."""
    tc = tcfg.PRESETS["default"]()
    small = dict(pairs_per_cell=2, steps=16, block_T=16, t_chunk=16,
                 iters=2, seed=1)
    data, report, cells = factory.factory_run(
        tc, scenarios=["diurnal-inference"], intensities=["off", "mild"],
        teacher="mpc-rh", return_cells=True, with_ledger=True,
        device="cpu", **small)
    assert report["pairs_total"] == 4 and len(cells) == 2
    assert tuple(data.obs.shape) == (4 * 16, 29)
    assert "playback_occupancy" in report["cells"][0]
    assert [c.report["seed"] for c in cells] == [1, 101]
    assert all(np.isfinite(c["teacher_vs_rule_usd_per_slo_hour"])
               for c in report["cells"])
    params, hist, rep = factory.distill_from_factory(
        tc, scenarios=["diurnal-inference"], intensities=["off"],
        iterations=3, device="cpu", pairs_per_cell=2, steps=16, block_T=16,
        t_chunk=16, iters=1)
    assert set(params["params"]) >= {"Dense_0", "actor_mean", "critic"}
    assert rep["distill_iterations"] == 3 and np.isfinite(
        rep["final_actor_mse"])
    naive = factory.naive_lax_pair_rate(
        tc, resolve_scenarios(["diurnal-inference"])["diurnal-inference"],
        "off", pairs=1, steps=16, block_T=16, t_chunk=16, device="cpu")
    assert naive["pairs"] == 1 and naive["pairs_per_sec"] > 0
