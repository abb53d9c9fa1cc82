"""ccka_tpu_torch foundations against the JAX package: config presets,
SimParams, the synthetic signal world, the Philox stream, the bridge, the
device rule, and the port's independence from JAX."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch
import ccka_tpu_torch.config as tcfg
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu_torch import bridge
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy, offpeak_action, peak_action
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim import random as prandom
from ccka_tpu_torch.sim.rollout import initial_state
from ccka_tpu_torch.sim.types import Action, SimParams
from ccka_tpu_torch.train.flagship import load_flagship_backend
from ccka_tpu_torch.train.ppo import PPOBackend

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET_NAMES = ("default", "multiregion")


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_presets_equal_field_by_field(preset):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert (tcfg._asdict(tcfg.PRESETS[preset]())
            == jcfg._asdict(jcfg.PRESETS[preset]()))


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_sim_params_equal_field_by_field(preset):
    want = _np(JSimParams.from_config(jcfg.PRESETS[preset]()))
    got = SimParams.from_config(tcfg.PRESETS[preset](), device="cpu")
    assert list(got._fields) == list(want)
    for f, w in want.items():
        g = getattr(got, f)
        if isinstance(g, int):
            assert g == int(w), f
        else:
            assert g.dtype == torch.float32, f
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def _sources(preset):
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    return (JSource(jc.cluster, jc.workload, jc.sim, jc.signals),
            SyntheticSignalSource(tc.cluster, tc.workload, tc.sim,
                                  tc.signals))


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_assemble_matches_jax_batch_trace(preset):
    """Same numpy noise on both sides (bitwise: the port's `_noise` is a
    copy), so the assembled traces agree to float32 rounding."""
    jsrc, tsrc = _sources(preset)
    for s in (0, 5):
        for a, b in zip(jsrc._noise(300, s), tsrc._noise(300, s)):
            np.testing.assert_array_equal(a, b)
    want = _np(jsrc.batch_trace(300, range(6)))
    got = tsrc.batch_trace(300, range(6), device="cpu")
    for f, w in want.items():
        g = getattr(got, f).numpy()
        assert g.shape == w.shape, f
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f)


def test_batch_trace_device_sanity_anchors():
    """The device generator's world: spot $/hr within [20 %, 95 %] of the
    0.096 on-demand price, carbon around the 400 g/kWh default, demand
    peaking near the 60-70 pod burst scale, peak hours half the day."""
    _, tsrc = _sources("default")
    g = torch.Generator().manual_seed(0)
    tr = tsrc.batch_trace_device(2880, g, 32, device="cpu")
    assert tuple(tr.spot_price_hr.shape) == (32, 2880, 3)
    spot = tr.spot_price_hr
    assert 0.0192 - 1e-7 <= spot.min() and spot.max() <= 0.0912 + 1e-7
    assert 0.02 <= spot.mean() <= 0.09
    assert torch.all(tr.od_price_hr == np.float32(0.096))
    assert 300 <= tr.carbon_g_kwh.mean() <= 500
    q = torch.quantile(tr.carbon_g_kwh.flatten()[:100000],
                       torch.tensor([0.01, 0.99]))
    assert 150 <= q[0] and q[1] <= 650
    peak_demand = tr.demand_pods.sum(-1).amax(1)
    assert 55 <= peak_demand.median() <= 80
    assert tr.is_peak.mean() == 0.5
    # A second generator on the same seed draws the same world.
    again = tsrc.batch_trace_device(
        2880, torch.Generator().manual_seed(0), 32, device="cpu")
    assert torch.equal(again.carbon_g_kwh, tr.carbon_g_kwh)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    got = prandom.philox4x32(counter, key)
    assert tuple(int(w) for w in got) == want


def test_philox_draws_do_not_depend_on_blocking():
    """Addressed by (seed, global cluster, global tick, row): a batch taken
    whole equals the same batch taken in cluster blocks and time chunks."""
    seed = 2**33 + 17
    whole = prandom.uniform_grid(seed, 96, 0, 40, 6, "cpu")
    blocks = torch.cat([
        torch.cat([prandom.uniforms(
            seed, torch.arange(b0, b0 + 32)[None, None, :],
            torch.arange(t0, t0 + 8)[:, None, None],
            torch.arange(6)[None, :, None]) for b0 in (0, 32, 64)], dim=3)
        for t0 in range(0, 40, 8)], dim=1)
    assert torch.equal(whole, blocks)
    assert 0.0 < whole.min() and whole.max() < 1.0
    assert abs(whole.mean().item() - 0.5) < 0.01
    # Words 0..2 of one call are distinct streams.
    assert not torch.equal(whole[0], whole[1])
    with pytest.raises(ValueError):
        prandom.seed_key(-1)


def test_bridge_carries_jax_tuples_across():
    from ccka_tpu.policy.rule import offpeak_action as joff

    cfg = jcfg.default_config()
    p = bridge.sim_params(_np(JSimParams.from_config(cfg)), device="cpu")
    assert isinstance(p.provision_pipeline_k, int)
    assert p.provision_pipeline_k == cfg.sim.provision_delay_steps
    a = bridge.action(_np(joff(cfg.cluster)), device="cpu")
    want = offpeak_action(tcfg.default_config().cluster, device="cpu")
    for x, y in zip(a, want):
        assert torch.equal(x, y)
    jsrc, _ = _sources("default")
    tr = bridge.trace(_np(jsrc.batch_trace(8, range(2))), device="cpu")
    assert tuple(tr.is_peak.shape) == (2, 8)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from ccka_tpu_torch.train.cem import cem_refine
    from ccka_tpu_torch.train.factory import produce_cell
    from ccka_tpu_torch.train.flagship import train_flagship
    from ccka_tpu_torch.train.imitate import imitate
    from ccka_tpu_torch.train.ppo import PPOTrainer

    cfg = tcfg.default_config()
    _, src = _sources("default")
    calls = [
        lambda: ccka_tpu_torch.resolve_device(),
        lambda: ccka_tpu_torch.resolve_device("cuda"),
        lambda: SimParams.from_config(cfg),
        lambda: Action.neutral(2, 3),
        lambda: offpeak_action(cfg.cluster),
        lambda: peak_action(cfg.cluster),
        lambda: RulePolicy(cfg.cluster),
        lambda: initial_state(cfg, 4),
        lambda: src.batch_trace(8, [0]),
        lambda: src.batch_trace_device(8, torch.Generator(), 4),
        lambda: bridge.sim_params({}),
        lambda: CarbonAwarePolicy(cfg.cluster),
        lambda: PPOBackend(cfg, {"params": {}}),
        lambda: PPOTrainer(cfg),
        lambda: imitate(cfg, None, None),
        lambda: cem_refine(cfg, {}, None),
        lambda: produce_cell(cfg, None, "off"),
        lambda: train_flagship(cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # The kernel path raises too, rather than running on the CPU.
    params = SimParams.from_config(cfg, device="cpu")
    tr = src.batch_trace(8, range(2), device="cpu")
    off, peak = offpeak_action(cfg.cluster, "cpu"), peak_action(cfg.cluster,
                                                                "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mk.megakernel_rollout_summary(params, off, peak, tr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mk.carbon_megakernel_rollout_summary(params, off, peak, tr)
    net = load_flagship_backend(cfg, variant="replay", device="cpu")[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mk.neural_megakernel_rollout_summary(params, cfg.cluster, net.params,
                                             tr)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_flagship_backend(cfg, variant="replay")


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    assert ccka_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    cfg = tcfg.default_config()
    state = initial_state(cfg, 4, device="cpu")
    assert state.nodes.device.type == "cpu"
    assert tuple(state.pipeline.shape) == (4, 3, 2, 3, 2)


_BLOCKER = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax", "ccka_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(name + " blocked: ccka_tpu_torch must not "
                              "import it")
        return None

sys.meta_path.insert(0, Blocker())
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]

import ccka_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ccka_tpu_torch.__path__,
                                                "ccka_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for want in ("kernels.build", "policy.carbon", "models.nets", "bridge",
             "train.checkpoint", "train.ppo", "train.flagship", "sim.lanes",
             "faults.types", "faults.process", "faults.scoreboard",
             "workloads.types", "workloads.process", "workloads.scenarios",
             "workloads.scoreboard", "train.objective", "train.mpc",
             "train.evaluate", "forecast.base", "forecast.backends",
             "forecast.metrics", "sim.streaming", "obs.trace",
             "obs.occupancy", "obs.runlog", "train.optim", "train.imitate",
             "train.cem", "train.factory", "obs.compile",
             "harness.telemetry", "harness.snapshot", "harness.promexport",
             "harness.lifecycle", "harness.controller", "harness.recovery",
             "signals.replay", "signals.live", "signals.transport",
             "actuation.patches", "actuation.sink", "actuation.reconcile",
             "actuation.chaos", "actuation.guardrails",
             "actuation.bootstrap", "actuation.burst", "harness.preroll",
             "harness.watch", "harness.dashboard", "harness.pipeline",
             "harness.fleet", "obs.recorder", "obs.incidents",
             "obs.decisions", "obs.tournament", "graphs", "cli",
             "__main__", "obs.burnrate", "obs.costmodel", "harness.service",
             "harness.overload", "harness.fleetscale", "regions",
             "regions.process", "regions.migrate", "regions.geo",
             "regions.pareto", "search", "search.params", "search.axis",
             "search.adversarial", "train.mining", "train.flywheel",
             "harness.flywheel", "parallel", "parallel.mesh",
             "parallel.sharded", "parallel.sharded_kernel"):
    assert "ccka_tpu_torch." + want in names, (want, names)

import torch
from ccka_tpu_torch import default_config
from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim.megakernel import megakernel_rollout_summary
from ccka_tpu_torch.sim.types import SimParams

cfg = default_config()
src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim, cfg.signals)
tr = src.batch_trace_device(16, torch.Generator().manual_seed(1), 4,
                            device="cpu")
s = megakernel_rollout_summary(
    SimParams.from_config(cfg, device="cpu"),
    offpeak_action(cfg.cluster, "cpu"), peak_action(cfg.cluster, "cpu"),
    tr, seed=3, stochastic=True, device="cpu")
assert s.cost_usd.shape == (4,) and bool(torch.isfinite(s.cost_usd).all())

# The three-policy path: the carbon teacher and the shipped flagship.
from ccka_tpu_torch import PRESETS
from ccka_tpu_torch.sim.megakernel import (
    carbon_megakernel_rollout_summary, neural_megakernel_rollout_summary)
from ccka_tpu_torch.train.flagship import load_flagship_backend

cfg = PRESETS["multiregion"]()
src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim, cfg.signals)
tr = src.batch_trace_device(8, torch.Generator().manual_seed(1), 4,
                            device="cpu")
params = SimParams.from_config(cfg, device="cpu")
c = carbon_megakernel_rollout_summary(
    params, offpeak_action(cfg.cluster, "cpu"),
    peak_action(cfg.cluster, "cpu"), tr, seed=3, device="cpu")
backend, meta = load_flagship_backend(cfg, device="cpu")
n = neural_megakernel_rollout_summary(params, cfg.cluster, backend.params,
                                      tr, seed=3, device="cpu")
for x in (c, n):
    assert x.cost_usd.shape == (4,)
    assert bool(torch.isfinite(x.cost_usd).all())

# The fault and workload boards on widened packed streams.
from ccka_tpu_torch.faults.scoreboard import fault_scoreboard
from ccka_tpu_torch.workloads.scoreboard import workload_scoreboard

fb = fault_scoreboard(cfg, intensities=("off", "severe"), n_traces=4,
                      eval_steps=8, device="cpu")
wb = workload_scoreboard(cfg, scenarios=("mixed",), n_traces=4,
                         eval_steps=8, device="cpu")
assert set(fb["degradation_curves"]) == {"rule", "flagship", "mpc"}
assert wb["scenarios"]["mixed"]["stream_rows"] == 40
assert wb["mpc_planner"]["plan_rows"] == 24

# Diff-MPC through the evaluation harness, with a forecaster.
from ccka_tpu_torch.forecast.base import make_forecaster
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.train.evaluate import compare_backends, heldout_traces
from ccka_tpu_torch.train.mpc import MPCBackend

board = compare_backends(
    cfg, {"rule": RulePolicy(cfg.cluster, "cpu"),
          "mpc": MPCBackend(cfg, horizon=4, iters=1, replan_every=4,
                            forecaster=make_forecaster("ridge"),
                            device="cpu")},
    heldout_traces(src, steps=8, n=2, device="cpu"))
assert board["mpc"]["vs_rule_objective"] > 0

# The trainers, each a step at a tiny size (their imports are lazy).
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.train.cem import CEMConfig, cem_refine
from ccka_tpu_torch.train.factory import produce_cell
from ccka_tpu_torch.train.flagship import train_flagship
from ccka_tpu_torch.train.imitate import collect_dataset, imitate
from ccka_tpu_torch.train.ppo import PPOTrainer
from ccka_tpu_torch.workloads.scenarios import resolve_scenarios

small = cfg.with_overrides(**{"train.batch_clusters": 4,
                              "train.unroll_steps": 4})
trainer = PPOTrainer(small, device="cpu")
ts, diag = trainer.iteration(trainer.init_state(0),
                             trainer.make_windows(src, 1))
assert bool(torch.isfinite(diag.value_loss))
data = collect_dataset(small, CarbonAwarePolicy(cfg.cluster, device="cpu"),
                       src, steps=8, device="cpu")
net, _ = imitate(small, None, None, dataset=data, iterations=2,
                 minibatch=8, device="cpu")
cem_refine(small, net, src, cem=CEMConfig(generations=1, popsize=2,
                                          traces_per_gen=2, eval_steps=8),
           device="cpu")
produce_cell(small, resolve_scenarios(["mixed"])["mixed"], "off", pairs=2,
             steps=16, block_T=16, t_chunk=16, iters=1, device="cpu")
train_flagship(small, iterations=1, eval_every=1, eval_steps=8,
               n_eval_traces=1, log=lambda s: None, device="cpu")
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
# The closed control loop: a few ticks, a snapshot, the recovery board.
import contextlib
import io
import tempfile

from ccka_tpu_torch.cli import main as cli_main
from ccka_tpu_torch.harness.recovery import recovery_scoreboard

with tempfile.TemporaryDirectory() as d:
    assert cli_main(["run", "--device", "cpu", "--ticks", "2",
                     "--interval", "0", "--snapshot", d + "/s.snap"]) == 0
# The operator tools and the command line's scoring entries.
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(
        io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
    for argv in (["preroll", "--device", "cpu"], ["bootstrap"],
                 ["guardrails"], ["burst", "--status"], ["watch"],
                 ["dashboard", "--json"], ["pipeline", "--json"],
                 ["simulate", "--clusters", "2", "--days", "0.002",
                  "--device", "cpu"],
                 ["capture", "--steps", "8", "--out", d + "/c.npz",
                  "--device", "cpu"]):
        assert cli_main(argv) == 0, argv
rb = recovery_scoreboard(cfg, policies=("rule",), intensities=("severe",),
                         runs_per_cell=1, ticks=4, device="cpu")
assert rb["invariants"]["resume_bitwise_frac"] == 1.0
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
# The fleet, its ledgers and replayed device windows.
from ccka_tpu_torch.signals.replay import ReplaySignalSource
with contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    assert cli_main(["fleet", "--clusters", "2", "--ticks", "2",
                     "--device", "cpu"]) == 0
    assert cli_main(["tournament", "list"]) == 0
    # The multi-tenant service layer and its overload board.
    assert cli_main(["fleet", "--service", "default", "--clusters", "4",
                     "--ticks", "2", "--profiles", "healthy,slow",
                     "--device", "cpu"]) == 0
    assert cli_main(["overload-eval", "--tenants", "2", "--intensities",
                     "off", "--slow-fracs", "0", "--policies", "rule",
                     "--ticks", "4", "--device", "cpu"]) == 0
ReplaySignalSource.from_file("data/replay_2day.npz").packed_trace_device(
    8, 0, 2, device="cpu")
# Geo arbitrage: a region-widened stream and the Pareto scoreboard.
from ccka_tpu_torch import PRESETS
from ccka_tpu_torch.regions.pareto import GEO_SCENARIOS
mcfg = PRESETS["multiregion"]()
assert SyntheticSignalSource(
    mcfg.cluster, mcfg.workload, mcfg.sim, mcfg.signals,
    extra_lanes={"regions": GEO_SCENARIOS["calm"].geo.bound_to(
        mcfg.cluster)}).packed_trace_device(8, 0, 2,
                                            device="cpu").shape[1] == 80
with contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    assert cli_main(["--preset", "multiregion", "geo", "--steps", "8",
                     "--batch", "1", "--scenarios", "calm",
                     "--device", "cpu"]) == 0
# The scenario axis and the search: a tiny CEM run.
from ccka_tpu_torch.search.adversarial import ScenarioScorer, search_scenarios
dcfg = default_config()
res = search_scenarios(dcfg, iters=1, pop=2, scorer=ScenarioScorer(
    dcfg, steps=8, inner_batch=2, t_chunk=8, device="cpu"))
assert res.scenario.minted and res.evals == 7
# The mesh: a sharded rule launch and a streamed day over two CPU shards.
from ccka_tpu_torch.parallel import (gather, make_mesh, sharded_packed_trace,
                                     sharded_megakernel_summary_from_packed)
from ccka_tpu_torch.sim.streaming import streaming_rollout_summary
mesh = make_mesh(devices=["cpu"] * 2)
stream = sharded_packed_trace(mesh, src, 8, 1, 4)
gather(sharded_megakernel_summary_from_packed(
    mesh, params, offpeak_action(cfg.cluster, "cpu"),
    peak_action(cfg.cluster, "cpu"), stream, 8))
streaming_rollout_summary(src, params, cfg.cluster, "rule", key=1, batch=4,
                          T=16, block_T=8, t_chunk=8, mesh=mesh,
                          device="cpu")
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("PORT_JAX_FREE", len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PORT_JAX_FREE" in proc.stdout


def test_sources_ship_with_the_package():
    """The kernel source sits in the package and nothing is prebuilt."""
    from ccka_tpu_torch.kernels import build

    assert set(build.SOURCES) == {"rollout_profiles.cu", "rollout_mlp.cu"}
    assert set(build._SIGNATURES) == set(build.SOURCES)
    for src in build.SOURCES:
        assert (build.CSRC / src).is_file()
        # Every header a source includes ships beside it.
        for line in (build.CSRC / src).read_text().splitlines():
            if line.startswith('#include "'):
                assert (build.CSRC / line.split('"')[1]).is_file(), line
    # One library per (source, lane variant), each its own nvcc.
    assert len({build._lib_path(s, f, d) for s in build.SOURCES
                for f, d in build.VARIANTS}) == 2 * len(build.VARIANTS)
    with pytest.raises(ValueError, match="no kernel build"):
        build._lib_path("rollout_mlp.cu", True, 6)
    assert "-gencode" in build.NVCC_FLAGS and "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert all("fast_math" not in f for f in build.NVCC_FLAGS)


_SASS = """
	code for sm_90a
		Function : _Z6kernelPf
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.CONSTANT R2, desc[UR4][R2.64] ;  /* 0x0 */
        /*0020*/                   MUFU.RCP R4, R3 ;               /* 0x0 */
        /*0030*/                   FCHK P0, R2, R3 ;               /* 0x0 */
        /*0040*/              @!P0 BRA 0x60 ;                      /* 0x0 */
        /*0050*/                   CALL.REL.NOINC 0xa0 ;           /* 0x0 */
        /*0060*/                   SHFL.IDX PT, R5, R4, RZ, 0x1c1f ;  /* 0x0 */
        /*0070*/               @P1 BRA 0x10 ;                      /* 0x0 */
        /*0080*/                   STL [R1], R5 ;                  /* 0x0 */
        /*0090*/                   EXIT ;                          /* 0x0 */
        /*00a0*/                   RET.REL.NODEC R20 0x0 ;         /* 0x0 */
"""


def test_sass_counts_reads_the_tick_loop():
    """`kernels/build.py::sass_counts` on a cuobjdump listing: every
    opcode it counts, predicated ones included, and the loop from the
    backward branch's target to the branch (the call's target outside)."""
    from ccka_tpu_torch.kernels import build

    (name, counts), = build.sass_counts(_SASS).items()
    assert name == "_Z6kernelPf"
    assert counts == {"instructions": 11, "loop": 7, "HMMA": 0, "SHFL": 1,
                      "MUFU": 1, "CALL": 1, "LDG": 1, "LDL": 0, "STL": 1}
