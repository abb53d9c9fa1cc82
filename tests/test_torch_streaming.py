"""The port's carried-state streaming against the JAX package and itself.

Against the JAX package on the same inputs: the block and chunk
arithmetic (accepted and refused alike), the packed exo assembly at a
block's global tick on JAX's own noise (1e-6), and deterministic blocked
plain rollouts of the rule, carbon, plan and flagship routes on JAX's own
blocked stream arrays against JAX's lax path on the concatenated arrays,
per cluster at ``tests/test_megakernel.py``'s 2e-3 standard.

Within the port, bitwise, both modes, all four routes, on the plain,
severe, flash-crowd and mixed streams: blocked equals the non-carry entry
on the concatenated blocks, the synchronous drive equals the
double-buffered one, chunk c of the chunked drive equals the single drive
of shard c at cluster offset c * chunk, and widening a blocked stream
keeps its exo and fault rows. On the CPU the block entries run their
plain versions (`sim/rollout.py::resume_rollout_summary`); the CUDA
kernels' CARRY instantiations are held against the same plain versions by
``tests/test_torch_kernels.py`` (``gpu``) and `chip_smoke.py` phase 10.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu.sim.lanes as jlanes
import ccka_tpu.sim.megakernel as jmk
import ccka_tpu_torch.config as tcfg
from ccka_tpu.faults.process import unpack_fault_lanes as junpack_faults
from ccka_tpu.policy import CarbonAwarePolicy as JCarbonAwarePolicy
from ccka_tpu.policy import RulePolicy as JRulePolicy
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.signals.synthetic import _ar1_device as jar1
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.sim import streaming as jstreaming
from ccka_tpu.sim.rollout import batched_rollout_summary as jrollout
from ccka_tpu.workloads import WORKLOAD_SCENARIOS as JSCENARIOS
from ccka_tpu.workloads import scenario_source as jscenario_source
from ccka_tpu.workloads import unpack_workload_lanes as junpack_workloads
from ccka_tpu_torch import bridge
from ccka_tpu_torch.obs.occupancy import OccupancyLedger
from ccka_tpu_torch.obs.trace import SpanTracer
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim import streaming as stm
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train.flagship import load_flagship_backend
from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                scenario_source)

PRESET_NAMES = ("default", "multiregion")
ROUTES = ("rule", "carbon", "neural", "plan")
STREAMS = ("plain", "severe", "flash-crowd", "mixed")
PER_CLUSTER_TOL = 2e-3   # tests/test_megakernel.py:100-109
# Fields that are near zero on a cluster (a few denied nodes, a shed pod)
# are held absolutely, at the JAX package's atol for widened streams
# (tests/test_workloads.py::TestKernelLaxWorkloadParity).
LANE_ATOL = 1e-4
TIGHT = dict(rtol=1e-6, atol=1e-6)


def _np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)._asdict()


def _bitwise_fields(a, b) -> list:
    return [f for f in a._fields
            if not torch.equal(getattr(a, f), getattr(b, f))]


# ---- block arithmetic -----------------------------------------------------


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as err:
        return ("ValueError", str(err))


def test_block_arithmetic_matches_jax():
    """Every (T, block_T, t_chunk) of a grid and every (batch, chunk):
    the same result, or the same refusal with the same message."""
    assert lanes.BLOCK_KEY_TAG == jlanes.BLOCK_KEY_TAG
    n_refused = 0
    for T, bT, tc in itertools.product((1, 64, 90, 96, 100, 720, 2880),
                                       (0, 16, 24, 32, 48, 180, 360),
                                       (-1, 0, 8, 16, 20, 32, 64)):
        got = _outcome(lanes.block_layout, T, bT, tc)
        assert got == _outcome(jlanes.block_layout, T, bT, tc), (T, bT, tc)
        n_refused += got[0] != "ok"
    assert 0 < n_refused < 7 * 7 * 7
    for batch, chunk in itertools.product((1, 64, 100, 262144),
                                          (-8, 0, 8, 16, 32768)):
        assert _outcome(lanes.chunk_layout, batch, chunk) == _outcome(
            jlanes.chunk_layout, batch, chunk), (batch, chunk)
    for args in ((32, 40, 16), (360, 40, 32768), (1, 1, 1)):
        assert lanes.block_bytes(*args) == jlanes.block_bytes(*args)
    assert stm.plan_stream(90, 32, 16) == stm.StreamPlan(90, 32, 16, 3, 96)
    with pytest.raises(ValueError, match="t_chunk"):
        stm.plan_stream(96, 24, 16)
    with pytest.raises(ValueError, match="tile"):
        stm.plan_stream(96, 64, 32)


# ---- block synthesis ------------------------------------------------------


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_assemble_packed_at_a_global_tick_matches_jax(preset):
    """The exo block of block j (global ticks 32 j on) from JAX's own
    noise equals JAX's within 1e-6, on the synthetic clock and at epoch
    scale."""
    jc, tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    Z, steps, batch = jc.cluster.n_zones, 32, 8

    @jax.jit
    def noise(key):
        ks, kc, kd = jax.random.split(key, 3)
        return (jar1(ks, (steps, Z, batch), rho=0.97, sigma=0.04, axis=0),
                jar1(kc, (steps, Z, batch), rho=0.95, sigma=0.03, axis=0),
                jar1(kd, (steps, batch), rho=0.9, sigma=0.5, axis=0))

    for start in (0.0, 1.7e9 + 1234.0):
        jsrc = JSource(jc.cluster, jc.workload, jc.sim, jc.signals,
                       start_unix_s=start)
        tsrc = SyntheticSignalSource(tc.cluster, tc.workload, tc.sim,
                                     tc.signals, start_unix_s=start)
        for j in range(3):
            nz = noise(jax.random.key(10 + j))
            want = np.asarray(jsrc._assemble_packed(
                steps, steps, nz, t0_ticks=jnp.int32(32 * j)))
            got = tsrc._assemble_packed(
                steps, steps, tuple(torch.from_numpy(np.array(x))
                                    for x in nz), t0_ticks=32 * j)
            np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    # Block 0 of a blocked stream keeps the float64 host clock's peak rows.
    unblocked = tsrc._assemble_packed(steps, steps, tuple(
        torch.from_numpy(np.array(x)) for x in noise(jax.random.key(1))))
    np.testing.assert_array_equal(got.numpy()[:, 3 * Z + 2],
                                  want[:, 3 * Z + 2])
    assert unblocked.shape == got.shape


def test_blocked_streams_keep_their_rows_and_seeds():
    """The port's block synthesis: each lane family draws from the block's
    seed under its own tag, so widening a blocked stream keeps its exo
    rows (and a scenario's fault rows) bitwise; blocks, chunks and seeds
    give distinct worlds; ``out=`` writes the block into a given buffer;
    block j's clock is the unblocked stream's at tick 32 j."""
    c = tcfg.PRESETS["multiregion"]()
    Z = c.cluster.n_zones
    base, frows = lanes.exo_rows(Z), lanes.fault_rows(Z)

    def blk(src, j, **kw):
        return src.packed_block_trace_device(32, 11, 6, j, t_chunk=16,
                                             device="cpu", **kw)

    plain = SyntheticSignalSource(c.cluster, c.workload, c.sim, c.signals)
    mild = SyntheticSignalSource(c.cluster, c.workload, c.sim, c.signals,
                                 faults=tcfg.FAULT_PRESETS["mild"])
    severe = SyntheticSignalSource(c.cluster, c.workload, c.sim, c.signals,
                                   faults=tcfg.FAULT_PRESETS["severe"])
    mixed = scenario_source(c, WORKLOAD_SCENARIOS["mixed"])
    flash = scenario_source(c, WORKLOAD_SCENARIOS["flash-crowd"])
    for j in range(3):
        p = blk(plain, j)
        assert torch.equal(blk(severe, j)[:, :base], p)
        assert torch.equal(blk(flash, j)[:, :base], p)
        m = blk(mixed, j)
        assert m.shape[1] == base + frows + lanes.workload_rows(Z)
        assert torch.equal(m[:, :base + frows], blk(mild, j))
        assert float(m[:, base + frows:].max()) > 0
    assert not torch.equal(blk(plain, 0), blk(plain, 1))
    assert not torch.equal(blk(plain, 1), blk(plain, 1, shard=1))
    assert not torch.equal(blk(plain, 1, shard=1), blk(plain, 1, shard=2))
    buf = torch.full((32, base, 6), float("nan"))
    got = blk(plain, 2, out=buf)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(got,
                                                             blk(plain, 2))
    with pytest.raises(ValueError, match="out must be"):
        blk(plain, 0, out=torch.zeros((16, base, 6)))
    # The peak row follows the global clock: block 2 of a day in blocks of
    # 1440 ticks is the afternoon and evening.
    day = plain.packed_block_trace_device(1440, 5, 1, 1, t_chunk=16,
                                          device="cpu")[:, 3 * Z + 2, 0]
    hours = (1440 + torch.arange(1440)) * 30 / 3600
    assert torch.equal(day, ((hours >= 9) & (hours < 21)).float())


# ---- blocked plain rollouts on JAX's blocked streams ----------------------


class _JaxBlocks:
    """JAX's blocked stream of one preset and stream name, its blocks as
    numpy (`ccka_tpu.sim.streaming._block_gen`), and both packages'
    params."""

    def __init__(self, preset: str, name: str, B: int, T: int,
                 block_T: int, t_chunk: int):
        self.jc, self.tc = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
        self.Z = self.jc.cluster.n_zones
        self.B, self.T = B, T
        jc = self.jc
        if name == "plain":
            src = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
        else:
            sc = JSCENARIOS[name]
            src = jscenario_source(jc, sc)
            jc = dataclasses.replace(jc, workloads=sc.workloads)
        self.name = name
        self.jp = JSimParams.from_config(jc)
        self.tp = bridge.sim_params(_np(self.jp), "cpu")
        plan = jstreaming.plan_stream(T, block_T, t_chunk)
        gen = jstreaming._block_gen(src, plan, B)
        key = jax.random.key(17)
        self.blocks = [np.array(gen(j, key)) for j in range(plan.n_blocks)]
        self.full = np.concatenate(self.blocks)
        self.plan = plan

    def jax_lax(self, action_fn):
        stream = jnp.asarray(self.full)
        states = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (self.B,) + x.shape),
            jinitial_state(self.jc))
        lay = jlanes.stream_layout(stream.shape[1], self.Z)
        return jrollout(
            self.jp, states, action_fn, jmk.unpack_exo(stream, self.T,
                                                       self.Z),
            jax.random.split(jax.random.key(0), self.B), stochastic=False,
            faults=junpack_faults(stream, self.T, self.Z) if lay[0]
            else None,
            workloads=junpack_workloads(stream, self.T, self.Z) if lay[1]
            else None)[1]

    def port_blocked(self, mode: str, **kw):
        fns = mk.packed_mode_block_summary_fn(
            self.tp, self.tc.cluster, mode, T=self.T,
            block_T=self.plan.block_T, t_chunk=self.plan.t_chunk,
            stochastic=False, **kw)
        blocks = [torch.from_numpy(b) for b in self.blocks]
        state = fns.init_state(blocks[0].shape[1], self.B, device="cpu")
        spare = torch.zeros_like(state)
        for j, b in enumerate(blocks):
            out, new = fns.step(b, state, j, 3, state_out=spare)
            state, spare = new, state
        return fns.finalize(out)


def _assert_per_cluster(port, ref) -> float:
    """Every cluster and field within ``PER_CLUSTER_TOL`` relative, or
    ``LANE_ATOL`` absolute; returns the largest ratio to that bound."""
    worst = 0.0
    for f in ref._fields:
        a = getattr(port, f).numpy().astype(np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        assert a.shape == b.shape, f
        ratio = float(np.max(np.abs(a - b) / (
            np.maximum(PER_CLUSTER_TOL * np.abs(b), LANE_ATOL))))
        assert ratio <= 1.0, (f, ratio, float(np.max(np.abs(a - b))))
        worst = max(worst, ratio)
    return worst


@pytest.mark.parametrize("preset,name", [("default", "plain"),
                                         ("multiregion", "plain"),
                                         ("multiregion", "mixed")])
def test_blocked_rule_and_carbon_match_jax_lax(preset, name):
    """B = 64, T = 90 padded to 96 in blocks of 32, deterministic: the
    port's blocked plain rule and carbon rollouts on JAX's blocked
    stream against JAX's lax path on the concatenated stream (mixed:
    fault and workload lanes, the carbon policy's held observation and
    the queues crossing every block)."""
    w = _JaxBlocks(preset, name, 64, 90, 32, 16)
    worst = _assert_per_cluster(
        w.port_blocked("rule"),
        w.jax_lax(JRulePolicy(w.jc.cluster).action_fn()))
    worst = max(worst, _assert_per_cluster(
        w.port_blocked("carbon"),
        w.jax_lax(JCarbonAwarePolicy(w.jc.cluster).action_fn())))
    print(f"\n# blocked rule, carbon {preset} {name}: worst {worst:.3g} of "
          f"the bound")


def test_blocked_plan_matches_jax_lax():
    """A decoded random plan, one for every cluster (JAX's lax path takes
    one action sequence for the batch), on the multiregion mixed stream:
    B = 64, T = 96 in blocks of 32."""
    from ccka_tpu.models import latent_to_action as jlatent_to_action
    from ccka_tpu_torch.models.nets import latent_dim

    w = _JaxBlocks("multiregion", "mixed", 64, 96, 32, 16)
    lat = (0.3 * np.random.default_rng(4).standard_normal(
        (96, latent_dim(w.tc.cluster)))).astype(np.float32)
    jacts = jax.vmap(lambda u: jlatent_to_action(u, w.jc.cluster))(
        jnp.asarray(lat))
    plan = mk.pack_plan(bridge.action(_np(jacts), "cpu"), 96)
    port = w.port_blocked("plan", plan_packed=plan)
    ref = w.jax_lax(lambda s, e, t: jax.tree.map(lambda x: x[t], jacts))
    print(f"\n# blocked plan: worst {_assert_per_cluster(port, ref):.3g} of "
          f"the bound")
    assert float(port.cost_usd.std()) > 0


def test_blocked_flagship_matches_jax_lax():
    """The MLP route, T = 32 in blocks of 16, on the multiregion mixed
    stream, deterministic: the port's blocked plain version (the MLP
    kernel's numerics) against JAX's lax path under JAX's
    `kernel_numerics_action_fn`.

    On the net `tests/test_megakernel.py` sets its short-horizon standard
    on (`test_torch_neural._perturbed_net_params`), every cluster within
    the bound. On the shipped flagship, the blocked run is bitwise the
    port's unblocked plain version, and what separates that from JAX is
    documented in `tests/test_torch_neural.py`: the trained policy rides
    the SLO threshold, and a sum in another order that moves a hidden unit
    by one bf16 step flips a tick there, so that JAX's own interpret-mode
    kernel leaves 18 of 128 clusters outside its lax path's standard. So,
    for the shipped net: every batch mean within the bound, and on this
    stream at least 60 of 64 clusters within it on every field (4
    outside, 6 %, against the 14 % JAX's kernel leaves): one cluster more
    outside fails."""
    from test_torch_neural import _perturbed_net_params

    w = _JaxBlocks("multiregion", "mixed", 64, 32, 16, 16)
    jtree = _perturbed_net_params(w.jc)
    port = w.port_blocked("neural",
                          net_params=jax.tree.map(np.array, jtree))
    ref = w.jax_lax(jmk.kernel_numerics_action_fn(jtree, w.jc.cluster, w.jp))
    print(f"\n# blocked MLP, the JAX tests' net: worst "
          f"{_assert_per_cluster(port, ref):.3g} of the bound")

    net = load_flagship_backend(w.tc, device="cpu")[0].params
    port = w.port_blocked("neural", net_params=net)
    unblocked = mk.neural_megakernel_summary_from_packed(
        w.tp, w.tc.cluster, net, torch.from_numpy(w.full), 32, 3,
        stochastic=False)
    assert not _bitwise_fields(port, unblocked)
    ref = w.jax_lax(jmk.kernel_numerics_action_fn(
        jax.tree.map(jnp.asarray, net), w.jc.cluster, w.jp))
    inside = np.ones(64, bool)
    for f in ref._fields:
        a = getattr(port, f).numpy().astype(np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        bound = np.maximum(PER_CLUSTER_TOL * np.abs(b), LANE_ATOL)
        inside &= np.abs(a - b) <= bound
        assert abs(a.mean() - b.mean()) <= max(
            PER_CLUSTER_TOL * abs(b.mean()), LANE_ATOL), f
    print(f"# blocked flagship: {int(inside.sum())} of 64 clusters within "
          f"the bound on every field")
    assert int(inside.sum()) >= 60, inside.sum()


# ---- within the port, bitwise ---------------------------------------------


def _source(cfg, name: str):
    if name == "plain":
        return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                     cfg.signals), cfg
    if name in WORKLOAD_SCENARIOS:
        sc = WORKLOAD_SCENARIOS[name]
        return (scenario_source(cfg, sc),
                dataclasses.replace(cfg, workloads=sc.workloads))
    return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals,
                                 faults=tcfg.FAULT_PRESETS[name]), cfg


@pytest.fixture(scope="module")
def multiregion():
    cfg = tcfg.PRESETS["multiregion"]()
    net = load_flagship_backend(cfg, device="cpu")[0].params
    return cfg, net


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("mode", ROUTES)
def test_blocked_drives_are_bitwise_the_unblocked_entry(multiregion, name,
                                                        mode):
    """Multiregion B = 8, T = 45 padded to 48 in blocks of 16, both modes:
    the synchronous drive, the double-buffered drive and the mode's
    non-carry entry on the concatenated blocks give the same bits."""
    cfg, net = multiregion
    src, pcfg = _source(cfg, name)
    params = SimParams.from_config(pcfg, device="cpu")
    plan = None
    if mode == "plan":
        from ccka_tpu_torch.models.nets import latent_dim, latent_to_action

        lat = 0.3 * torch.randn((8, 48, latent_dim(cfg.cluster)),
                                generator=torch.Generator().manual_seed(2))
        plan = mk.pack_plan(latent_to_action(lat, cfg.cluster), 48)
    for stochastic in (False, True):
        kw = dict(key=5, batch=8, T=45, block_T=16, seed=9, t_chunk=16,
                  stochastic=stochastic, device="cpu",
                  net_params=net if mode == "neural" else None,
                  plan_packed=plan)
        sync, rs = stm.streaming_rollout_summary(
            src, params, cfg.cluster, mode, pipelined=False, **kw)
        pipe, rp = stm.streaming_rollout_summary(
            src, params, cfg.cluster, mode, pipelined=True, **kw)
        ref = stm.unblocked_reference_summary(src, params, cfg.cluster,
                                              mode, **kw)
        assert not _bitwise_fields(sync, pipe), (mode, name, stochastic)
        assert not _bitwise_fields(pipe, ref), (mode, name, stochastic)
        assert rp["stream_buffers"] == 2 and rp["n_blocks"] == 3
        assert rp["pipeline"] == "double-buffered" and rs["pipeline"] == \
            "sync"
        fr = rs["occupancy"]["fractions"]
        assert abs(sum(fr.values()) - 1.0) < 1e-5 and fr["kernel"] > 0
        assert all(torch.isfinite(x).all() for x in pipe)
        assert pipe.cost_usd.shape == (8,)


def test_chunks_are_the_single_drive_at_their_offset(multiregion):
    """Chunk c of the chunked drive is bitwise the single drive of shard
    c at cluster offset c * chunk, in both drives; the chunks are
    distinct worlds; the report bounds the memory at two blocks."""
    cfg, _ = multiregion
    src, pcfg = _source(cfg, "mixed")
    params = SimParams.from_config(pcfg, device="cpu")
    kw = dict(key=5, T=45, block_T=16, seed=9, t_chunk=16, stochastic=True,
              device="cpu")
    for pipelined in (True, False):
        whole, rep = stm.chunked_streaming_summary(
            src, params, cfg.cluster, "carbon", batch=24, chunk=8,
            pipelined=pipelined, **kw)
        assert rep["chunks"] == 3 and rep["peak_bytes"] is None
        assert rep["live_block_bytes"] == 2 * 4 * 16 * src.packed_rows() * 8
        assert rep["stream_bytes"] == 4 * 48 * src.packed_rows() * 24
        assert ("stream_buffers" in rep) == pipelined
        for c in range(3):
            one, _ = stm.streaming_rollout_summary(
                src, params, cfg.cluster, "carbon", batch=8, shard=c,
                cluster0=8 * c, pipelined=pipelined, **kw)
            part = type(one)(*(x[8 * c:8 * (c + 1)] for x in whole))
            assert not _bitwise_fields(part, one), (pipelined, c)
    assert not torch.equal(whole.cost_usd[:8], whole.cost_usd[8:16])


def test_carry_layout_round_trips_and_sizes():
    """`pack_carry`/`unpack_carry` invert each other; the layout's rows
    follow the lanes and the mode (held rows only for an observing policy
    under faults), 128 for the flagship on the multiregion mixed stream."""
    from ccka_tpu_torch.sim.rollout import (CarryLayout, pack_carry,
                                            unpack_carry)

    cfg = tcfg.PRESETS["multiregion"]()
    sc = WORKLOAD_SCENARIOS["mixed"]
    params = SimParams.from_config(
        dataclasses.replace(cfg, workloads=sc.workloads), device="cpu")
    rows = {mode: mk.block_state_rows(params, cfg.cluster, mode, 40)
            for mode in ROUTES}
    assert rows == {"rule": 112, "carbon": 128, "neural": 128, "plan": 112}
    assert mk.block_state_rows(params, cfg.cluster, "rule", 16) == 96
    with pytest.raises(ValueError, match="unknown packed mode"):
        mk.block_state_rows(params, cfg.cluster, "mlp", 16)
    lay = CarryLayout(2, 4, 3, True, 16)
    assert lay.blocks()["queues"] == (104, 122) and lay.rows == 128
    x = torch.rand((128, 5), generator=torch.Generator().manual_seed(0))
    x[122:] = 0
    x[lay.blocks()["queues"][1] - 1] = 0   # the batch pipeline's last slot
    back = pack_carry(unpack_carry(x, lay, params, 7), lay)
    assert torch.equal(back[:-7], x[:-7])
    state = mk.init_block_state(params, cfg.cluster, "neural", 40, 5,
                                n_pop=2, device="cpu")
    assert tuple(state.shape) == (2, 128, 5) and float(state.abs().sum()) == 0


def test_misuse_is_refused(multiregion):
    cfg, _ = multiregion
    src, _ = _source(cfg, "plain")
    params = SimParams.from_config(cfg, device="cpu")
    kw = dict(key=1, batch=8, T=48, seed=0, t_chunk=16, device="cpu")
    with pytest.raises(ValueError, match="t_chunk"):
        stm.streaming_rollout_summary(src, params, cfg.cluster, "rule",
                                      block_T=24, **kw)
    with pytest.raises(ValueError, match="tile"):
        stm.streaming_rollout_summary(src, params, cfg.cluster, "rule",
                                      block_T=32, **kw)
    with pytest.raises(ValueError, match="does not divide batch"):
        stm.chunked_streaming_summary(src, params, cfg.cluster, "rule",
                                      chunk=3, block_T=16,
                                      **{k: v for k, v in kw.items()})
    from ccka_tpu_torch.config import ConfigError
    from ccka_tpu_torch.parallel import make_mesh

    mesh3 = make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ConfigError, match="not divisible by 3 data shards"):
        stm.streaming_rollout_summary(src, params, cfg.cluster, "rule",
                                      block_T=16, mesh=mesh3, **kw)
    with pytest.raises(ValueError, match="one chunk"):
        stm.streaming_rollout_summary(src, params, cfg.cluster, "rule",
                                      block_T=16, mesh=mesh3, shard=1, **kw)
    with pytest.raises(ValueError, match="unknown packed mode"):
        stm.streaming_rollout_summary(src, params, cfg.cluster, "mlp",
                                      block_T=16, **kw)
    with pytest.raises(ValueError, match="needs net_params"):
        mk.packed_mode_block_summary_fn(params, cfg.cluster, "neural", T=48,
                                        block_T=16, t_chunk=16)
    fns = mk.packed_mode_block_summary_fn(params, cfg.cluster, "rule", T=48,
                                          block_T=16, t_chunk=16)
    blk = src.packed_block_trace_device(16, 1, 8, 0, t_chunk=16,
                                        device="cpu")
    state = fns.init_state(blk.shape[1], 8, device="cpu")
    spare = torch.zeros_like(state)
    with pytest.raises(ValueError, match="block_T=16"):
        fns.step(blk[:8], state, 0, 0, state_out=spare)
    with pytest.raises(ValueError, match="outside"):
        fns.step(blk, state, 3, 0, state_out=spare)
    with pytest.raises(ValueError, match="init_state"):
        fns.step(blk, state[:, :4], 0, 0, state_out=spare)
    with pytest.raises(ValueError, match="init_state"):
        fns.step(blk, state, 0, 0, state_out=spare[:, :4])
    with pytest.raises(ValueError, match="another buffer"):
        fns.step(blk, state, 0, 0, state_out=state)
    with pytest.raises(ValueError, match="plan stream shape"):
        mk.packed_mode_block_summary_fn(
            params, cfg.cluster, "plan", T=48, block_T=16, t_chunk=16,
            plan_packed=torch.zeros((32, 24)))


def test_span_tracer_and_occupancy_ledger():
    tr = SpanTracer()
    led = OccupancyLedger()
    assert led.fractions() == {}
    with tr.device_span("gen") as sp:
        sp.fence(torch.zeros(3))
    led.add("generation", sp.dur_s)
    with tr.span("host", block=1) as sp:
        pass
    led.add("host", 3 * sp.dur_s + 1e-3)
    with pytest.raises(RuntimeError, match="without a fence"):
        with tr.device_span("kernel"):
            pass
    with pytest.raises(ValueError, match="unknown pipeline stage"):
        led.add("planner", 1.0)
    assert abs(sum(led.fractions().values()) - 1.0) < 1e-9
    assert set(tr.timings_by_name()) == {"gen", "host", "kernel"}
    assert [s.cat for s in tr.spans()] == ["device", "host", "device"]
    assert led.to_dict()["repeats"] == 0
