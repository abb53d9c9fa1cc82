"""The port's device mesh (`ccka_tpu_torch/parallel/`) on a CPU mesh.

The CPU tests build ``[cpu] * 8`` (and smaller) meshes, the counterpart
of the JAX package's 8 virtual host devices (`tests/conftest.py`). On the
CPU every kernel entry runs its plain version, with the same
``cluster0`` a shard's launch takes on the card. The plain versions'
vectorized transcendentals (sigmoid, tanh, exp) round an element by its
place within the CPU's vector width, so a shard of 8 clusters can differ
from the whole batch in a last bit where one of 16 cannot: the bitwise
cases give every shard 16 clusters (the CUDA kernels compute each
cluster alone, whatever the launch's size).

- The mesh units of `tests/test_parallel.py` (`make_mesh`, `shard_batch`,
  `replicate`, `shard_params`), their errors the JAX package's words.
- Every sharded kernel entry (rule, carbon, the MLP population, plan;
  packed and trace-taking) bitwise the unsharded entry on the
  concatenated stream, on the plain stream and on a fault- and
  workload-widened one, stochastic; shard-local synthesis bitwise the
  generator called with the shard's key.
- JAX's own shard-local arrays (`sharded_packed_trace` over its 8 virtual
  devices) fed to both packages' sharded rule entries, deterministic,
  per cluster at `tests/test_megakernel.py`'s 2e-3 standard.
- `streaming_rollout_summary(mesh=)` bitwise the single-device drive over
  the concatenated shard blocks, four modes; the chunked drive over a
  mesh bitwise the chunked drive.
- `cem_refine(mesh=)`: JAX's refusals, and a generation bitwise a
  single-device generation fed the concatenated streams.
- `optimize_plan_batch(mesh=, donate_plans=True)` and
  `receding_horizon_plan_batch(mesh=)` bitwise unsharded; the donated
  plans alias the buffer.
- The `obs/occupancy.py` entries on the JAX tests' fake stages.
- `sim/lanes.py::register_lane_family` with the JAX registry test's
  refusals, and a registered family reaching synthesis and the sharded
  entries.

The sharded plain rollouts and PPO against the JAX package are in
`tests/test_torch_parallel_train.py`.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
from ccka_tpu import parallel as jpar
from ccka_tpu.obs import occupancy as jocc
from ccka_tpu.policy.rule import offpeak_action as joff
from ccka_tpu.policy.rule import peak_action as jpeak
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim import SimParams as JSimParams
from ccka_tpu.train import cem as jcem
from ccka_tpu.train import mpc as jmpc
import ccka_tpu_torch.config as tcfg
from ccka_tpu_torch.config import ConfigError, MeshConfig
from ccka_tpu_torch.obs import occupancy as occ
from ccka_tpu_torch.obs.trace import SpanTracer
from ccka_tpu_torch.parallel import (gather, make_mesh, replicate,
                                     shard_batch, shard_params)
from ccka_tpu_torch.parallel import sharded_kernel as sk
from ccka_tpu_torch.parallel.mesh import (ColumnSharded, Replicated,
                                          Sharded, batch_sharding)
from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim import megakernel as mk
from ccka_tpu_torch.sim import streaming as stm
from ccka_tpu_torch.sim.rollout import initial_state
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train import cem
from ccka_tpu_torch.train.flagship import load_flagship_backend
from ccka_tpu_torch.train.mpc import (optimize_plan_batch,
                                      receding_horizon_plan_batch,
                                      zero_latent)
from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                scenario_source)

CPU8 = ["cpu"] * 8
PER_CLUSTER_TOL = 2e-3   # tests/test_megakernel.py:100-109


def _equal(a, b) -> list:
    """The fields of two summaries that differ in any bit."""
    return [f for f in a._fields
            if not torch.equal(getattr(a, f), getattr(b, f))]


def _msg(fn) -> str:
    with pytest.raises(Exception) as err:
        fn()
    return str(err.value)


# ---- the mesh -------------------------------------------------------------


def test_make_mesh_shapes_and_jax_errors():
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"data": 8, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    m22 = make_mesh(MeshConfig(model_parallel=2, data_parallel=2),
                    devices=CPU8)
    assert m22.shape == {"data": 2, "model": 2}
    jdev = jax.devices()[:8]
    for cfg in (MeshConfig(model_parallel=3),
                MeshConfig(model_parallel=2, data_parallel=5)):
        jc = jcfg.MeshConfig(**dataclasses.asdict(cfg))
        want = _msg(lambda: jpar.make_mesh(jc, devices=jdev))
        with pytest.raises(ConfigError) as err:
            make_mesh(cfg, devices=CPU8)
        assert str(err.value) == want


def test_shard_batch_places_parts_and_refuses_like_jax():
    mesh = make_mesh(devices=CPU8)
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    sx = shard_batch(mesh, x)
    assert isinstance(sx, Sharded) and sx.sharding == batch_sharding(mesh, 2)
    assert [p.shape[0] for p in sx.parts] == [2] * 8
    assert sx.offsets == list(range(0, 16, 2))
    assert torch.equal(gather(sx), x)
    want = _msg(lambda: jpar.shard_batch(
        jpar.make_mesh(devices=jax.devices()[:8]), np.zeros((10, 3))))
    with pytest.raises(ConfigError) as err:
        shard_batch(mesh, torch.zeros(10, 3))
    assert str(err.value) == want


def test_replicate_and_shard_params():
    mesh = make_mesh(devices=CPU8)
    r = replicate(mesh, torch.arange(4.0))
    assert r.sharding.is_fully_replicated and len(r.devices()) == 8
    assert torch.equal(gather(r), torch.arange(4.0))
    m = make_mesh(MeshConfig(model_parallel=4, data_parallel=2),
                  devices=CPU8)
    params = {"kernel": torch.randn(16, 32),   # flax [in, out]: split
              "head": torch.zeros(16, 5),      # 5 % 4: replicated
              "bias": torch.zeros(32),         # 1-D: replicated
              "Dense_0.weight": torch.randn(32, 16)}   # torch [out, in]
    sp = shard_params(m, params)
    assert isinstance(sp["kernel"], ColumnSharded)
    assert {tuple(p.shape) for p in sp["kernel"].pieces} == {(16, 8)}
    assert {tuple(p.shape) for p in sp["Dense_0.weight"].pieces} == {(8, 16)}
    assert isinstance(sp["head"], Replicated)
    assert isinstance(sp["bias"], Replicated)
    for k in ("kernel", "Dense_0.weight"):
        assert torch.equal(gather(sp[k]), params[k])
    assert shard_params(mesh, params)["kernel"].sharding.is_fully_replicated


# ---- the sharded kernel entries -------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    """The multiregion preset, its flagship, and a plain and a mixed
    (faults and workloads) source."""
    cfg = tcfg.PRESETS["multiregion"]()
    net = load_flagship_backend(cfg, device="cpu")[0].params
    mixed = WORKLOAD_SCENARIOS["mixed"]
    return {"cfg": cfg, "net": net,
            "plain": (SyntheticSignalSource(cfg.cluster, cfg.workload,
                                            cfg.sim, cfg.signals), cfg),
            "mixed": (scenario_source(cfg, mixed),
                      dataclasses.replace(cfg, workloads=mixed.workloads))}


def _random_plan(cfg, B, T, seed=5):
    g = torch.Generator().manual_seed(seed)
    lat = torch.randn((B, T, mk._act_rows(cfg.cluster.n_pools,
                                          cfg.cluster.n_zones)), generator=g)
    from ccka_tpu_torch.models.nets import latent_to_action

    return mk.pack_plan(latent_to_action(lat, cfg.cluster), T)


@pytest.mark.parametrize("name", ("plain", "mixed"))
def test_sharded_entries_bitwise_the_single_launch(worlds, name):
    """B = 64 on 4 shards, T = 8, stochastic: each packed entry per
    shard with its cluster0 equals the unsharded entry on the gathered
    stream, every field of every cluster; shard i's stream is the
    generator's on ``shard_key(key, i)``."""
    src, cfg = worlds[name]
    net = worlds["net"]
    mesh = make_mesh(devices=["cpu"] * 4)
    params = SimParams.from_config(cfg, device="cpu")
    off, peak = offpeak_action(cfg.cluster, "cpu"), peak_action(cfg.cluster, "cpu")
    T, B, seed = 8, 64, 9
    st = sk.sharded_packed_trace(mesh, src, T, 17, B)
    for i in range(4):
        assert torch.equal(st.parts[i], src.packed_trace_device(
            T, sk.shard_key(17, i), 16, device="cpu"))
    full = gather(st)
    plan = _random_plan(cfg, B, T)
    pairs = {
        "rule": (sk.sharded_megakernel_summary_from_packed(
            mesh, params, off, peak, st, T, seed),
            mk.megakernel_summary_from_packed(params, off, peak, full, T,
                                              seed)),
        "carbon": (sk.sharded_carbon_summary_from_packed(
            mesh, params, off, peak, st, T, seed, sharpness=7.0),
            mk.carbon_megakernel_summary_from_packed(
                params, off, peak, full, T, seed, sharpness=7.0)),
        "neural": (sk.sharded_neural_summary_from_packed(
            mesh, params, cfg.cluster, net, st, T, seed),
            mk.neural_megakernel_summary_from_packed(
                params, cfg.cluster, net, full, T, seed)),
        "plan": (sk.sharded_plan_summary_from_packed(
            mesh, params, cfg.cluster, plan, st, T, seed),
            mk.plan_megakernel_summary_from_packed(
                params, cfg.cluster, plan, full, T, seed)),
    }
    for entry, (sh, one) in pairs.items():
        assert isinstance(sh, Sharded) and sh.offsets == [0, 16, 32, 48]
        assert _equal(gather(sh), one) == [], entry
    # The offset reaches the interruption draws: at a high interruption
    # rate, shard 1 launched as cluster 0 is another world.
    hot = params._replace(interrupt_p_step=torch.tensor(0.5))
    at0, at16 = (mk.megakernel_summary_from_packed(
        hot, off, peak, st.parts[1], T, seed, cluster0=c0) for c0 in (0, 16))
    assert _equal(at0, at16)


def test_trace_entries_population_and_checks(worlds):
    """The trace-taking entries on [B, T] traces, the population axis,
    donation and the per-shard batch checks (JAX's messages)."""
    src, cfg = worlds["plain"]
    net = worlds["net"]
    mesh = make_mesh(devices=["cpu"] * 2)
    params = SimParams.from_config(cfg, device="cpu")
    off, peak = offpeak_action(cfg.cluster, "cpu"), peak_action(cfg.cluster, "cpu")
    traces = src.batch_trace(6, range(3, 35), device="cpu")
    got = sk.sharded_megakernel_rollout_summary(mesh, params, off, peak,
                                                traces, 4)
    assert _equal(gather(got), mk.megakernel_rollout_summary(
        params, off, peak, traces, 4, device="cpu")) == []
    got = sk.sharded_carbon_megakernel_rollout_summary(
        mesh, params, off, peak, traces, 4)
    assert _equal(gather(got), mk.carbon_megakernel_rollout_summary(
        params, off, peak, traces, 4, device="cpu")) == []
    pop = mk._tree_map(lambda x: np.stack([x, 0.5 * np.asarray(x)]), net)
    got = sk.sharded_neural_megakernel_rollout_summary(
        mesh, params, cfg.cluster, pop, traces, 4)
    want = mk.neural_megakernel_rollout_summary(params, cfg.cluster, pop,
                                                traces, 4, device="cpu")
    assert tuple(gather(got).cost_usd.shape) == (2, 32)
    assert _equal(gather(got), want) == []
    st = sk.sharded_packed_trace(mesh, src, 6, 2, 4)
    s, back = sk.sharded_megakernel_summary_from_packed(
        mesh, params, off, peak, st, 6, donate_stream=True)
    assert back is st
    again = sk.sharded_packed_trace(mesh, src, 6, 3, 4, recycle=back)
    assert [p.data_ptr() for p in again.parts] == \
        [p.data_ptr() for p in st.parts]
    assert sk.shard_seed(5, 3, 8) == (5, 24)
    want = _msg(lambda: jpar.sharded_kernel._split_batch(6, 4, 1,
                                                         "stream"))
    with pytest.raises(ConfigError) as err:
        sk.sharded_megakernel_summary_from_packed(
            make_mesh(devices=["cpu"] * 4), params, off, peak,
            torch.zeros(10, mk.exo_rows(4), 6), 10)
    assert str(err.value) == want


def test_jax_shard_local_arrays_through_both_sharded_entries():
    """JAX's shard-local stream (`sharded_packed_trace` over its 8
    virtual devices, keyed ``fold_in(key, shard)``) through JAX's sharded
    rule entry (interpret mode, deterministic) and the port's on the same
    arrays: every cluster within 2e-3 on every field."""
    jc = jcfg.PRESETS["default"]()
    tc = tcfg.PRESETS["default"]()
    jsrc = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    jmesh = jpar.make_mesh(devices=jax.devices()[:8])
    B, T = 16, 8
    jst = jpar.sharded_packed_trace(jmesh, jsrc, T, jax.random.key(3), B,
                                    t_chunk=8)
    want = jpar.sharded_megakernel_summary_from_packed(
        jmesh, JSimParams.from_config(jc), joff(jc.cluster),
        jpeak(jc.cluster), jst, T, 3, stochastic=False, b_block=2,
        t_chunk=8, interpret=True)
    stream = torch.from_numpy(np.array(jst))
    mesh = make_mesh(devices=CPU8)
    params = SimParams.from_config(tc, device="cpu")
    got = gather(sk.sharded_megakernel_summary_from_packed(
        mesh, params, offpeak_action(tc.cluster, "cpu"), peak_action(tc.cluster, "cpu"),
        stream, T, 3, stochastic=False))
    for f in got._fields:
        a = getattr(got, f).double().numpy()
        b = np.asarray(getattr(want, f), np.float64)
        assert np.all(np.abs(a - b) <= PER_CLUSTER_TOL * (np.abs(b) + 1e-3)
                      ), f


# ---- streaming over the mesh ----------------------------------------------


@pytest.mark.parametrize("mode", ("rule", "carbon", "neural", "plan"))
def test_streaming_mesh_bitwise_single_device(worlds, mode):
    """Mixed stream, B = 32 on 2 shards, T = 20 in blocks of 8: both
    drives over the mesh equal the single-device drive over the
    concatenated shard blocks (`ShardBlocks`), bitwise."""
    src, cfg = worlds["mixed"]
    mesh = make_mesh(devices=["cpu"] * 2)
    params = SimParams.from_config(cfg, device="cpu")
    kw = dict(key=5, batch=32, T=20, block_T=8, seed=2, t_chunk=8,
              net_params=worlds["net"] if mode == "neural" else None,
              plan_packed=_random_plan(cfg, 32, 24) if mode == "plan"
              else None, device="cpu")
    one, _ = stm.streaming_rollout_summary(
        sk.ShardBlocks(src, 2), params, cfg.cluster, mode, **kw)
    for pipelined in (False, True):
        got, rep = stm.streaming_rollout_summary(
            src, params, cfg.cluster, mode, mesh=mesh, pipelined=pipelined,
            **kw)
        assert _equal(got, one) == [], (mode, pipelined)
        assert rep["shards"] == 2 and len(rep["shard_wall_s"]) == 2
    if mode == "rule":
        with pytest.raises(ValueError, match="one chunk"):
            stm.streaming_rollout_summary(src, params, cfg.cluster, mode,
                                          mesh=mesh, shard=1, **kw)
        a, _ = stm.chunked_streaming_summary(
            src, params, cfg.cluster, "rule", chunk=16, mesh=mesh,
            **{k: v for k, v in kw.items()
               if k not in ("net_params", "plan_packed")})
        b, _ = stm.chunked_streaming_summary(
            src, params, cfg.cluster, "rule", chunk=16,
            **{k: v for k, v in kw.items()
               if k not in ("net_params", "plan_packed")})
        assert _equal(a, b) == []


def test_sharded_block_fns_through_the_registry(worlds):
    """The mode registry's ``sharded_block_summary`` slot: the bundle's
    step over Sharded blocks and states equals the shards' own bundles."""
    src, cfg = worlds["plain"]
    mesh = make_mesh(devices=["cpu"] * 2)
    params = SimParams.from_config(cfg, device="cpu")
    assert lanes.resolve_mode("rule").sharded_block_summary is not None
    fns = sk.sharded_packed_mode_block_summary_fn(
        mesh, params, cfg.cluster, "rule", T=16, block_T=8, batch=32,
        t_chunk=8)
    state = fns.init_state(src.packed_rows())
    nxt = fns.init_state(src.packed_rows())
    for j in range(fns.n_blocks):
        blk = sk.sharded_block_packed_trace(mesh, src, 8, 3, 32, j,
                                            t_chunk=8)
        out, state_new = fns.step(blk, state, j, 1, state_out=nxt)
        state, nxt = state_new, state
    got = gather(fns.finalize(out))
    want, _ = stm.streaming_rollout_summary(
        sk.ShardBlocks(src, 2), params, cfg.cluster, "rule", key=3,
        batch=32, T=16, block_T=8, seed=1, t_chunk=8, device="cpu")
    assert _equal(got, want) == []


# ---- CEM over the mesh ----------------------------------------------------


def test_cem_mesh_errors_match_jax_and_generation_is_bitwise():
    tc = tcfg.PRESETS["default"]()
    jc = jcfg.PRESETS["default"]()
    src = SyntheticSignalSource(tc.cluster, tc.workload, tc.sim, tc.signals)
    jsrc = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    from ccka_tpu_torch import bridge
    from ccka_tpu_torch.train.ppo import PPOTrainer

    params0 = bridge.actor_critic_to_flax(
        PPOTrainer(tc, device="cpu").init_state(0).params)
    jmesh = jpar.make_mesh(devices=jax.devices()[:4])
    mesh = make_mesh(devices=["cpu"] * 4)

    class Replay:   # a source that cannot synthesize per shard
        packed_trace_device = src.packed_trace_device

    for G, source, jsource in ((6, src, jsrc), (256, Replay(), Replay()),
                               (256, src, jsrc)):
        c = cem.CEMConfig(generations=1, popsize=2, traces_per_gen=G,
                          eval_steps=4)
        jc_ = jcem.CEMConfig(generations=1, popsize=2, traces_per_gen=G,
                             eval_steps=4)
        want = _msg(lambda: jcem.cem_refine(jc, params0, jsource, cem=jc_,
                                            engine="mega", mesh=jmesh))
        with pytest.raises(ValueError) as err:
            cem.cem_refine(tc, params0, source, cem=c, engine="mega",
                           mesh=mesh, device="cpu")
        assert str(err.value) == want

    # One generation on a 2-shard mesh, G = 256 (128 a shard), against a
    # single-device generation on the gathered streams.
    mesh2 = make_mesh(devices=["cpu"] * 2)
    c = cem.CEMConfig(generations=1, popsize=3, traces_per_gen=256,
                      eval_steps=4, sigma0=0.5, head_only=False)
    dim = cem._flatten(params0)[0].shape[0]
    st = sk.sharded_packed_trace(mesh2, src, 4, 41, 256)
    noise = torch.randn((2, dim), generator=torch.Generator().manual_seed(1))
    out_m = cem.cem_refine(tc, params0, src, cem=c, engine="mega",
                           mesh=mesh2, device="cpu",
                           draws=lambda g: cem.CEMDraws(st, 77, noise))
    out_1 = cem.cem_refine(tc, params0, src, cem=c, engine="mega",
                           device="cpu",
                           draws=lambda g: cem.CEMDraws(gather(st), 77,
                                                        noise))
    assert out_m[1] == out_1[1]
    assert torch.equal(cem._flatten(out_m[0])[0], cem._flatten(out_1[0])[0])


# ---- the planners over the mesh -------------------------------------------


def test_planners_mesh_bitwise_and_donation(worlds):
    src, cfg = worlds["plain"]
    mesh = make_mesh(devices=["cpu"] * 4)
    params = SimParams.from_config(cfg, device="cpu")
    N, H = 8, 8
    traces = mk.unpack_exo(src.packed_trace_device(H, 3, N, device="cpu"),
                           H, cfg.cluster.n_zones)
    st = initial_state(cfg, N, "cpu")
    lat0 = zero_latent(cfg.cluster, "cpu")
    buf = lat0.expand(N, H, *lat0.shape).clone()
    want = optimize_plan_batch(params, cfg.cluster, cfg.train, st, traces,
                               buf.clone(), iters=2)
    got = optimize_plan_batch(params, cfg.cluster, cfg.train, st, traces,
                              buf, iters=2, mesh=mesh, donate_plans=True)
    assert torch.equal(gather(got.plan_latent), want.plan_latent)
    assert torch.equal(gather(got.losses), want.losses)
    assert torch.equal(buf, want.plan_latent)
    assert [p.data_ptr() for p in got.plan_latent.parts] == \
        [buf[i * 2].data_ptr() for i in range(4)]
    init = lat0.expand(N, 4, *lat0.shape)
    kw = dict(horizon=4, replan_every=4, iters=1)
    assert torch.equal(
        gather(receding_horizon_plan_batch(params, cfg.cluster, cfg.train,
                                           st, traces, init, mesh=mesh,
                                           **kw)),
        receding_horizon_plan_batch(params, cfg.cluster, cfg.train, st,
                                    traces, init, **kw))
    jmesh = jpar.make_mesh(devices=jax.devices()[:4])
    want = _msg(lambda: jmpc._check_mesh_batch(jmesh, 6,
                                               "optimize_plan_batch"))
    with pytest.raises(ValueError) as err:
        optimize_plan_batch(params, cfg.cluster, cfg.train,
                            initial_state(cfg, 6, "cpu"), traces,
                            lat0.expand(6, H, *lat0.shape), mesh=mesh)
    assert str(err.value) == want


# ---- occupancy ------------------------------------------------------------


def test_occupancy_entries_on_fake_stages():
    """`tests/test_perf_obs.py::TestOccupancy`'s cases: the ledger's
    fractions, the imbalance arithmetic, a measured pipeline on fake
    stages and per-shard fenced spans."""
    for ts in ([1.0, 1.0, 1.0], [1.0, 1.0, 2.0], [], [0.0, 0.0]):
        assert occ.shard_imbalance(ts) == jocc.shard_imbalance(ts)
    rng = np.random.default_rng(0)
    for _ in range(16):
        assert occ.shard_imbalance(rng.uniform(0.1, 5.0, size=8)) >= 1.0
    tracer = SpanTracer()
    ledger, host_out = occ.measure_packed_pipeline(
        lambda i: torch.full((4,), float(i)),
        lambda s, i: s * 2 + i,
        lambda out: float(out.mean()),
        repeats=2, tracer=tracer, label="test.pipe")
    fr = ledger.fractions()
    assert set(fr) == set(occ.PIPELINE_STAGES) and ledger.repeats == 2
    assert sum(fr.values()) == pytest.approx(1.0)
    assert host_out == 3.0
    cats = {sp.name: sp.cat for sp in tracer.spans()}
    assert cats["test.pipe.generation"] == "device"
    assert cats["test.pipe.kernel"] == "device"
    assert cats["test.pipe.host"] == "host"
    times = occ.measure_shard_times(lambda i: torch.ones(3) * i, 4,
                                    tracer=tracer, label="test.shard")
    assert len(times) == 4 and all(t >= 0 for t in times)
    assert [sp.name for sp in tracer.spans()][-4:] == [
        f"test.shard.{i}" for i in range(4)]
    with pytest.raises(RuntimeError, match="without a fence"):
        occ.measure_shard_times(lambda i: None, 1, tracer=tracer)


# ---- the lane-family registry ---------------------------------------------

_TEST_TAG, _TEST_NAME = 0x7E571, "testlane"


def _test_rows(Z: int) -> int:
    return 2 * lanes.fault_rows(Z) + 16


def _test_generate(cfg, generator, steps, t_pad, z, batch, *, ctx, out):
    out.zero_()
    out[:steps] = cfg * torch.rand((steps, _test_rows(z), batch),
                                   generator=generator,
                                   device=generator.device)


@pytest.fixture
def testlane():
    fam = lanes.register_lane_family(_TEST_NAME, rows=_test_rows,
                                     key_tag=_TEST_TAG)
    lanes.provide_lane_generator(_TEST_NAME, _test_generate)
    yield fam
    lanes.unregister_lane_family(_TEST_NAME)


def test_lane_family_registry_refusals_match_jax():
    from ccka_tpu.sim import lanes as jlanes

    before = lanes.LANE_FAMILIES
    cases = (("faults", lanes.fault_rows, 0x123),
             ("dup-tag", lambda z: 64, 0xFA117),
             ("clash", lanes.fault_rows, 0x999))
    for name, rows, tag in cases:
        want = _msg(lambda: jlanes.register_lane_family(
            name, rows=rows, key_tag=tag))
        with pytest.raises(ValueError) as err:
            lanes.register_lane_family(name, rows=rows, key_tag=tag)
        assert str(err.value).split(":")[0] == want.split(":")[0]
        assert lanes.LANE_FAMILIES == before
    with pytest.raises(ValueError, match="takes no generator"):
        lanes.provide_lane_generator("faults", _test_generate)
    with pytest.raises(ValueError, match="takes no generator"):
        lanes.lane_generator("nonesuch")
    with pytest.raises(ValueError, match="built in"):
        lanes.unregister_lane_family("faults")


def test_registered_family_reaches_synthesis_and_the_mesh(testlane,
                                                          worlds):
    """A family registered through the registry alone widens the
    synthetic stream (its block from the family's own generator, the exo
    rows unchanged), resolves from its row count, and rides the sharded
    entries bitwise the unsharded ones; unregistering restores the
    registry."""
    _, cfg = worlds["plain"]
    assert [f.name for f in lanes.LANE_FAMILIES][-1] == _TEST_NAME
    plain = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                  cfg.signals)
    wide = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals, extra_lanes={_TEST_NAME: 0.5})
    Z = cfg.cluster.n_zones
    a = plain.packed_trace_device(8, 4, 4, device="cpu")
    b = wide.packed_trace_device(8, 4, 4, device="cpu")
    assert b.shape[1] == a.shape[1] + _test_rows(Z)
    assert torch.equal(b[:, :a.shape[1]], a)
    lay = lanes.resolve_layout(b.shape[1], Z)
    assert lay.families == (_TEST_NAME,)
    from ccka_tpu_torch.signals.synthetic import family_generator

    ref = torch.empty((8, _test_rows(Z), 4))
    _test_generate(0.5, family_generator(4, _TEST_TAG, "cpu"), 8, 8, Z, 4,
                   ctx={}, out=ref)
    assert torch.equal(b[:, a.shape[1]:], ref)
    mesh = make_mesh(devices=["cpu"] * 2)
    params = SimParams.from_config(cfg, device="cpu")
    off, peak = offpeak_action(cfg.cluster, "cpu"), peak_action(cfg.cluster, "cpu")
    sh = gather(sk.sharded_megakernel_summary_from_packed(
        mesh, params, off, peak, b, 8, 3))
    assert _equal(sh, mk.megakernel_summary_from_packed(
        params, off, peak, a, 8, 3)) == []


# ---- the factory over the mesh --------------------------------------------


def test_factory_cell_on_a_mesh_is_the_cell_on_its_worlds():
    """`produce_cell(mesh=)` (2 shards of 16 pairs): its planner and its
    labels see the worlds the mesh's streaming drive makes, so the cell
    equals a single-device cell fed those worlds (`ShardBlocks`), plans,
    labels and the rule column bitwise."""
    from ccka_tpu_torch.train import factory
    from ccka_tpu_torch.workloads.scenarios import resolve_scenarios

    tc = tcfg.PRESETS["default"]()
    scen = resolve_scenarios(["mixed"])["mixed"]
    kw = dict(pairs=32, steps=16, block_T=16, t_chunk=16, iters=2, seed=3,
              device="cpu")
    a = factory.produce_cell(tc, scen, "off",
                             mesh=make_mesh(devices=["cpu"] * 2), **kw)
    worlds = factory._cell_stream(
        sk.ShardBlocks(factory._cell_source(tc, scen, "off"), 2), steps=16,
        block_T=16, t_chunk=16, pairs=32, key=3, device=torch.device("cpu"))
    b = factory.produce_cell(tc, scen, "off", worlds=worlds, **kw)
    assert torch.equal(a.plan_latents, b.plan_latents)
    assert _equal(a.teacher_summary, b.teacher_summary) == []
    assert _equal(a.rule_summary, b.rule_summary) == []
