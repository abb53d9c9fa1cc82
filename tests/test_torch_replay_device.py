"""The port's replay device samplers against the JAX package's.

The two packages draw their window offsets from different random streams
(a ``torch.Generator`` against ``jax.random``), so each comparison hands
both sources the same explicit offsets through their ``_window_offsets``.
Standards: windows and packed exo rows bitwise (a gather and a transpose
of the same float32 store); the blocked stream's exo rows bitwise the
unblocked stream's; the workload lanes' clock is the one the offsets
give. The trainers are driven on the CPU at a tiny size.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccka_tpu_torch.config as tcfg
from ccka_tpu.sim.megakernel import _pack_exo as j_pack_exo
from ccka_tpu.signals.replay import ReplaySignalSource as JReplay
from ccka_tpu_torch.signals.replay import ReplaySignalSource
from ccka_tpu_torch.signals.synthetic import family_generator
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim.megakernel import _pack_exo
from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(ROOT, "data", "replay_train_9day.npz")
CPU = torch.device("cpu")
# Offsets that start mid-store, at the store's last tick (the window wraps
# into the tiled extension) and at 0.
OFFS = np.array([0, 1234, 25919, 7000, 13, 25000], np.int64)


def _pinned(jsrc, tsrc, offs):
    jsrc._window_offsets = lambda key, n: jnp.asarray(offs[:n], jnp.int32)
    tsrc._window_offsets = lambda g, n: torch.as_tensor(offs[:n])


def _sources(**kw):
    return JReplay.from_file(STORE, **kw), ReplaySignalSource.from_file(
        STORE, **kw)


def test_windows_bitwise_jax_at_the_same_offsets():
    jsrc, tsrc = _sources()
    _pinned(jsrc, tsrc, OFFS)
    steps = 96
    jtr = jsrc.batch_trace_device(steps, jax.random.key(0), len(OFFS))
    ttr = tsrc.batch_trace_device(steps, torch.Generator(), len(OFFS),
                                  device="cpu")
    for name, jx, tx in zip(ttr._fields, jtr, ttr):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx), name)
    # Against the host windows of the stored trace itself.
    ext = tsrc._trace_at(0, tsrc._trace.steps + steps)
    for i, o in enumerate(OFFS):
        host = ext.slice_steps(int(o), steps)
        for tx, hx in zip(ttr, host):
            assert torch.equal(tx[i], hx)


@pytest.mark.parametrize("t_pad", [96, 128])
def test_packed_exo_rows_bitwise_jax_pack(t_pad):
    jsrc, tsrc = _sources()
    _pinned(jsrc, tsrc, OFFS)
    steps = 96
    jtr = jsrc.batch_trace_device(steps, jax.random.key(0), len(OFFS))
    stream = tsrc.packed_trace_device(steps, 5, len(OFFS), t_pad=t_pad,
                                      device="cpu")
    assert tuple(stream.shape) == (t_pad, lanes.exo_rows(
        tsrc._trace.n_zones), len(OFFS))
    np.testing.assert_array_equal(stream.numpy(),
                                  np.asarray(j_pack_exo(jtr, t_pad)))
    # The port's own pack of its own windows, and JAX's packed sampler.
    ttr = tsrc.batch_trace_device(steps, torch.Generator(), len(OFFS),
                                  device="cpu")
    assert torch.equal(stream, _pack_exo(ttr, t_pad))
    jstream = jsrc.packed_trace_device(steps, jax.random.key(0), len(OFFS),
                                       t_chunk=32)
    np.testing.assert_array_equal(stream[:steps].numpy(),
                                  np.asarray(jstream)[:steps])


def test_packed_stream_is_the_batch_windows_of_the_seed():
    """Unpinned: the packed stream replays the windows whose offsets come
    from the seed's exo generator, and ``out=`` writes the same stream."""
    src = ReplaySignalSource.from_file(STORE)
    steps, n = 64, 8
    stream = src.packed_trace_device(steps, 11, n, device="cpu")
    tr = src.batch_trace_device(steps, family_generator(11, None, CPU), n,
                                device="cpu")
    assert torch.equal(stream, _pack_exo(tr, steps))
    out = torch.full_like(stream, float("nan"))
    assert src.packed_trace_device(steps, 11, n, out=out) is out
    assert torch.equal(out, stream)
    other = src.packed_trace_device(steps, 12, n, device="cpu")
    assert not torch.equal(other, stream)


@pytest.mark.parametrize("widen", [False, True])
def test_blocked_exo_rows_concatenate_to_the_unblocked(widen):
    kw = {}
    if widen:
        kw = dict(faults=tcfg.FAULT_PRESETS["mild"],
                  workloads=WORKLOAD_SCENARIOS["mixed"].workloads)
    src = ReplaySignalSource.from_file(STORE, **kw)
    block_T, n_blocks, n = 32, 4, 8
    T = block_T * n_blocks
    z = src._trace.n_zones
    rows = lanes.exo_rows(z)
    full = src.packed_trace_device(T, 21, n, device="cpu")
    blocks = [src.packed_block_trace_device(
        block_T, 21, n, j, total_steps=T, t_chunk=32, device="cpu")
        for j in range(n_blocks)]
    assert all(b.shape[1] == src.packed_rows() for b in blocks)
    assert torch.equal(torch.cat(blocks)[:, :rows], full[:, :rows])
    # Without total_steps (the streaming pipeline's call) and through out=.
    out = torch.empty_like(blocks[2])
    again = src.packed_block_trace_device(block_T, 21, n, 2, out=out,
                                          t_chunk=32)
    assert again is out and torch.equal(out, blocks[2])
    # A shard samples its own windows.
    sh = src.packed_block_trace_device(block_T, 21, n, 0, shard=1,
                                       t_chunk=32, device="cpu")
    assert not torch.equal(sh[:, :rows], blocks[0][:, :rows])


def test_blocked_exo_rows_bitwise_jax_blocks():
    jsrc, tsrc = _sources()
    _pinned(jsrc, tsrc, OFFS)
    block_T, T = 32, 96
    for j in range(3):
        jb = jsrc.packed_block_trace_device(block_T, jax.random.key(0),
                                            len(OFFS), j, total_steps=T,
                                            t_chunk=32)
        tb = tsrc.packed_block_trace_device(block_T, 0, len(OFFS), j,
                                            total_steps=T, t_chunk=32,
                                            device="cpu")
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    with pytest.raises(ValueError, match="t_chunk"):
        tsrc.packed_block_trace_device(48, 0, 4, 0, t_chunk=32,
                                       device="cpu")


def test_workload_lanes_are_phased_by_the_window_offsets():
    """The packed workload lanes are the lanes of the same latents on the
    clock the window offsets give (wrapped with the store), and that clock
    is the JAX package's formula."""
    from ccka_tpu_torch.workloads.process import (
        _time_of_day, draw_workload_latents, workload_lanes_from_latents)

    wl = WORKLOAD_SCENARIOS["mixed"].workloads
    src = ReplaySignalSource.from_file(STORE, workloads=wl)
    offs = torch.as_tensor(OFFS)
    src._window_offsets = lambda g, n: offs[:n]
    steps, n = 64, len(OFFS)
    z = src._trace.n_zones
    stream = src.packed_trace_device(steps, 3, n, device="cpu")
    dt = src.meta().dt_s
    stored = src._trace.steps
    lat = draw_workload_latents(wl, family_generator(
        3, lanes.WORKLOAD_KEY_TAG, CPU), steps, n)
    want = workload_lanes_from_latents(
        wl, lat, steps, steps, z, dt_s=dt,
        start_unix_s=src.meta().start_unix_s,
        start_offset_s=offs.to(torch.float32) * dt,
        wrap_period_s=stored * dt)
    wb = lanes.workload_base(stream.shape[1], z)
    assert torch.equal(stream[:, wb:], want)
    # The clock against the JAX package's formula (float32 throughout).
    f32 = np.float32
    t_rel = (np.arange(steps, dtype=np.float64) * dt).astype(f32)[:, None] \
        + (OFFS.astype(f32) * f32(dt))[None, :]
    t_rel = np.mod(t_rel, f32(stored * dt))
    tt = f32(src.meta().start_unix_s % 86400.0) + np.mod(t_rel, f32(86400.0))
    jtod = np.asarray(jnp.mod(jnp.asarray(tt), 86400.0) / 86400.0)
    tod = _time_of_day(steps, n, dt, src.meta().start_unix_s,
                       offs.to(torch.float32) * dt, stored * dt, CPU)
    np.testing.assert_array_equal(tod.numpy(), jtod)
    # Distinct offsets phase the lanes apart; the exo rows ignore lanes.
    assert not torch.equal(stream[:, wb, 0], stream[:, wb, 1])
    plain = ReplaySignalSource.from_file(STORE)
    plain._window_offsets = lambda g, n: offs[:n]
    rows = lanes.exo_rows(z)
    assert torch.equal(plain.packed_trace_device(steps, 3, n, device="cpu"),
                       stream[:, :rows])


def test_sharding_refuses_and_the_flag_stays_false():
    src = ReplaySignalSource.from_file(STORE)
    assert src.supports_device_traces is False
    with pytest.raises(SystemExit, match="sharding"):
        src.batch_trace_device(8, torch.Generator(), 2, device="cpu",
                               sharding=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            src.packed_trace_device(8, 0, 2)


def _tiny_params(cfg):
    from ccka_tpu_torch import bridge
    from ccka_tpu_torch.train.ppo import PPOTrainer

    trainer = PPOTrainer(cfg, device="cpu")
    return bridge.actor_critic_to_flax(trainer.init_state(seed=0).params)


@pytest.mark.parametrize("engine", ["lax", "mega"])
def test_cem_refine_takes_a_replay_source(engine):
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.train import cem

    cfg = tcfg.default_config()
    src = ReplaySignalSource.from_file(STORE)
    params0 = _tiny_params(cfg)
    G = 2 if engine == "lax" else 128
    best, hist, _ = cem.cem_refine(
        cfg, params0, src, cem=cem.CEMConfig(
            generations=2, popsize=2, traces_per_gen=G, eval_steps=8),
        engine=engine, teacher_policy=CarbonAwarePolicy(cfg.cluster,
                                                        device="cpu"),
        seed=1, device="cpu")
    assert len(hist) == 2
    assert all(np.isfinite(h["incumbent_fitness"]) for h in hist)
    assert set(best["params"]) == set(params0["params"])


def test_streaming_and_training_windows_take_a_replay_source():
    """The streaming pipeline's block loop and PPO's device windows read a
    replay source through the synthetic backend's signatures."""
    from ccka_tpu_torch.sim.streaming import streaming_rollout_summary
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train.ppo import PPOTrainer

    cfg = tcfg.default_config()
    src = ReplaySignalSource.from_file(STORE)
    params = SimParams.from_config(cfg, device="cpu")
    summary, _ = streaming_rollout_summary(
        src, params, cfg.cluster, "rule", key=3, batch=4, T=64, block_T=32,
        t_chunk=16, device="cpu")
    assert np.isfinite(summary.cost_usd.numpy()).all()
    trainer = PPOTrainer(cfg.with_overrides(**{
        "train.device_traces": True, "train.batch_clusters": 3}),
        device="cpu")
    win = trainer.make_windows(src, 2, seed=4)
    assert tuple(win.is_peak.shape) == (3, 2 * trainer.tcfg.unroll_steps + 1)
