"""The rollout kernels over the device mesh.

The PyTorch form of `ccka_tpu/parallel/sharded_kernel.py`: every packed
entry of `sim/megakernel.py` (rule, carbon, the MLP population, plan
playback), the trace-taking entries and the carried-state block bundle,
with the cluster batch (a stream's last axis) split over the mesh's
``data`` axis. Each shard's launch runs on its device, in shard order; the
results come back per shard (`parallel/mesh.py::Sharded`).

- **Global cluster offset, not seed arithmetic.** The port's Philox
  stream is addressed by (seed, global cluster, global tick, row)
  (`sim/random.py`), and every kernel launch takes ``b0``, the global
  index of its first cluster (`kernels/build.py`; the non-carry C entries
  gained the argument, 0 at every unsharded call). Shard ``i`` of ``n``
  over a batch ``B`` launches with ``b0 = i * B / n`` and the caller's
  seed unchanged, so its clusters draw exactly what one launch over the
  concatenated batch draws for them: a sharded run is bitwise the single
  launch, field by field and cluster by cluster. The JAX package's
  ``shard_seed`` (kernel seed + shard × blocks × ``SEED_BLOCK_STRIDE``)
  has no arithmetic counterpart: :func:`shard_seed` keeps its name and
  returns the pair ``(seed, b0)`` a shard's launch is keyed by.
- **Shard-local synthesis.** :func:`sharded_packed_trace` synthesizes
  shard ``i``'s lane block on its own device from
  :func:`shard_key` ``(key, i)``, the words (``key``, ``SHARD_KEY_TAG``,
  ``i``) mixed by ``np.random.SeedSequence`` (the counterpart of JAX's
  ``fold_in(key, shard)``): no stream crosses devices.
  :func:`sharded_block_packed_trace` makes block ``j`` of shard ``i`` as
  the streaming pipeline's chunk ``i`` makes it
  (`signals/synthetic.py::block_seed(key, j, shard=i)`).
- **Donation.** ``donate_stream=True`` returns ``(summary, stream)``;
  ``sharded_packed_trace(recycle=stream)`` writes the next stream into the
  same per-shard buffers, so back-to-back generations hold one stream per
  shard.

The per-shard batch checks keep the JAX package's messages
(:func:`_split_batch`). A shard's plain version on the CPU is the same
entry's plain version with the same ``cluster0``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ccka_tpu_torch.config import ConfigError
from ccka_tpu_torch.parallel.mesh import (Mesh, Sharded, data_shards,
                                          replicate, split_parts)
from ccka_tpu_torch.sim import lanes

# The words (key, SHARD_KEY_TAG, shard) seed shard-local synthesis.
SHARD_KEY_TAG = 0x5A4D


def shard_key(key: int, shard: int) -> int:
    """The synthesis seed of shard ``shard`` of a stream keyed ``key``:
    (``key``, :data:`SHARD_KEY_TAG`, ``shard``) mixed by
    ``np.random.SeedSequence``, as `signals/synthetic.py::block_seed`
    mixes a block's words."""
    return int(np.random.SeedSequence(
        [int(key), SHARD_KEY_TAG, int(shard)]).generate_state(
            1, np.uint64)[0])


def shard_seed(seed: int, shard_index: int, shard_batch: int) -> tuple:
    """What shard ``shard_index``'s launch is keyed by: ``(seed, b0)``,
    the caller's Philox seed unchanged and ``b0 = shard_index *
    shard_batch``, its first cluster's global index (module docstring)."""
    return int(seed), int(shard_index) * int(shard_batch)


def _split_batch(B: int, n: int, what: str) -> int:
    if B % n:
        raise ConfigError(
            f"sharded kernel: {what} batch {B} not divisible by "
            f"{n} data shards")
    return B // n


def shard_lane_blocks(exo_packed: torch.Tensor, n_shards: int) -> list:
    """Per-shard lane blocks of a packed ``[T_pad, rows, B]`` stream: the
    contiguous batch blocks each data shard owns, in shard order (views;
    `obs/occupancy.py::measure_shard_times` runs block ``i`` through the
    single-device entry with ``cluster0 = i * B / n``)."""
    _T_pad, _rows, B = exo_packed.shape
    b_loc = _split_batch(B, n_shards, "stream")
    return [exo_packed[:, :, i * b_loc:(i + 1) * b_loc]
            for i in range(n_shards)]


def _stream_parts(mesh: Mesh, exo, what: str = "stream") -> Sharded:
    """A stream as per-shard contiguous parts on the shards' devices: a
    :class:`Sharded` passes through (checked), a whole ``[T_pad, rows,
    B]`` tensor is split on its last axis."""
    n = data_shards(mesh)
    if isinstance(exo, Sharded):
        if len(exo.parts) != n:
            raise ConfigError(f"sharded kernel: {what} has "
                              f"{len(exo.parts)} parts, the mesh {n} "
                              f"data shards")
        _split_batch(exo.size, n, what)
        return exo
    _split_batch(exo.shape[-1], n, what)
    return split_parts(mesh, exo, axis=-1).map(lambda x: x.contiguous())


def _run_shards(mesh: Mesh, stream: Sharded, launch) -> Sharded:
    """``launch(i, device, part, cluster0)`` per shard, in shard order;
    the results as a :class:`Sharded` on the batch (last) axis."""
    outs = [launch(i, dev, part, stream.offsets[i])
            for i, (dev, part) in enumerate(zip(mesh.data_devices(),
                                                stream.parts))]
    return Sharded(outs, stream.offsets, mesh, axis=-1)


# ---- shard-local synthesis ----------------------------------------------


def sharded_packed_trace(mesh: Mesh, source, steps: int, key: int,
                         batch: int, *, t_pad: int | None = None,
                         recycle: Sharded | None = None) -> Sharded:
    """A ``[T_pad, packed_rows(), B]`` packed stream with ``B`` split over
    the mesh's ``data`` axis, each shard's block synthesized on its own
    device from the seed :func:`shard_key` ``(key, i)`` (module
    docstring). ``recycle`` (a dead same-shape stream, e.g. a
    ``donate_stream=True`` return) is written over in place."""
    n = data_shards(mesh)
    b_loc = _split_batch(batch, n, "trace")
    parts = [source.packed_trace_device(
        steps, shard_key(key, i), b_loc, t_pad=t_pad,
        out=None if recycle is None else recycle.parts[i], device=dev)
        for i, dev in enumerate(mesh.data_devices())]
    return Sharded(parts, [i * b_loc for i in range(n)], mesh, axis=-1)


def sharded_block_packed_trace(mesh: Mesh, source, block_T: int, key: int,
                               batch: int, block_index: int, *,
                               t_chunk: int = 64,
                               recycle: Sharded | None = None) -> Sharded:
    """Block ``block_index`` (``[block_T, packed_rows(), B]``) of the
    blocked stream family of ``key`` with ``B`` split over ``data``,
    shard ``i``'s lane block synthesized on its device as the streaming
    pipeline's chunk ``i`` (``shard=i``). ``recycle`` takes a dead block
    of the same shape: a drive's double buffer holds two blocks a shard."""
    n = data_shards(mesh)
    b_loc = _split_batch(batch, n, "trace")
    parts = [source.packed_block_trace_device(
        block_T, key, b_loc, block_index, shard=i, t_chunk=t_chunk,
        out=None if recycle is None else recycle.parts[i], device=dev)
        for i, dev in enumerate(mesh.data_devices())]
    return Sharded(parts, [i * b_loc for i in range(n)], mesh, axis=-1)


class ShardBlocks:
    """The blocks a mesh drive synthesizes, served as one source's over
    the whole batch: block ``j`` of ``batch`` clusters is the
    concatenation over shards ``i`` of ``source``'s block ``j`` of
    ``batch / n_shards`` clusters with ``shard=i``. The unsharded side of
    the mesh == single-device comparison (a blocked drive on one device
    over these blocks sees the worlds the mesh drive's shards see)."""

    def __init__(self, source, n_shards: int):
        self.source, self.n_shards = source, int(n_shards)

    def packed_rows(self) -> int:
        return self.source.packed_rows()

    def packed_block_trace_device(self, block_T, seed, batch, block_index,
                                  *, shard=None, out=None, t_chunk=64,
                                  device=None):
        if shard is not None:
            raise ValueError("ShardBlocks serves whole batches only")
        b_loc = _split_batch(batch, self.n_shards, "trace")
        block = torch.cat([self.source.packed_block_trace_device(
            block_T, seed, b_loc, block_index, shard=i, t_chunk=t_chunk,
            device=device if out is None else out.device)
            for i in range(self.n_shards)], dim=-1)
        return block if out is None else out.copy_(block)


# ---- the packed entries ---------------------------------------------------


def _placed(mesh: Mesh, tree):
    """``device -> tree`` on that device (one copy per distinct device)."""
    return replicate(mesh, tree).on


def sharded_megakernel_summary_from_packed(mesh: Mesh, params, off_action,
                                           peak_action, exo_packed, T: int,
                                           seed: int = 0, *,
                                           stochastic: bool = True,
                                           carbon: tuple | None = None,
                                           donate_stream: bool = False):
    """Rule-profile (or with ``carbon`` = (sharpness, min_weight,
    stickiness) carbon-aware) EpisodeSummary of a mesh-sharded packed
    stream: `megakernel_summary_from_packed` per shard with its global
    ``cluster0``. ``exo_packed``: a :class:`Sharded` stream or a whole
    ``[T_pad, rows, B]`` tensor (split here). Returns the summary with
    fields ``[B]`` per shard (``(summary, stream)`` with
    ``donate_stream``)."""
    from ccka_tpu_torch.sim import megakernel as mk

    stream = _stream_parts(mesh, exo_packed)
    p, off, peak = (_placed(mesh, x) for x in (params, off_action,
                                                peak_action))

    def launch(i, dev, part, c0):
        if carbon is None:
            return mk.megakernel_summary_from_packed(
                p(dev), off(dev), peak(dev), part, T, seed,
                stochastic=stochastic, cluster0=c0)
        return mk.carbon_megakernel_summary_from_packed(
            p(dev), off(dev), peak(dev), part, T, seed, sharpness=carbon[0],
            min_weight=carbon[1], stickiness=carbon[2],
            stochastic=stochastic, cluster0=c0)

    out = _run_shards(mesh, stream, launch)
    return (out, stream) if donate_stream else out


def sharded_carbon_summary_from_packed(mesh: Mesh, params, off_action,
                                       peak_action, exo_packed, T: int,
                                       seed: int = 0, *,
                                       sharpness: float = 10.0,
                                       min_weight: float = 0.05,
                                       stickiness: float = 1.0,
                                       stochastic: bool = True,
                                       donate_stream: bool = False):
    """The CarbonAwarePolicy variant (keyword defaults mirror the
    policy's), paired with the rule and neural entries on the same
    (stream, seed)."""
    return sharded_megakernel_summary_from_packed(
        mesh, params, off_action, peak_action, exo_packed, T, seed,
        stochastic=stochastic, donate_stream=donate_stream,
        carbon=(float(sharpness), float(min_weight), float(stickiness)))


def sharded_neural_summary_from_packed(mesh: Mesh, params, cluster,
                                       net_params, exo_packed, T: int,
                                       seed: int = 0, *,
                                       stochastic: bool = True,
                                       donate_stream: bool = False):
    """Population-MLP EpisodeSummary of a mesh-sharded packed stream: the
    weights (population axis included) on every shard's device, the
    batch split; every shard scores every member on its lane block, so a
    generation's members × traces fan out over the shards. Fields
    ``[NP, B]`` per shard on the batch axis (``[B]`` for one net)."""
    from ccka_tpu_torch.sim import megakernel as mk

    stream = _stream_parts(mesh, exo_packed)
    p = _placed(mesh, params)
    nets = _placed(mesh, net_params)
    out = _run_shards(mesh, stream, lambda i, dev, part, c0:
                      mk.neural_megakernel_summary_from_packed(
                          p(dev), cluster, nets(dev), part, T, seed,
                          stochastic=stochastic, cluster0=c0))
    return (out, stream) if donate_stream else out


def shard_plan_stream(mesh: Mesh, plan_packed: torch.Tensor):
    """Place a packed plan (`sim/megakernel.py::pack_plan`) on the mesh:
    per-cluster ``[T_pad, rows, B]`` plans split on the batch axis (each
    shard's plans beside its lane block), broadcast ``[T_pad, rows]``
    plans replicated."""
    if isinstance(plan_packed, Sharded) or plan_packed.dim() == 2:
        return plan_packed if isinstance(plan_packed, Sharded) else \
            replicate(mesh, plan_packed)
    _split_batch(plan_packed.shape[-1], data_shards(mesh), "plan")
    return split_parts(mesh, plan_packed, axis=-1).map(
        lambda x: x.contiguous())


def sharded_plan_summary_from_packed(mesh: Mesh, params, cluster,
                                     plan_packed, exo_packed, T: int,
                                     seed: int = 0, *,
                                     stochastic: bool = True,
                                     donate_stream: bool = False):
    """Plan-playback EpisodeSummary of a mesh-sharded packed stream: a
    per-cluster plan split with the stream (:func:`shard_plan_stream`),
    a broadcast plan on every device; the same ``cluster0`` offsets as
    every sharded entry, so MPC-against-rule comparisons on one (stream,
    seed) survive sharding bitwise."""
    from ccka_tpu_torch.sim import megakernel as mk

    stream = _stream_parts(mesh, exo_packed)
    plans = shard_plan_stream(mesh, plan_packed)
    p = _placed(mesh, params)

    def launch(i, dev, part, c0):
        plan = plans.parts[i] if isinstance(plans, Sharded) else \
            plans.on(dev)
        return mk.plan_megakernel_summary_from_packed(
            p(dev), cluster, plan, part, T, seed, stochastic=stochastic,
            cluster0=c0)

    out = _run_shards(mesh, stream, launch)
    return (out, stream) if donate_stream else out


# ---- trace-taking entries (the pack runs per shard) -----------------------


def _trace_stream(mesh: Mesh, traces) -> Sharded:
    """``[B, T, ...]`` traces packed per shard on the shards' devices."""
    from ccka_tpu_torch.sim.megakernel import _pack_exo

    B, T = traces.is_peak.shape
    _split_batch(B, data_shards(mesh), "trace")
    return split_parts(mesh, traces, axis=0).map(
        lambda tr: _pack_exo(tr, T))


def sharded_megakernel_rollout_summary(mesh: Mesh, params, off_action,
                                       peak_action, traces, seed: int = 0, *,
                                       stochastic: bool = True,
                                       carbon: tuple | None = None):
    """`megakernel_rollout_summary` over the mesh: ``[B, T, ...]`` traces
    split on the batch axis, the pack and the kernel per shard. Prefer
    :func:`sharded_packed_trace` and the packed entries when the traces
    need not exist first."""
    T = traces.is_peak.shape[1]
    return sharded_megakernel_summary_from_packed(
        mesh, params, off_action, peak_action,
        _trace_stream(mesh, traces), T, seed,
        stochastic=stochastic, carbon=carbon)


def sharded_carbon_megakernel_rollout_summary(
        mesh: Mesh, params, off_action, peak_action, traces, seed: int = 0,
        *, sharpness: float = 10.0, min_weight: float = 0.05,
        stickiness: float = 1.0, stochastic: bool = True):
    """`carbon_megakernel_rollout_summary` over the mesh (see
    :func:`sharded_megakernel_rollout_summary`)."""
    return sharded_megakernel_rollout_summary(
        mesh, params, off_action, peak_action, traces, seed,
        stochastic=stochastic,
        carbon=(float(sharpness), float(min_weight), float(stickiness)))


def sharded_neural_megakernel_rollout_summary(
        mesh: Mesh, params, cluster, net_params, traces, seed: int = 0, *,
        stochastic: bool = True):
    """`neural_megakernel_rollout_summary` over the mesh: the weights on
    every shard's device, the traces split and packed per shard. Fields
    ``[NP, B]``."""
    T = traces.is_peak.shape[1]
    return sharded_neural_summary_from_packed(
        mesh, params, cluster, net_params,
        _trace_stream(mesh, traces), T, seed,
        stochastic=stochastic)


# ---- carried state over the mesh (the streaming pipeline's unit) ----------


class ShardedBlockSummaryFns(NamedTuple):
    """`sim/megakernel.py::BlockSummaryFns` over the mesh: ``step``,
    ``plain_step``, ``init_state`` and ``finalize`` take and return
    :class:`Sharded` values; ``shards`` holds each shard's single-device
    bundle with its device and first cluster, ``(fns, device,
    cluster0)``, for a drive that runs each shard's block loop itself
    (`sim/streaming.py`)."""

    step: object
    init_state: object
    finalize: object
    n_blocks: int
    T_pad: int
    plain_step: object
    shards: tuple


def sharded_packed_mode_block_summary_fn(mesh: Mesh, params, cluster,
                                         mode: str, *, T: int, block_T: int,
                                         batch: int, t_chunk: int = 64,
                                         stochastic: bool = True,
                                         net_params=None, plan_packed=None
                                         ) -> ShardedBlockSummaryFns:
    """The mesh form of `sim/megakernel.py::packed_mode_block_summary_fn`
    for a fleet of ``batch`` clusters: each shard's carried-state bundle
    on its device with ``cluster0`` its first cluster's global index, so
    a blocked sharded rollout is bitwise the single-device blocked
    rollout on the concatenated batch. Dispatched through the mode
    registry's ``sharded_block_summary`` slot (`sim/lanes.py`), which
    this module fills at import."""
    builder = lanes.mode_engine(mode, "sharded_block_summary")
    return builder(mesh, params, cluster, T=T, block_T=block_T,
                   batch=batch, t_chunk=t_chunk,
                   stochastic=stochastic, net_params=net_params,
                   plan_packed=plan_packed)


def _sharded_block_fns(mode: str, mesh: Mesh, params, cluster, *, T: int,
                       block_T: int, batch: int, t_chunk: int = 64,
                       stochastic: bool = True,
                       net_params=None,
                       plan_packed=None) -> ShardedBlockSummaryFns:
    """The registered ``sharded_block_summary`` builder of the four
    built-in modes: one single-device bundle a shard (a per-cluster plan
    split with the batch)."""
    from ccka_tpu_torch.sim.megakernel import packed_mode_block_summary_fn

    n = data_shards(mesh)
    b_loc = _split_batch(batch, n, "stream")
    p = _placed(mesh, params)
    plans = None
    if plan_packed is not None:
        plans = shard_plan_stream(mesh, plan_packed)
    shards = []
    for i, dev in enumerate(mesh.data_devices()):
        plan = None
        if plans is not None:
            plan = plans.parts[i] if isinstance(plans, Sharded) else \
                plans.on(dev)
        fns = packed_mode_block_summary_fn(
            p(dev), cluster, mode, T=T, block_T=block_T, t_chunk=t_chunk,
            stochastic=stochastic, net_params=net_params, plan_packed=plan)
        shards.append((fns, dev, i * b_loc))
    first = shards[0][0]
    offsets = [c0 for _, _, c0 in shards]

    def each(name):
        def run(stream_block: Sharded, state: Sharded, j: int, seed: int,
                *, state_out: Sharded):
            outs, states = [], []
            for i, (fns, _dev, c0) in enumerate(shards):
                o, s = getattr(fns, name)(
                    stream_block.parts[i], state.parts[i], j, seed,
                    state_out=state_out.parts[i], cluster0=c0)
                outs.append(o)
                states.append(s)
            return (Sharded(outs, offsets, mesh, axis=-1),
                    Sharded(states, offsets, mesh, axis=-1))
        return run

    def init_state(stream_rows: int, batch_: int = batch) -> Sharded:
        _split_batch(batch_, n, "stream")
        return Sharded([fns.init_state(stream_rows, batch_ // n, device=dev)
                        for fns, dev, _ in shards], offsets, mesh, axis=-1)

    def finalize(out: Sharded) -> Sharded:
        return Sharded([fns.finalize(o) for (fns, _, _), o in
                        zip(shards, out.parts)], offsets, mesh, axis=-1)

    return ShardedBlockSummaryFns(each("step"), init_state, finalize,
                                  first.n_blocks, first.T_pad,
                                  each("plain_step"), tuple(shards))


# The mesh engine of every built-in mode, on the mode registry.
for _m in ("rule", "carbon", "neural", "plan"):
    lanes.provide_mode_engine(_m, "sharded_block_summary",
                              functools.partial(_sharded_block_fns, _m))
del _m
