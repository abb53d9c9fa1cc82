"""The streaming rollout: a day in time blocks, synthesis beside the kernel.

The PyTorch form of `ccka_tpu/sim/streaming.py`. A fleet's packed stream
is split on the time axis into fixed blocks (`sim/lanes.py::block_layout`);
each block is synthesized on its own (`signals/synthetic.py::
packed_block_trace_device`, from the block's seed and at its global tick)
and consumed by the carried-state block entries of the rollout kernels
(`sim/megakernel.py::packed_mode_block_summary_fn`): the accumulators,
the held observation and the workload queues cross every block boundary
in the carried state, so a blocked rollout is bitwise the unblocked one on
the concatenated blocks.

- :func:`streaming_rollout_summary` drives the block loop two ways. The
  synchronous drive fences generation, the kernel and the host work of
  every block into an `obs/occupancy.py::OccupancyLedger`: the measured
  baseline, and the device's busy and idle shares. The double-buffered
  drive synthesizes block k+1 into the other of two preallocated stream
  buffers on a side CUDA stream while the kernel consumes block k on the
  current stream; events order the two (block k+1's synthesis waits for
  kernel k-1 to have read its buffer, kernel k waits for block k), and
  the host waits once, at the loop's end. Kernel k is enqueued before
  block k+1's synthesis: synthesis copies small host constants to the
  card, and each such copy makes the host wait for the side stream, so
  the kernel must already be queued for the card to overlap the two.
- :func:`chunked_streaming_summary` splits the cluster axis into equal
  chunks, each a whole block loop: chunk c synthesizes with ``shard=c``
  and passes its first cluster's global index to the kernel, so it is
  bitwise ``streaming_rollout_summary(shard=c, cluster0=c * chunk)``, and
  device memory holds two stream blocks of one chunk whatever the fleet.
- :func:`unblocked_reference_summary` concatenates the same blocks and
  runs the mode's non-carry entry over the whole horizon: the other side
  of the bitwise comparison.
- ``mesh=`` (`parallel/mesh.py`) splits the fleet over the mesh's data
  shards: shard ``i`` synthesizes its blocks as chunk ``i`` does
  (``shard=i``) on its device and runs its block loop through the mode's
  mesh engine (`parallel/sharded_kernel.py::
  sharded_packed_mode_block_summary_fn`) with ``cluster0`` its first
  cluster's global index, in shard order; the summaries are concatenated
  on the host. A mesh run is bitwise a single-device run over the
  concatenated shard blocks (`sharded_kernel.py::ShardBlocks`). The
  chunked drive with ``mesh=`` runs chunk ``c`` on data shard ``c mod
  n``'s device, bitwise the chunked drive on one device.

On the CPU the block entries run their plain versions and the two drives
the same loop (no streams).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.obs.occupancy import OccupancyLedger
from ccka_tpu_torch.obs.trace import SpanTracer
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim.megakernel import (EpisodeSummary,
                                           packed_mode_block_summary_fn,
                                           packed_mode_summary)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The checked time-block split of one streaming rollout."""

    T: int
    block_T: int
    t_chunk: int
    n_blocks: int
    T_pad: int


def plan_stream(T: int, block_T: int, t_chunk: int = 64) -> StreamPlan:
    """Check and freeze a block split: a block that is not a whole number
    of chunks, or blocks that do not tile the padded horizon, are refused
    here, before any buffer is allocated."""
    n_blocks, T_pad = lanes.block_layout(T, block_T, t_chunk)
    return StreamPlan(T, block_T, t_chunk, n_blocks, T_pad)


def _block_gen(source, plan: StreamPlan, batch: int, key: int, device, *,
               shard: int | None = None):
    """``gen(j, out=None) -> stream block j`` of the blocked stream family
    of ``key`` (chunk ``shard``'s, when given)."""
    def gen(j: int, out: torch.Tensor | None = None) -> torch.Tensor:
        return source.packed_block_trace_device(
            plan.block_T, key, batch, j, shard=shard, out=out,
            t_chunk=plan.t_chunk, device=device)
    return gen


def _to_host(summary: EpisodeSummary) -> EpisodeSummary:
    return EpisodeSummary(*(x.cpu() for x in summary))


def _run_group(gen, fns, rows: int, batch: int, seed: int, device, *,
               pipelined: bool, tracer: SpanTracer, label: str,
               ledger: OccupancyLedger | None = None, cluster0: int = 0):
    """One block loop over ``batch`` clusters of a ``rows``-row stream.
    Returns ``(summary on the host, report)``.

    Both drives carry the state in two buffers of their own: block j reads
    ``states[j % 2]`` and writes ``states[(j + 1) % 2]``.
    Synchronous: each stage fenced into ``ledger``; one stream buffer,
    the block just consumed written over by the next block's synthesis.
    Double-buffered: two stream buffers, one fence at the loop's end."""
    rep: dict = {}
    first = fns.init_state(rows, batch, device=device)
    states = [first, torch.zeros_like(first)]
    if not pipelined:
        led = ledger if ledger is not None else OccupancyLedger()
        out = buf = None
        wall = 0.0   # this call's stages: a shared ledger sums chunks
        for j in range(fns.n_blocks):
            with tracer.device_span(f"{label}.generation", block=j) as sp:
                buf = gen(j, out=buf)
                sp.fence(buf)
            led.add("generation", sp.dur_s)
            wall += sp.dur_s
            with tracer.device_span(f"{label}.kernel", block=j) as sp:
                out, state = fns.step(buf, states[j % 2], j, seed,
                                      state_out=states[(j + 1) % 2],
                                      cluster0=cluster0)
                sp.fence(state)
            led.add("kernel", sp.dur_s)
            wall += sp.dur_s
            led.repeats += 1
        with tracer.span(f"{label}.host") as sp:
            summary = _to_host(fns.finalize(out))
        led.add("host", sp.dur_s)
        wall += sp.dur_s
        rep["occupancy"] = led.to_dict()
        rep["wall_s"] = wall
        return summary, rep

    ptrs: set = set()
    shape = (fns.T_pad // fns.n_blocks, rows, batch)
    bufs = [torch.empty(shape, dtype=torch.float32, device=device)
            for _ in range(2)]
    with tracer.device_span(f"{label}.pipeline",
                            blocks=fns.n_blocks) as sp:
        if device.type == "cuda":
            out = _pipelined_cuda(gen, fns, bufs, states, seed, cluster0,
                                  ptrs)
        else:
            for j in range(fns.n_blocks):
                buf = gen(j, out=bufs[j % 2])
                ptrs.add(buf.data_ptr())
                out, _ = fns.step(buf, states[j % 2], j, seed,
                                  state_out=states[(j + 1) % 2],
                                  cluster0=cluster0)
        sp.fence(out)
    rep["pipeline_s"] = sp.dur_s
    with tracer.span(f"{label}.host") as sp:
        summary = _to_host(fns.finalize(out))
    rep["host_s"] = sp.dur_s
    rep["wall_s"] = rep["pipeline_s"] + rep["host_s"]
    rep["stream_buffers"] = len(ptrs)
    return summary, rep


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that synthesizes blocks on ``device``, one for the
    process: the caching allocator keeps a pool per stream, so a stream
    made for each drive would allocate the synthesis' temporaries anew in
    every drive."""
    return torch.cuda.Stream(device)


def _pipelined_cuda(gen, fns, bufs: list, states: list, seed: int,
                    cluster0: int, ptrs: set):
    """The double-buffered block loop on the card over the two stream
    buffers ``bufs`` and the two state buffers ``states``; returns the
    last block's ``out`` with the work enqueued on the current stream,
    not finished."""
    device = bufs[0].device
    main = torch.cuda.current_stream(device)
    side = _side_stream(device)
    ready = [torch.cuda.Event() for _ in range(2)]   # block in buffer i
    freed = [torch.cuda.Event() for _ in range(2)]   # buffer i read
    for buf in bufs:
        # Written on the side stream: the caching allocator must not hand
        # the buffers out again before that stream is done with them.
        buf.record_stream(side)

    def synthesize(j: int) -> None:
        i = j % 2
        with torch.cuda.stream(side):
            if j >= 2:
                side.wait_event(freed[i])   # kernel j - 2 has read it
            gen(j, out=bufs[i])
            ready[i].record(side)

    side.wait_stream(main)   # the buffers, and whatever came before
    synthesize(0)
    out = None
    for j in range(fns.n_blocks):
        i = j % 2
        main.wait_event(ready[i])
        out, _ = fns.step(bufs[i], states[i], j, seed,
                          state_out=states[1 - i], cluster0=cluster0)
        freed[i].record(main)
        ptrs.add(bufs[i].data_ptr())
        if j + 1 < fns.n_blocks:
            synthesize(j + 1)
    main.wait_stream(side)
    return out


def streaming_rollout_summary(source, params, cluster, mode: str, *,
                              key: int, batch: int, T: int, block_T: int,
                              seed: int = 0, t_chunk: int = 64,
                              stochastic: bool = True, net_params=None,
                              plan_packed=None, mesh=None,
                              pipelined: bool = True,
                              shard: int | None = None, cluster0: int = 0,
                              tracer: SpanTracer | None = None,
                              label: str = "stream", device=None):
    """One streaming rollout of ``batch`` clusters over ``T`` ticks in
    ``block_T``-tick blocks of the blocked stream family of ``key`` (the
    stream's seed; ``seed`` is the kernel's Philox seed). Returns
    ``(summary, report)``, the summary's tensors on the host:

    - ``pipelined=False`` (the synchronous drive): every stage fenced into
      an occupancy ledger, ``report["occupancy"]``; ``report["wall_s"]``
      the sum of the fenced stages.
    - ``pipelined=True`` (the double-buffered drive): ``report["wall_s"]``
      is the one fenced span around the block loop
      (``report["pipeline_s"]``) plus the host's finalize
      (``report["host_s"]``); ``report["stream_buffers"]`` counts the
      distinct stream buffers the loop used (2).

    Both drives give bitwise the same summaries, and bitwise
    :func:`unblocked_reference_summary`'s. ``shard`` and ``cluster0``
    make the run one chunk of a larger fleet (as
    :func:`chunked_streaming_summary` runs it). ``device`` (the card
    unless the caller names another) is where the streams are made;
    ``params`` must lie there. ``mesh`` splits the fleet over the mesh's
    data shards (module docstring; ``report["shards"]``, each shard's
    ``["shard_wall_s"]``, ``wall_s`` their sum)."""
    if mesh is not None:
        if shard is not None or cluster0:
            raise ValueError("mesh= runs the whole fleet; shard= and "
                             "cluster0= name one chunk of it")
        return _mesh_streaming(
            source, params, cluster, mode, mesh, key=key, batch=batch, T=T,
            block_T=block_T, seed=seed, t_chunk=t_chunk,
            stochastic=stochastic, net_params=net_params,
            plan_packed=plan_packed, pipelined=pipelined,
            tracer=tracer or SpanTracer(), label=label)
    dev = resolve_device(device)
    plan = plan_stream(T, block_T, t_chunk)
    gen = _block_gen(source, plan, batch, key, dev, shard=shard)
    fns = packed_mode_block_summary_fn(
        params, cluster, mode, T=T, block_T=block_T, t_chunk=t_chunk,
        stochastic=stochastic, net_params=net_params,
        plan_packed=plan_packed)
    summary, rep = _run_group(gen, fns, source.packed_rows(), batch, seed,
                              dev, pipelined=pipelined,
                              tracer=tracer or SpanTracer(), label=label,
                              cluster0=cluster0)
    rep.update(n_blocks=plan.n_blocks, block_T=plan.block_T,
               T_pad=plan.T_pad,
               pipeline="double-buffered" if pipelined else "sync")
    return summary, rep


def _mesh_streaming(source, params, cluster, mode: str, mesh, *, key: int,
                    batch: int, T: int, block_T: int, seed: int,
                    t_chunk: int, stochastic: bool, net_params, plan_packed,
                    pipelined: bool, tracer: SpanTracer, label: str):
    """:func:`streaming_rollout_summary` over ``mesh``: each data
    shard's block loop on its device, in shard order."""
    from ccka_tpu_torch.parallel.sharded_kernel import (
        sharded_packed_mode_block_summary_fn)

    plan = plan_stream(T, block_T, t_chunk)
    mfns = sharded_packed_mode_block_summary_fn(
        mesh, params, cluster, mode, T=T, block_T=block_T, batch=batch,
        t_chunk=t_chunk, stochastic=stochastic, net_params=net_params,
        plan_packed=plan_packed)
    b_loc = batch // len(mfns.shards)
    ledger = None if pipelined else OccupancyLedger()
    parts, walls, buffers = [], [], 0
    for i, (fns, dev, c0) in enumerate(mfns.shards):
        gen = _block_gen(source, plan, b_loc, key, dev, shard=i)
        part, rep = _run_group(gen, fns, source.packed_rows(), b_loc, seed,
                               dev, pipelined=pipelined, tracer=tracer,
                               label=f"{label}.{i}", ledger=ledger,
                               cluster0=c0)
        parts.append(part)
        walls.append(rep["wall_s"])
        buffers = max(buffers, rep.get("stream_buffers", 0))
    summary = EpisodeSummary(*(torch.cat(xs, dim=-1) for xs in zip(*parts)))
    report = {"n_blocks": plan.n_blocks, "block_T": plan.block_T,
              "T_pad": plan.T_pad, "shards": len(parts),
              "shard_wall_s": walls, "wall_s": sum(walls),
              "pipeline": "double-buffered" if pipelined else "sync"}
    if pipelined:
        report["stream_buffers"] = buffers
    else:
        report["occupancy"] = ledger.to_dict()
    return summary, report


def unblocked_reference_summary(source, params, cluster, mode: str, *,
                                key: int, batch: int, T: int, block_T: int,
                                seed: int = 0, t_chunk: int = 64,
                                stochastic: bool = True, net_params=None,
                                plan_packed=None, shard: int | None = None,
                                device=None):
    """The unblocked side of the bitwise comparison: the same blocks of
    the same stream family, concatenated, consumed by the mode's
    non-carry entry over the whole horizon (one launch on the card, no
    carried state). Holds the whole stream: the check's cost, not the
    pipeline's. The summary's tensors come back on the host."""
    dev = resolve_device(device)
    plan = plan_stream(T, block_T, t_chunk)
    gen = _block_gen(source, plan, batch, key, dev, shard=shard)
    full = torch.cat([gen(j) for j in range(plan.n_blocks)], dim=0)
    summary = packed_mode_summary(params, cluster, mode, full, T, seed,
                                  stochastic=stochastic,
                                  net_params=net_params,
                                  plan_packed=plan_packed)
    return _to_host(summary)


def chunked_streaming_summary(source, params, cluster, mode: str, *,
                              key: int, batch: int, chunk: int, T: int,
                              block_T: int, seed: int = 0,
                              t_chunk: int = 64, stochastic: bool = True,
                              net_params=None, mesh=None,
                              pipelined: bool = True,
                              tracer: SpanTracer | None = None,
                              label: str = "stream.chunked", device=None):
    """Cluster-axis chunking over the streaming pipeline: ``batch``
    clusters in ``chunk``-wide groups, each a whole block loop, the
    summaries concatenated on the host. Chunk ``c`` synthesizes with
    ``shard=c`` and its kernel takes the global index ``c * chunk`` of
    its first cluster. Device memory holds two stream blocks of one chunk
    (plus the carried states) however large ``batch`` grows. ``mesh``
    runs chunk ``c`` on data shard ``c mod n``'s device (``params``
    placed on each), bitwise the same summaries.

    Returns ``(summary, report)``: ``report["chunks"]``, ``["chunk"]``,
    ``["wall_s"]`` (the chunks' walls summed), ``["live_block_bytes"]``
    (two blocks of one chunk), ``["stream_bytes"]`` (the whole fleet's
    unchunked stream) and, on the card, ``["peak_bytes"]``
    (`torch.cuda.max_memory_allocated` over the run); the synchronous
    drive's one ledger across all chunks, or the double-buffered drive's
    ``["stream_buffers"]``."""
    if mesh is None:
        devs = [resolve_device(device)]
        placed = {str(devs[0]): params}
    else:
        from ccka_tpu_torch.parallel.mesh import replicate

        devs = mesh.data_devices()
        placed = replicate(mesh, params).copies
    n_chunks = lanes.chunk_layout(batch, chunk)
    plan = plan_stream(T, block_T, t_chunk)
    fns_on = {d: packed_mode_block_summary_fn(
        p, cluster, mode, T=T, block_T=block_T, t_chunk=t_chunk,
        stochastic=stochastic, net_params=net_params)
        for d, p in placed.items()}
    tr = tracer or SpanTracer()
    ledger = None if pipelined else OccupancyLedger()
    rows = source.packed_rows()
    cudas = {d for d in devs if d.type == "cuda"}
    for d in cudas:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    parts, wall, buffers = [], 0.0, 0
    for c in range(n_chunks):
        dev = devs[c % len(devs)]
        fns = fns_on[str(dev)]
        gen = _block_gen(source, plan, chunk, key, dev, shard=c)
        part, rep = _run_group(gen, fns, rows, chunk, seed, dev,
                               pipelined=pipelined, tracer=tr,
                               label=f"{label}.{c}", ledger=ledger,
                               cluster0=c * chunk)
        parts.append(part)
        wall += rep["wall_s"]
        buffers = max(buffers, rep.get("stream_buffers", 0))
    summary = EpisodeSummary(*(torch.cat(xs, dim=-1) for xs in zip(*parts)))
    report = {
        "chunks": n_chunks, "chunk": chunk,
        "n_blocks": plan.n_blocks, "block_T": plan.block_T,
        "wall_s": wall,
        "pipeline": "double-buffered" if pipelined else "sync",
        "live_block_bytes": 2 * lanes.block_bytes(plan.block_T, rows, chunk),
        "stream_bytes": lanes.block_bytes(plan.T_pad, rows, batch),
        "peak_bytes": (max(torch.cuda.max_memory_allocated(d)
                           for d in cudas) if cudas else None),
    }
    if pipelined:
        report["stream_buffers"] = buffers
    else:
        report["occupancy"] = ledger.to_dict()
    return summary, report

