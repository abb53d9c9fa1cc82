"""MPC-distillation data factory: (state, optimized-plan) pairs at kernel
speed.

The PyTorch form of `ccka_tpu/train/factory.py`. The factory mass-produces
``(state, optimized-plan)`` pairs across the scenario library x fault
intensities, labels them by replaying the plans through the
double-buffered streaming pipeline, and emits a distillation dataset
(`train/imitate.ImitationBatch`) that the flagship's
``init_from="distill:mpc-factory"`` consumes.

One factory CELL (scenario x intensity) runs four stages:

1. **Worlds**: the scenario's widened packed stream, generated block-wise
   with the streaming seed family (`packed_block_trace_device` per block,
   concatenated), so the labeling pipeline regenerates bitwise the same
   worlds; the planner sees the clean exo view (`unpack_exo`: plans are
   blind to the fault and workload lanes).
2. **Plan** (the teacher): ``optimize_plan_batch`` plans every pair's
   full window at once (teacher "mpc"); teacher "mpc-rh" runs the
   receding-horizon planner instead (closed-loop-shaped plans).
3. **Label at kernel speed**: the packed per-cluster plans replay through
   `sim/streaming.streaming_rollout_summary` (mode "plan", double-
   buffered; the plan kernel's CARRY instantiation on the card) on the
   same stream seed and Philox seed, with the rule kernel on the same
   stream as the paired baseline column.
4. **Collect**: the plans executed on expectation dynamics against the
   true traces, recording ``(observation, plan latent, discounted
   return)`` per (tick, pair), rows time-major as `imitate.py`'s.

Factory pairs/s is measured against :func:`naive_lax_pair_rate`, the
status-quo way to make one labeled pair: a per-pair
``receding_horizon_rollout`` loop at the repo's standing MPC protocol
(``cfg.train.mpc_horizon`` / ``mpc_iters``).

Names are validated up front: unknown scenario, intensity or teacher
names raise before any device work. ``mesh=`` splits every cell's pairs
over a device mesh (:func:`produce_cell`).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import FAULT_PRESETS, FrameworkConfig
from ccka_tpu_torch.models import latent_to_action
from ccka_tpu_torch.parallel.mesh import gather
from ccka_tpu_torch.policy.base import observe
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim import lanes
from ccka_tpu_torch.sim.dynamics import clip
from ccka_tpu_torch.sim.rollout import initial_state, rollout
from ccka_tpu_torch.sim.types import Action, SimParams
from ccka_tpu_torch.train.imitate import (_TARGET_CLIP, ImitationBatch,
                                          _time_major, discounted_returns)
from ccka_tpu_torch.train.objective import step_reward
from ccka_tpu_torch.train.ppo import _REWARD_SCALE

# Teacher protocols: "mpc", one full-window `optimize_plan_batch` per cell;
# "mpc-rh", the receding-horizon planner (closed-loop-shaped plans at
# several times the planning cost).
FACTORY_TEACHERS = ("mpc", "mpc-rh")

# The factory's planning iterations: one-shot full-window plans, enough to
# shape zone and capacity choices without the closed-loop tax.
FACTORY_ITERS = 12


def resolve_b_block(pairs: int, b_block: int | None) -> int:
    """Lane width of a cell: ``None`` picks the widest power-of-two divisor
    of ``pairs`` up to 64; an explicit value must divide ``pairs``. The
    port's kernels tile the batch themselves, so the width is recorded in
    the report and checked, as the JAX package records and checks it."""
    if b_block is None:
        b = 1
        while b * 2 <= min(64, pairs) and pairs % (b * 2) == 0:
            b *= 2
        return b
    if pairs % b_block:
        raise ValueError(f"pairs={pairs} must divide into "
                         f"b_block={b_block} kernel lanes")
    return b_block


def validate_factory_names(*, scenarios, intensities, teacher: str) -> dict:
    """Resolve and validate every name up front; returns the resolved
    scenario map."""
    from ccka_tpu_torch.workloads.scenarios import resolve_scenarios

    resolved = resolve_scenarios(scenarios)
    bad = [i for i in intensities if i != "off" and i not in FAULT_PRESETS]
    if bad:
        raise ValueError(f"unknown intensities {bad}; presets: "
                         f"['off'] + {sorted(FAULT_PRESETS)}")
    if not intensities:
        raise ValueError("no intensities named; presets: "
                         f"['off'] + {sorted(FAULT_PRESETS)}")
    if teacher not in FACTORY_TEACHERS:
        raise ValueError(f"unknown teacher {teacher!r}; teachers: "
                         f"{sorted(FACTORY_TEACHERS)}")
    return resolved


def _cell_source(cfg: FrameworkConfig, scenario, intensity: str):
    """The cell's widened-stream source: the scenario's workload mix with
    the intensity axis's faults (the scenario's own fault preset is not
    applied, so ``intensity="off"`` is the calm column)."""
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    faults = FAULT_PRESETS[intensity] if intensity != "off" else None
    return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals, faults=faults,
                                 workloads=scenario.workloads)


def _cell_stream(source, *, steps: int, block_T: int, t_chunk: int,
                 pairs: int, key: int, device) -> torch.Tensor:
    """The cell's whole packed stream, block by block with the streaming
    seed family and concatenated: bitwise the blocks the labeling
    pipeline makes from the same key."""
    n_blocks, _ = lanes.block_layout(steps, block_T, t_chunk)
    return torch.cat([source.packed_block_trace_device(
        block_T, key, pairs, j, t_chunk=t_chunk, device=device)
        for j in range(n_blocks)], dim=0)


class StreamBlocks:
    """A given packed stream served block by block, in the interface the
    streaming pipeline reads from a synthesizing source
    (``packed_rows``, ``packed_block_trace_device``): how a caller feeds
    its own worlds to :func:`produce_cell`."""

    def __init__(self, stream: torch.Tensor):
        self.stream = stream

    def packed_rows(self) -> int:
        return self.stream.shape[1]

    def packed_block_trace_device(self, block_T, seed, batch, block_index, *,
                                  shard=None, out=None, t_chunk=64,
                                  device=None):
        """Block ``block_index`` of the stream; with ``shard``, of its
        ``shard``-th ``batch``-wide group of clusters (a mesh shard's)."""
        block = self.stream[block_index * block_T:(block_index + 1)
                            * block_T]
        if shard is not None:
            block = block[..., shard * batch:(shard + 1) * batch]
        if out is None:
            return block.clone()
        return out.copy_(block)


class FactoryCell(NamedTuple):
    scenario: str
    intensity: str
    dataset: ImitationBatch
    plan_latents: torch.Tensor     # [N, T, A]
    teacher_summary: object        # EpisodeSummary fields [N]
    rule_summary: object
    report: dict


@torch.no_grad()
def _collect_plan_pairs(params: SimParams, cfg: FrameworkConfig, traces,
                        plan_latents: torch.Tensor) -> ImitationBatch:
    """Stage 4: the plans executed on expectation dynamics, recording
    (observation, plan latent, discounted return) per (tick, pair): the
    record format of `imitate.collect_dataset`."""
    actions = latent_to_action(plan_latents, cfg.cluster)
    obs_t = []

    def decide(state, exo, t):
        obs_t.append(observe(params, state, exo).flatten())
        return Action(*(x[:, t] for x in actions))

    states0 = initial_state(cfg, plan_latents.shape[0],
                            plan_latents.device)
    _, metrics = rollout(params, states0, decide, traces)
    returns = discounted_returns(
        step_reward(metrics, cfg.train) * _REWARD_SCALE, cfg.train.gamma)
    return ImitationBatch(
        obs=_time_major(torch.stack(obs_t, dim=1)),
        target=clip(_time_major(plan_latents), -_TARGET_CLIP, _TARGET_CLIP),
        returns=_time_major(returns))


def _fenced(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def produce_cell(cfg: FrameworkConfig, scenario, intensity: str, *,
                 teacher: str = "mpc", pairs: int = 64, steps: int = 96,
                 block_T: int = 48, t_chunk: int = 48,
                 b_block: int | None = None, iters: int = FACTORY_ITERS,
                 seed: int = 0, mesh=None, stochastic: bool = True,
                 with_ledger: bool = False, worlds: torch.Tensor | None = None,
                 plans: torch.Tensor | None = None,
                 device=None) -> FactoryCell:
    """One factory cell end to end (module docstring stages 1-4). Returns
    the cell's dataset, paired summaries and throughput report.

    ``seed`` keys both the stream's block seeds and the kernels' Philox
    stream. ``worlds`` (the cell's whole packed stream, [T_pad, rows,
    pairs]) replaces stage 1's synthesis and ``plans`` ([pairs, steps,
    A] latents) stage 2's planner: the seams through which a caller
    supplies its own draws.

    ``mesh`` (`parallel/mesh.py`) splits the pairs over the mesh's data
    shards: stage 1 makes the blocks the mesh's streaming drive makes
    (shard ``i``'s as chunk ``i``'s, `parallel/sharded_kernel.py::
    ShardBlocks`), stage 2 plans each shard's pairs on its device and
    stage 3 labels through `sim/streaming.py`'s mesh drive; the planner
    and the playback see the same worlds."""
    from ccka_tpu_torch.sim import streaming
    from ccka_tpu_torch.sim.megakernel import pack_plan, unpack_exo
    from ccka_tpu_torch.train.mpc import (optimize_plan_batch,
                                          receding_horizon_plan_batch,
                                          zero_latent)

    if teacher not in FACTORY_TEACHERS:
        raise ValueError(f"unknown teacher {teacher!r}; teachers: "
                         f"{sorted(FACTORY_TEACHERS)}")
    dev = resolve_device(device)
    b_block = resolve_b_block(pairs, b_block)
    params = SimParams.from_config(cfg, device=dev)
    cluster, tcfg = cfg.cluster, cfg.train
    src = _cell_source(cfg, scenario, intensity)

    # 1. Worlds (streaming seed family) and the planner's clean exo view.
    t0 = _fenced(dev)
    if worlds is None:
        gen_src = src
        if mesh is not None:
            from ccka_tpu_torch.parallel.mesh import data_shards
            from ccka_tpu_torch.parallel.sharded_kernel import ShardBlocks

            gen_src = ShardBlocks(src, data_shards(mesh))
        full = _cell_stream(gen_src, steps=steps, block_T=block_T,
                            t_chunk=t_chunk, pairs=pairs, key=seed,
                            device=dev)
    else:
        full = torch.as_tensor(worlds).to(dev)
        src = StreamBlocks(full)
    traces = unpack_exo(full, steps, cluster.n_zones)
    gen_s = _fenced(dev) - t0

    # 2. Plan: the whole cell at once.
    base = zero_latent(cluster, dev)
    states0 = initial_state(cfg, pairs, dev)
    t0 = _fenced(dev)
    if plans is not None:
        plans = torch.as_tensor(plans, dtype=torch.float32).to(dev)
    elif teacher == "mpc":
        lat0 = base.expand(pairs, steps, *base.shape)
        plans = optimize_plan_batch(params, cluster, tcfg, states0, traces,
                                    lat0, iters=iters,
                                    mesh=mesh).plan_latent
    else:                                     # "mpc-rh"
        horizon = min(int(tcfg.mpc_horizon), steps)
        lat0 = base.expand(pairs, horizon, *base.shape)
        plans = receding_horizon_plan_batch(
            params, cluster, tcfg, states0, traces, lat0, horizon=horizon,
            replan_every=8, iters=max(2, iters // 4), mesh=mesh)
    plans = gather(plans, dev).detach()
    plan_s = _fenced(dev) - t0

    # 3. Label at kernel speed: the per-cluster plans through the double-
    # buffered streaming pipeline; the rule kernel on the same stream and
    # seed is the paired baseline column.
    with torch.no_grad():
        plan_packed = pack_plan(latent_to_action(plans, cluster),
                                full.shape[0])
    skw = dict(key=seed, batch=pairs, T=steps, block_T=block_T, seed=seed,
               t_chunk=t_chunk, stochastic=stochastic, mesh=mesh,
               device=dev)
    t0 = _fenced(dev)
    teacher_summary, rep_play = streaming.streaming_rollout_summary(
        src, params, cluster, "plan", plan_packed=plan_packed,
        pipelined=True, label="factory.play", **skw)
    label_s = _fenced(dev) - t0
    rule_summary, _ = streaming.streaming_rollout_summary(
        src, params, cluster, "rule", pipelined=True, label="factory.rule",
        **skw)
    ledger = None
    if with_ledger:
        _, rep_sync = streaming.streaming_rollout_summary(
            src, params, cluster, "plan", plan_packed=plan_packed,
            pipelined=False, label="factory.play.sync", **skw)
        ledger = rep_sync.get("occupancy")

    # 4. Collect the distillation rows.
    t0 = _fenced(dev)
    dataset = _collect_plan_pairs(params, cfg, traces, plans)
    collect_s = _fenced(dev) - t0

    days = steps * cfg.sim.dt_s / 86400.0
    wall = gen_s + plan_s + label_s + collect_s
    report = {
        "scenario": scenario.name, "intensity": intensity,
        "teacher": teacher, "seed": seed, "pairs": pairs, "steps": steps,
        "block_T": block_T, "t_chunk": t_chunk, "b_block": b_block,
        "iters": iters, "stochastic": bool(stochastic),
        "gen_s": round(gen_s, 4), "plan_s": round(plan_s, 4),
        "label_s": round(label_s, 4), "collect_s": round(collect_s, 4),
        "wall_s": round(wall, 4),
        "pairs_per_sec": round(pairs / wall, 4) if wall else None,
        "plans_per_sec": round(pairs / plan_s, 4) if plan_s else None,
        "playback_cluster_days_per_sec": (
            round(pairs * days / rep_play["wall_s"], 2)
            if rep_play.get("wall_s") else None),
        "playback": {k: rep_play[k] for k in ("wall_s", "n_blocks",
                                              "pipeline") if k in rep_play},
        "dataset_rows": int(dataset.obs.shape[0]),
    }
    if ledger is not None:
        report["playback_occupancy"] = ledger
    return FactoryCell(scenario.name, intensity, dataset, plans,
                       teacher_summary, rule_summary, report)


def _paired_usd_ratio(a_summary, b_summary) -> float:
    """Mean paired $/SLO-hr ratio a/b over the cell's shared worlds."""
    a = np.asarray(a_summary.usd_per_slo_hour.cpu(), np.float64).ravel()
    b = np.asarray(b_summary.usd_per_slo_hour.cpu(), np.float64).ravel()
    return float(a.mean() / max(b.mean(), 1e-9))


def cell_seed(seed: int, scenario_index: int, intensity_index: int) -> int:
    """The per-cell world seed :func:`factory_run` uses, exported so a
    caller re-scoring a cell's shared worlds regenerates its streams."""
    return seed + 1000 * scenario_index + 100 * intensity_index


def factory_run(cfg: FrameworkConfig, *, scenarios, intensities,
                teacher: str = "mpc", pairs_per_cell: int = 64,
                steps: int = 96, block_T: int = 48, t_chunk: int = 48,
                b_block: int | None = None, iters: int = FACTORY_ITERS,
                seed: int = 0, mesh=None, with_ledger: bool = False,
                return_cells: bool = False, device=None):
    """The whole sweep: every (scenario x intensity) cell through
    :func:`produce_cell`, the datasets concatenated, per-cell throughput
    and the paired teacher-vs-rule column in the report. Names are
    validated before anything runs. Returns ``(dataset, report)``, and
    the cells too with ``return_cells=True``."""
    resolved = validate_factory_names(scenarios=scenarios,
                                      intensities=intensities,
                                      teacher=teacher)
    cells, raw_cells = [], []
    for ci, scenario in enumerate(resolved.values()):
        for ii, intensity in enumerate(intensities):
            cell = produce_cell(
                cfg, scenario, intensity, teacher=teacher,
                pairs=pairs_per_cell, steps=steps, block_T=block_T,
                t_chunk=t_chunk, b_block=b_block, iters=iters,
                seed=cell_seed(seed, ci, ii), mesh=mesh,
                with_ledger=with_ledger and not cells, device=device)
            row = dict(cell.report)
            row["teacher_vs_rule_usd_per_slo_hour"] = round(
                _paired_usd_ratio(cell.teacher_summary, cell.rule_summary),
                4)
            cells.append(row)
            raw_cells.append(cell)
    dataset = ImitationBatch(*(torch.cat(parts, dim=0) for parts in
                               zip(*(c.dataset for c in raw_cells))))
    total_pairs = pairs_per_cell * len(cells)
    total_wall = sum(c["wall_s"] for c in cells)
    report = {
        "engine": "train/factory.py: batched full-window planning -> "
                  "double-buffered streaming plan playback -> batched "
                  "expectation-dynamics pair collection",
        "teacher": teacher, "cells": cells,
        "pairs_total": total_pairs,
        "dataset_rows": int(dataset.obs.shape[0]),
        "wall_s": round(total_wall, 4),
        "pairs_per_sec": (round(total_pairs / total_wall, 4)
                          if total_wall else None),
        "plans_per_sec": round(total_pairs / max(
            sum(c["plan_s"] for c in cells), 1e-9), 4),
    }
    if return_cells:
        return dataset, report, raw_cells
    return dataset, report


def naive_lax_pair_rate(cfg: FrameworkConfig, scenario, intensity: str, *,
                        pairs: int = 3, steps: int = 96, block_T: int = 48,
                        t_chunk: int = 48, seed: int = 0, warm: bool = True,
                        device=None) -> dict:
    """The paired baseline of the factory's throughput claim: one labeled
    pair at a time, a per-pair ``receding_horizon_rollout`` (closed-loop
    MPC at ``cfg.train.mpc_horizon`` / ``mpc_iters``, expectation
    dynamics) over the same trace family, fenced per pair. With ``warm``
    the first pair runs once untimed first, as the JAX package excludes
    its compile; the port compiles nothing, so a caller whose device has
    already run the planner may skip it."""
    from ccka_tpu_torch.sim.megakernel import unpack_exo
    from ccka_tpu_torch.train.mpc import receding_horizon_rollout, zero_latent

    dev = resolve_device(device)
    params = SimParams.from_config(cfg, device=dev)
    cluster, tcfg = cfg.cluster, cfg.train
    src = _cell_source(cfg, scenario, intensity)
    full = _cell_stream(src, steps=steps, block_T=block_T, t_chunk=t_chunk,
                        pairs=max(pairs, 1), key=seed, device=dev)
    traces = unpack_exo(full, steps, cluster.n_zones)
    horizon = min(int(tcfg.mpc_horizon), steps)
    base = zero_latent(cluster, dev)
    lat0 = base.expand(1, horizon, *base.shape)
    state0 = initial_state(cfg, 1, dev)

    def one(i):
        receding_horizon_rollout(
            params, cluster, tcfg, state0,
            ExogenousTrace(*(x[i:i + 1] for x in traces)), lat0,
            seed + i, horizon=horizon, replan_every=8,
            iters=int(tcfg.mpc_iters), stochastic=False)
        _fenced(dev)

    if warm:
        one(0)
    t0 = time.perf_counter()
    for i in range(pairs):
        one(i)
    wall = time.perf_counter() - t0
    return {
        "engine": "naive per-pair receding_horizon_rollout loop "
                  "(closed-loop MPC at cfg.train.mpc_horizon/mpc_iters, "
                  "one pair per call, fenced per pair)",
        "pairs": pairs, "steps": steps, "warm": warm,
        "mpc_horizon": horizon, "mpc_iters": int(tcfg.mpc_iters),
        "wall_s": round(wall, 4),
        "pairs_per_sec": round(pairs / wall, 4) if wall else None,
    }


def distill_from_factory(cfg: FrameworkConfig, *, scenarios=None,
                         intensities=("off", "moderate"),
                         teacher: str = "mpc", pairs_per_cell: int = 64,
                         steps: int = 96, iterations: int = 1000,
                         seed: int = 0, device=None, **factory_kw):
    """Factory sweep -> `imitate(dataset=...)` -> ``(net_params, history,
    report)``: the ``init_from="distill:mpc-factory"`` path. Defaults
    sweep calm and faulted columns of the two headline scenarios."""
    from ccka_tpu_torch.train.imitate import imitate

    if scenarios is None:
        scenarios = ("diurnal-inference", "batch-backfill")
    dataset, report = factory_run(
        cfg, scenarios=scenarios, intensities=intensities, teacher=teacher,
        pairs_per_cell=pairs_per_cell, steps=steps, seed=seed,
        device=device, **factory_kw)
    params, history = imitate(cfg, None, None, dataset=dataset,
                              iterations=iterations, seed=seed,
                              device=device)
    report = dict(report, distill_iterations=iterations,
                  final_actor_mse=history[-1]["actor_mse"])
    return params, history, report
