"""Rollouts: a Python loop over the horizon, the batch axis written out.

The PyTorch form of `ccka_tpu/sim/rollout.py`: ``batched_rollout_summary``
(KPIs folded inside the loop), ``rollout`` and ``rollout_actions``
(per-tick metrics), with the optional fault and workload lanes threaded
through. It is the reference the CUDA rollout kernels are held against,
and it stays differentiable in deterministic mode.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.faults.types import FaultStep
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim.dynamics import ExoStep, step
from ccka_tpu_torch.sim.metrics import SummaryAcc, finalize_summary
from ccka_tpu_torch.sim.random import uniforms
from ccka_tpu_torch.sim.types import (N_CT, Action, ClusterState,
                                      SimParams, StepMetrics)
from ccka_tpu_torch.workloads.types import WorkloadState, WorkloadStep

# action_fn(state, exo_step, t) -> Action
ActionFn = Callable[[ClusterState, ExoStep, int], Action]


def fresh_state(P: int, Z: int, K: int, batch: int,
                device) -> ClusterState:
    """``batch`` fresh clusters of topology (P, Z, K) on ``device``."""
    def zeros(*shape):
        return torch.zeros((batch, *shape), dtype=torch.float32,
                           device=device)

    return ClusterState(
        nodes=zeros(P, Z, N_CT), pipeline=zeros(K, P, Z, N_CT),
        running=zeros(2), consol_timer_s=zeros(P), time_s=zeros(),
        acc_cost_usd=zeros(), acc_carbon_g=zeros(), acc_requests=zeros(),
        acc_slo_ok_s=zeros(), acc_evictions=zeros())


def initial_state(cfg: FrameworkConfig, batch: int,
                  device=None) -> ClusterState:
    """``batch`` fresh clusters: only the managed base nodegroup, nothing
    pending."""
    return fresh_state(cfg.cluster.n_pools, cfg.cluster.n_zones,
                       cfg.sim.provision_delay_steps, batch,
                       resolve_device(device))


def exo_steps(trace: ExogenousTrace) -> ExoStep:
    """A [B, T, ...] trace as the loop's per-tick inputs (axis 1 = T)."""
    return ExoStep(
        spot_price_hr=trace.spot_price_hr,
        od_price_hr=trace.od_price_hr,
        carbon_g_kwh=trace.carbon_g_kwh,
        demand_pods=trace.demand_pods,
        is_peak=trace.is_peak,
    )


def observed_exo(last: ExoStep, exo: ExoStep, stale) -> ExoStep:
    """What a policy observes under a possible signal outage: while
    ``stale`` [B] is set, prices, carbon and demand hold ``last``'s
    values; ``is_peak`` comes from the clock and stays live. Dynamics
    always consume the true ``exo``."""
    hold = (stale > 0.5)[:, None]
    return ExoStep(
        spot_price_hr=torch.where(hold, last.spot_price_hr,
                                  exo.spot_price_hr),
        od_price_hr=torch.where(hold, last.od_price_hr, exo.od_price_hr),
        carbon_g_kwh=torch.where(hold, last.carbon_g_kwh, exo.carbon_g_kwh),
        demand_pods=torch.where(hold, last.demand_pods, exo.demand_pods),
        is_peak=exo.is_peak)


def _wl_zero(params: SimParams, batch: int, device) -> WorkloadState:
    """Empty workload-family queues for a batch."""
    return WorkloadState.zero(int(params.wl_batch_deadline_ticks), batch,
                              device)


def _ticks(params: SimParams, states0: ClusterState, decide, traces,
           seed: int, *, stochastic: bool, faults, workloads,
           observe: bool = True, tick0: int = 0, cluster0: int = 0,
           wl_state0: WorkloadState | None = None,
           held0: ExoStep | None = None):
    """The loop every rollout shares: yields ``(state, metrics, wl_state,
    held)`` after each tick. ``decide(state, observed_exo, t)`` picks tick
    t's action (t counts from the loop's first tick); with ``observe``
    False (a plan, which observes nothing) the held observation of a
    fault outage is not formed. Interruption draws are addressed by the
    global tick ``tick0 + t`` and the global cluster ``cluster0 + b``;
    ``cluster0`` may instead be a [B] tensor of each row's own global
    cluster (rows that share one share their draws).

    A resumed loop (one time block of a longer run) starts from the
    carried workload queues ``wl_state0`` (empty when None) and the held
    observation ``held0``; the observation of a tick holds its own
    signals only at global tick 0 (or with nothing held)."""
    xs = exo_steps(traces)
    B, T = traces.is_peak.shape
    P, Z = states0.nodes.shape[1:3]
    dev = states0.nodes.device
    clusters = (cluster0.to(dev)[:, None]
                if isinstance(cluster0, torch.Tensor)
                else cluster0 + torch.arange(B, device=dev)[:, None])
    rows = torch.arange(P * Z, device=dev)[None, :]
    state = states0
    wl_state = wl_state0
    if workloads is not None and wl_state is None:
        wl_state = _wl_zero(params, B, dev)
    last = held0
    for t in range(T):
        exo = ExoStep(*(x[:, t] for x in xs))
        fault = obs = None
        if faults is not None:
            fault = FaultStep(*(x[:, t] for x in faults))
            if observe:
                ref = exo if last is None or tick0 + t == 0 else last
                obs = observed_exo(ref, exo, fault.signal_stale)
                last = obs
        action = decide(state, exo if obs is None else obs, t)
        u3 = None
        if stochastic:
            u3 = uniforms(seed, clusters, tick0 + t, rows).reshape(3, B, P, Z)
        if workloads is None:
            state, metrics = step(params, state, action, exo, u3,
                                  stochastic=stochastic, fault=fault)
        else:
            state, metrics, wl_state = step(
                params, state, action, exo, u3, stochastic=stochastic,
                fault=fault, workload=WorkloadStep(
                    *(x[:, t] for x in workloads)), wl_state=wl_state)
        yield state, metrics, wl_state, last


def batched_rollout_summary(params: SimParams, states0: ClusterState,
                            action_fn: ActionFn, traces: ExogenousTrace,
                            seed: int = 0, *, stochastic: bool = False,
                            faults: FaultStep | None = None,
                            workloads: WorkloadStep | None = None,
                            cluster0: int = 0):
    """Closed-loop rollout of a batch of clusters over the traces' horizon,
    folded into one EpisodeSummary per cluster inside the loop (memory
    O(B), whatever the horizon). Returns ``(final_state, summary)``.

    In stochastic mode the interruption draws of cluster b at tick t come
    from `sim/random.py` at (``seed``, ``cluster0`` + b, t, spot row); the
    CUDA rollout kernels draw the same numbers. ``cluster0`` is the global
    index of the batch's first cluster (one shard of a larger fleet).

    ``faults``: optional `FaultStep` with leaves [B, T, Z] / [B, T]; each
    tick's disturbances feed the step, and the policy observes held
    signals during outages (tick 0 observes its own, fresh).
    ``workloads``: optional `WorkloadStep` with leaves [B, T]; the
    family queues start empty and drain from the fleet's headroom (the
    policy does not observe them). ``None`` for both is the program
    without lanes, bitwise."""
    acc0 = SummaryAcc.zero(traces.is_peak.shape[0], states0.nodes.device)
    state, acc, _, _ = resume_rollout_summary(
        params, Carry(states0, acc0, None, None), action_fn, traces, seed,
        tick0=0, cluster0=cluster0, stochastic=stochastic, faults=faults,
        workloads=workloads)
    return state, finalize_summary(params, states0, state, acc,
                                   traces.is_peak.shape[1])


class Carry(NamedTuple):
    """What a rollout resumed at a block boundary needs: the clusters
    (their episode totals included), the summary statistics, the workload
    queues (None without workload lanes) and the held observation of a
    fault outage (None when nothing is held)."""

    state: ClusterState
    acc: SummaryAcc
    wl: WorkloadState | None
    held: ExoStep | None


def resume_rollout_summary(params: SimParams, carry: Carry,
                           action_fn: ActionFn, traces: ExogenousTrace,
                           seed: int = 0, *, tick0: int, cluster0: int = 0,
                           stochastic: bool = False,
                           faults: FaultStep | None = None,
                           workloads: WorkloadStep | None = None,
                           observe: bool = True) -> Carry:
    """`batched_rollout_summary`'s loop over one time block (the traces'
    ticks, starting at global tick ``tick0``) from ``carry``; returns the
    carry after the block. Blocks run one after another from fresh
    clusters give bitwise the unblocked loop's statistics."""
    state, acc, wl, held = carry
    for state, metrics, wl, held in _ticks(
            params, state, action_fn, traces, seed, stochastic=stochastic,
            faults=faults, workloads=workloads, observe=observe,
            tick0=tick0, cluster0=cluster0, wl_state0=wl, held0=held):
        acc = acc.update(params, metrics)
    return Carry(state, acc, wl, held)


# The carried state's accumulator rows, in the order of the kernels'
# [24, B] output block: (ClusterState or SummaryAcc field, column).
_ACC_ROWS = (
    ("acc_cost_usd", None), ("acc_carbon_g", None), ("acc_requests", None),
    ("acc_slo_ok_s", None), ("acc_evictions", None), ("nodes_ct_sum", 0),
    ("nodes_ct_sum", 1), ("served_sum", None), ("capacity_sum", None),
    ("waste_sum", None), ("latency_sum", None), ("latency_max", None),
    ("queue_sum", None), ("interrupts_sum", None), ("denied_sum", None),
    ("stale_sum", None), ("inf_viol_sum", None), ("inf_queue_sum", None),
    ("inf_drop_sum", None), ("batch_miss_sum", None), ("batch_bl_sum", None),
)
N_ACC_ROWS = len(_ACC_ROWS)   # 21


class CarryLayout(NamedTuple):
    """Rows of the packed carried state ``[rows, B]`` (batch innermost),
    the layout the CUDA kernels' CARRY instantiations load and store
    (`csrc/rollout_tick.cuh::CarryRows`): the 21 accumulators in the
    kernels' output order, then nodes [P][Z][2], the pipeline
    [K][P][Z][2], running [2], the consolidation timers [P], the held
    observation (spot[Z], od[Z], carbon[Z], demand[2], is_peak; only for
    a policy that observes signals under fault lanes) and the workload
    queues (inference, batch by age [D], background; only with workload
    lanes); zero rows pad the count to a multiple of 8."""

    P: int
    Z: int
    K: int
    held: bool
    wl_depth: int

    def blocks(self) -> dict:
        P, Z, K = self.P, self.Z, self.K
        sizes = (("acc", N_ACC_ROWS), ("nodes", 2 * P * Z),
                 ("pipeline", 2 * K * P * Z), ("running", 2), ("timer", P),
                 ("held", 3 * Z + 3 if self.held else 0),
                 ("queues", self.wl_depth + 2 if self.wl_depth else 0))
        out, lo = {}, 0
        for name, n in sizes:
            out[name] = (lo, lo + n)
            lo += n
        return out

    @property
    def rows(self) -> int:
        used = self.blocks()["queues"][1]
        return -(-used // 8) * 8


def pack_carry(carry: Carry, layout: CarryLayout,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``carry`` -> the packed state ``[layout.rows, B]`` (written into
    ``out`` when given). A held observation or queues that the layout has
    no rows for are dropped; rows the carry lacks are zero."""
    state, acc, wl, held = carry
    B = state.nodes.shape[0]
    if out is None:
        out = torch.zeros((layout.rows, B), dtype=torch.float32,
                          device=state.nodes.device)
    else:
        out.zero_()
    for r, (name, col) in enumerate(_ACC_ROWS):
        x = getattr(state if name.startswith("acc_") else acc, name)
        out[r] = x if col is None else x[:, col]
    blk = layout.blocks()

    def put(name, x):  # x [B, n]
        lo, hi = blk[name]
        out[lo:hi] = x.reshape(B, hi - lo).T

    put("nodes", state.nodes)
    put("pipeline", state.pipeline)
    put("running", state.running)
    put("timer", state.consol_timer_s)
    if layout.held and held is not None:
        put("held", torch.cat([held.spot_price_hr, held.od_price_hr,
                               held.carbon_g_kwh, held.demand_pods,
                               held.is_peak[:, None]], dim=1))
    if layout.wl_depth and wl is not None:
        put("queues", torch.cat([wl.inf_queue[:, None], wl.batch_backlog,
                                 wl.bg_backlog[:, None]], dim=1))
    return out


def unpack_carry(packed: torch.Tensor, layout: CarryLayout,
                 params: SimParams, tick0: int) -> Carry:
    """The packed state ``[layout.rows, B]`` at global tick ``tick0`` ->
    a :class:`Carry` of new tensors (the clock ``time_s`` is
    ``tick0 * dt_s``, what the loop's additions give)."""
    P, Z, K = layout.P, layout.Z, layout.K
    B = packed.shape[1]
    blk = layout.blocks()

    def get(name, *shape):
        lo, hi = blk[name]
        return packed[lo:hi].T.reshape(B, *shape).clone()

    row = {name: r for r, (name, col) in enumerate(_ACC_ROWS)
           if col is None}
    state = ClusterState(
        nodes=get("nodes", P, Z, N_CT), pipeline=get("pipeline", K, P, Z,
                                                     N_CT),
        running=get("running", 2), consol_timer_s=get("timer", P),
        time_s=(params.dt_s * float(tick0)).expand(B).clone(),
        **{f: packed[row[f]].clone() for f in ClusterState._fields
           if f.startswith("acc_")})
    lo = [name for name, _ in _ACC_ROWS].index("nodes_ct_sum")
    acc = SummaryAcc(nodes_ct_sum=packed[lo:lo + N_CT].T.clone(),
                     **{f: packed[row[f]].clone() for f in SummaryAcc._fields
                        if f != "nodes_ct_sum"})
    wl = held = None
    if layout.wl_depth:
        q = get("queues", layout.wl_depth + 2)
        wl = WorkloadState(inf_queue=q[:, 0].clone(),
                           batch_backlog=q[:, 1:-1].clone(),
                           bg_backlog=q[:, -1].clone())
    if layout.held:
        h = get("held", 3 * Z + 3)
        held = ExoStep(spot_price_hr=h[:, :Z], od_price_hr=h[:, Z:2 * Z],
                       carbon_g_kwh=h[:, 2 * Z:3 * Z],
                       demand_pods=h[:, 3 * Z:3 * Z + 2],
                       is_peak=h[:, 3 * Z + 2])
    return Carry(state, acc, wl, held)


def _stack(states0, ticks):
    """(final state, StepMetrics stacked on axis 1) of a tick loop."""
    state, per_tick = states0, []
    for state, metrics, _, _ in ticks:
        per_tick.append(metrics)
    return state, StepMetrics(*(torch.stack(x, dim=1)
                                for x in zip(*per_tick)))


def rollout(params: SimParams, states0: ClusterState, action_fn: ActionFn,
            traces: ExogenousTrace, seed: int = 0, *,
            stochastic: bool = False, faults: FaultStep | None = None,
            workloads: WorkloadStep | None = None, tick0: int = 0,
            cluster0: int = 0):
    """`batched_rollout_summary`'s closed loop, returning ``(final_state,
    metrics)`` with every `StepMetrics` leaf stacked per tick
    ([B, T, ...]). ``tick0`` offsets the global tick of the interruption
    draws (a segment of a longer run), ``cluster0`` the global cluster
    (a shard of a larger fleet)."""
    return _stack(states0, _ticks(
        params, states0, action_fn, traces, seed, stochastic=stochastic,
        faults=faults, workloads=workloads, tick0=tick0, cluster0=cluster0))


def rollout_actions(params: SimParams, states0: ClusterState,
                    actions: Action, traces: ExogenousTrace, seed: int = 0,
                    *, stochastic: bool = False,
                    faults: FaultStep | None = None,
                    workloads: WorkloadStep | None = None, tick0: int = 0):
    """Rollout under a precomputed action sequence: ``actions`` leaves are
    [B, T, ...] (one plan per cluster). The diff-MPC path: gradients flow
    from the per-tick metrics ([B, T, ...]) back into every action of the
    plan. A plan observes nothing, so under ``faults`` only the
    dynamics-side disturbances apply, and ``workloads`` queues drain as in
    :func:`rollout`."""
    return _stack(states0, _ticks(
        params, states0, lambda s, e, t: Action(*(x[:, t] for x in actions)),
        traces, seed, stochastic=stochastic, faults=faults,
        workloads=workloads, observe=False, tick0=tick0))
