"""Rollouts: a Python loop over the horizon, the batch axis written out.

The PyTorch form of `ccka_tpu/sim/rollout.py`: ``batched_rollout_summary``
(KPIs folded inside the loop), ``rollout`` and ``rollout_actions``
(per-tick metrics), with the optional fault and workload lanes threaded
through. It is the reference the CUDA rollout kernels are held against,
and it stays differentiable in deterministic mode.
"""

from __future__ import annotations

from typing import Callable

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
           observe: bool = True, tick0: int = 0):
    """The loop every rollout shares: yields ``(state, metrics)`` after
    each tick. ``decide(state, observed_exo, t)`` picks tick t's action;
    with ``observe`` False (a plan, which observes nothing) the held
    observation of a fault outage is not formed. Interruption draws are
    addressed by the global tick ``tick0 + t``."""
    xs = exo_steps(traces)
    B, T = traces.is_peak.shape
    P, Z = states0.nodes.shape[1:3]
    dev = states0.nodes.device
    clusters = torch.arange(B, device=dev)[:, None]
    rows = torch.arange(P * Z, device=dev)[None, :]
    state = states0
    wl_state = None if workloads is None else _wl_zero(params, B, dev)
    last = None
    for t in range(T):
        exo = ExoStep(*(x[:, t] for x in xs))
        fault = obs = None
        if faults is not None:
            fault = FaultStep(*(x[:, t] for x in faults))
            if observe:
                obs = observed_exo(exo if last is None else last, exo,
                                   fault.signal_stale)
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
        yield state, metrics


def batched_rollout_summary(params: SimParams, states0: ClusterState,
                            action_fn: ActionFn, traces: ExogenousTrace,
                            seed: int = 0, *, stochastic: bool = False,
                            faults: FaultStep | None = None,
                            workloads: WorkloadStep | None = None):
    """Closed-loop rollout of a batch of clusters over the traces' horizon,
    folded into one EpisodeSummary per cluster inside the loop (memory
    O(B), whatever the horizon). Returns ``(final_state, summary)``.

    In stochastic mode the interruption draws of cluster b at tick t come
    from `sim/random.py` at (``seed``, b, t, spot row); the CUDA rollout
    kernels draw the same numbers.

    ``faults``: optional `FaultStep` with leaves [B, T, Z] / [B, T]; each
    tick's disturbances feed the step, and the policy observes held
    signals during outages (tick 0 observes its own, fresh).
    ``workloads``: optional `WorkloadStep` with leaves [B, T]; the
    family queues start empty and drain from the fleet's headroom (the
    policy does not observe them). ``None`` for both is the program
    without lanes, bitwise."""
    state = states0
    acc = SummaryAcc.zero(traces.is_peak.shape[0], states0.nodes.device)
    for state, metrics in _ticks(params, states0, action_fn, traces, seed,
                                 stochastic=stochastic, faults=faults,
                                 workloads=workloads):
        acc = acc.update(params, metrics)
    return state, finalize_summary(params, states0, state, acc,
                                   traces.is_peak.shape[1])


def _stack(states0, ticks):
    """(final state, StepMetrics stacked on axis 1) of a tick loop."""
    state, per_tick = states0, []
    for state, metrics in ticks:
        per_tick.append(metrics)
    return state, StepMetrics(*(torch.stack(x, dim=1)
                                for x in zip(*per_tick)))


def rollout(params: SimParams, states0: ClusterState, action_fn: ActionFn,
            traces: ExogenousTrace, seed: int = 0, *,
            stochastic: bool = False, faults: FaultStep | None = None,
            workloads: WorkloadStep | None = None, tick0: int = 0):
    """`batched_rollout_summary`'s closed loop, returning ``(final_state,
    metrics)`` with every `StepMetrics` leaf stacked per tick
    ([B, T, ...]). ``tick0`` offsets the global tick of the interruption
    draws (a segment of a longer run)."""
    return _stack(states0, _ticks(
        params, states0, action_fn, traces, seed, stochastic=stochastic,
        faults=faults, workloads=workloads, tick0=tick0))


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
