"""Differentiable MPC: the gradient of the objective through the simulator.

The PyTorch form of `ccka_tpu/train/mpc.py`. A plan is a latent action
sequence [H, A] per cluster; the objective (`train/objective.py`, plus a
terminal cost) backpropagates through `sim/rollout.py::rollout_actions`
in deterministic mode, and Adam descends it. Batch first: the clusters of
a fleet are independent and Adam works elementwise, so one autograd pass
over the batch's summed objective gives every cluster its own gradient
and its own plan.

Closed-loop use is receding horizon: replan every ``replan_every`` ticks
from the current state against an H-tick window (the true future, or a
forecaster's prediction from the observed history), execute the plan's
first ``replan_every`` actions, warm-start the next segment with the plan
rolled forward. :func:`receding_horizon_plan_batch` executes on expected
dynamics and returns the executed latents (the plan kernel's input, as in
the boards' mpc rows); :func:`receding_horizon_rollout` executes on the
true trace, stochastic if asked, and returns per-tick metrics.

On a CUDA device the planner replays one segment (its optimization and
its execution) as a CUDA graph, and :meth:`MPCBackend.replan` its
optimization as another: the step is a few hundred small kernels a
tick, so launching them one by one from the host would set its speed.
The graphed planner computes what the eager one does, bit for bit. The
captures are counted (`obs/compile.py`) under "mpc.segment_graph" and
"mpc.replan".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import ClusterConfig, FrameworkConfig, TrainConfig
from ccka_tpu_torch.graphs import Graph, copy_in, static
from ccka_tpu_torch.models.nets import action_to_latent, latent_to_action
from ccka_tpu_torch.obs.compile import watch_jit
from ccka_tpu_torch.policy.base import PolicyBackend
from ccka_tpu_torch.policy.rule import neutral_action
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.rollout import rollout_actions
from ccka_tpu_torch.sim.types import (Action, ClusterState, SimParams,
                                      StepMetrics)
from ccka_tpu_torch.train.objective import episode_objective
from ccka_tpu_torch.train.optim import Adam


class PlanResult(NamedTuple):
    plan_latent: torch.Tensor  # [N, H, A] optimized latent plans
    losses: torch.Tensor       # [N, iters] each cluster's objective


def plan_objective(params: SimParams, cluster: ClusterConfig,
                   tcfg: TrainConfig, states0: ClusterState,
                   window: ExogenousTrace,
                   latent: torch.Tensor) -> torch.Tensor:
    """[N] objective of latent plans [N, H, A] over windows [N, H, ...]
    from ``states0``: the episode objective of the deterministic rollout,
    plus ``mpc_terminal_ticks`` more ticks of the final fleet's spend and
    emissions at the window's last prices and carbon and a mid-load power
    draw."""
    final, metrics = rollout_actions(
        params, states0, latent_to_action(latent, cluster), window)
    j = episode_objective(metrics, tcfg)
    if tcfg.mpc_terminal_ticks > 0:
        dt_hr = params.dt_s / 3600.0
        Z = window.spot_price_hr.shape[-1]
        price_zc = torch.stack([window.spot_price_hr[:, -1],
                                window.od_price_hr[:, -1]], dim=-1)
        nodes_zc = final.nodes.sum(dim=1)                    # [N, Z, CT]
        nodes_zc = torch.stack([nodes_zc[..., 0],
                                nodes_zc[..., 1] + params.base_od_nodes / Z],
                               dim=-1)
        cost_rate = (nodes_zc * price_zc).sum(dim=(1, 2)) * dt_hr
        watts_mid = 0.5 * (params.watts_idle + params.watts_full)
        kwh_z = nodes_zc.sum(dim=-1) * watts_mid / 1000.0 * dt_hr
        carbon_rate = (kwh_z * window.carbon_g_kwh[:, -1]).sum(dim=-1)
        j = j + tcfg.mpc_terminal_ticks * (
            cost_rate + tcfg.carbon_weight * carbon_rate)
    return j


def optimize_plan_batch(params: SimParams, cluster: ClusterConfig,
                        tcfg: TrainConfig, states0: ClusterState,
                        windows: ExogenousTrace, init_latents: torch.Tensor,
                        *, iters: int = 50) -> PlanResult:
    """Plan every cluster of a batch against its window: ``iters`` Adam
    steps (``optax.adam(learning_rate * 10)``, fresh moments) on the
    summed objective, from ``init_latents`` [N, H, A]; windows
    [N, H, ...]. Returns [N, H, A] plans and [N, iters] losses (each
    iteration's objective before its step)."""
    opt = Adam(tcfg.learning_rate * 10.0)
    latent = init_latents.detach()
    state = opt.init(latent)
    losses = []
    for _ in range(iters):
        with torch.enable_grad():
            x = latent.detach().requires_grad_(True)
            j = plan_objective(params, cluster, tcfg, states0, windows, x)
            g, = torch.autograd.grad(j.sum(), x)
        upd, state = opt.update(g, state)
        latent = latent + upd
        losses.append(j.detach())
    return PlanResult(plan_latent=latent, losses=(
        torch.stack(losses, dim=1) if losses
        else latent.new_zeros((latent.shape[0], 0))))


def optimize_plan(params: SimParams, cluster: ClusterConfig,
                  tcfg: TrainConfig, state0: ClusterState,
                  trace: ExogenousTrace, init_latent: torch.Tensor, *,
                  iters: int = 50) -> PlanResult:
    """One cluster's plan: ``state0`` a batch of one, ``trace`` [H, ...],
    ``init_latent`` [H, A]; returns [H, A] and [iters]."""
    r = optimize_plan_batch(params, cluster, tcfg, state0,
                            ExogenousTrace(*(x[None] for x in trace)),
                            init_latent[None], iters=iters)
    return PlanResult(r.plan_latent[0], r.losses[0])


def _gather(traces: ExogenousTrace, idx: torch.Tensor) -> ExogenousTrace:
    """Ticks ``idx`` [L] of [N, T, ...] traces."""
    return ExogenousTrace(*(x[:, idx] for x in traces))


def _segment_windows(traces: ExogenousTrace, horizon: int,
                     replan_every: int, forecaster=None,
                     history_steps: int = 0):
    """Yields ``(window [N, H, ...], segment [N, R, ...])`` for each plan
    segment of [N, T, ...] traces, sliced as the loop runs (a fleet-day's
    windows are never all held at once). Without a forecaster the window
    is the true future, clamped at the last tick; with one, tick 0 is the
    observed segment-start tick and ticks 1..H-1 its prediction from the
    ``history_steps`` ticks up to the start (left-clamped at tick 0)."""
    T = traces.steps
    if T % replan_every:
        raise ValueError(f"trace length {T} not a multiple of "
                         f"replan_every={replan_every}")
    dev = traces.is_peak.device
    ar_h = torch.arange(horizon, device=dev)
    if forecaster is not None:
        from ccka_tpu_torch.forecast.base import planning_window

        h_steps = history_steps or forecaster.wanted_history(horizon)
        ar_hist = torch.arange(1 - h_steps, 1, device=dev)
    for start in range(0, T, replan_every):
        if forecaster is None:
            window = _gather(traces, torch.clamp(start + ar_h, max=T - 1))
        else:
            window = planning_window(
                forecaster, _gather(traces, torch.clamp(start + ar_hist,
                                                        min=0)), horizon)
        yield window, traces.slice_steps(start, replan_every)


def _execute(params, cluster, states, plan, seg, replan_every):
    """Run a plan's first R actions on expected dynamics; returns
    ``(state, executed latents, plan rolled forward by R)``."""
    exec_lat = plan[:, :replan_every]
    state, _ = rollout_actions(params, states,
                               latent_to_action(exec_lat, cluster), seg)
    return state, exec_lat, torch.roll(plan, -replan_every, dims=1)


def _segment(params, cluster, tcfg, states, plan, window, seg, iters,
             replan_every):
    """One receding-horizon segment of the planner: optimize, execute."""
    plan = optimize_plan_batch(params, cluster, tcfg, states, window, plan,
                               iters=iters).plan_latent
    with torch.no_grad():
        return _execute(params, cluster, states, plan, seg, replan_every)


class _SegmentGraph:
    """:func:`_segment` captured as a CUDA graph at its first call and
    replayed for every segment. ``captures`` counts the captures (one)."""

    def __init__(self, params, cluster, tcfg, iters, replan_every):
        self._args = (params, cluster, tcfg)
        self._iters, self._replan_every = iters, replan_every
        self._graph = None
        self.captures = 0

    def __call__(self, states, plan, window, seg):
        if self._graph is None:
            self.states, self.plan = static(states), plan.clone()
            self.window, self.seg = static(window), static(seg)
            self._graph = Graph(lambda: _segment(
                *self._args, self.states, self.plan, self.window, self.seg,
                self._iters, self._replan_every))
            self.captures += 1
        for dst, src in ((self.states, states), (self.window, window),
                         (self.seg, seg)):
            copy_in(dst, src)
        self.plan.copy_(plan)
        self._graph.graph.replay()
        return self._graph.out


class _PlanGraphs:
    """:func:`optimize_plan_batch` captured as a CUDA graph per input
    geometry (the clusters, the window, the plan), replayed for every
    replan of that geometry; returns copies of the outputs. ``captures``
    counts the captures."""

    def __init__(self, params, cluster, tcfg, iters):
        self._args = (params, cluster, tcfg)
        self._iters = iters
        self._graphs: dict = {}
        self.captures = 0

    def __call__(self, states, window, init) -> PlanResult:
        key = (tuple(states.nodes.shape), tuple(window.is_peak.shape),
               tuple(init.shape))
        entry = self._graphs.get(key)
        if entry is None:
            st, win, lat = static(states), static(window), init.clone()
            graph = Graph(lambda: optimize_plan_batch(
                *self._args, st, win, lat, iters=self._iters))
            entry = self._graphs[key] = (st, win, lat, graph)
            self.captures += 1
        st, win, lat, graph = entry
        copy_in(st, states)
        copy_in(win, window)
        lat.copy_(init)
        graph.graph.replay()
        return PlanResult(graph.out.plan_latent.clone(),
                          graph.out.losses.clone())


def receding_horizon_plan_batch(params: SimParams, cluster: ClusterConfig,
                                tcfg: TrainConfig, states0: ClusterState,
                                traces: ExogenousTrace,
                                init_latents: torch.Tensor, *, horizon: int,
                                replan_every: int, iters: int,
                                forecaster=None, history_steps: int = 0,
                                graph: bool | None = None) -> torch.Tensor:
    """The receding-horizon loop as a planner for N clusters: returns the
    executed [N, T, A] latents, one plan per trace. Between replans it
    executes on expected dynamics, so the plan depends only on the traces
    and the planner's settings, never on execution noise; the plan
    kernel then scores it on stochastic worlds. ``graph`` (default: on a
    CUDA device) replays each segment as a CUDA graph."""
    dev = traces.is_peak.device
    graph = dev.type == "cuda" if graph is None else graph
    N, T = traces.is_peak.shape
    if init_latents.shape[1] != horizon:
        raise ValueError(f"init_latents cover {init_latents.shape[1]} "
                         f"ticks, the horizon is {horizon}")
    out = torch.empty((N, T, init_latents.shape[-1]), dtype=torch.float32,
                      device=dev)
    states, plan = states0, init_latents.detach().contiguous()
    run = None
    for s, (window, seg) in enumerate(_segment_windows(
            traces, horizon, replan_every, forecaster, history_steps)):
        if graph and run is None:
            run = watch_jit(_SegmentGraph(params, cluster, tcfg, iters,
                                          replan_every),
                            "mpc.segment_graph", shared_stats=True)
        if graph:
            states, exec_lat, plan = run(states, plan, window, seg)
        else:
            states, exec_lat, plan = _segment(
                params, cluster, tcfg, states, plan, window, seg, iters,
                replan_every)
        out[:, s * replan_every:(s + 1) * replan_every] = exec_lat
    return out


def receding_horizon_plan(params: SimParams, cluster: ClusterConfig,
                          tcfg: TrainConfig, state0: ClusterState,
                          trace: ExogenousTrace, init_latent: torch.Tensor,
                          *, horizon: int, replan_every: int, iters: int,
                          forecaster=None, history_steps: int = 0,
                          graph: bool | None = None) -> torch.Tensor:
    """One cluster's executed [T, A] latents: ``state0`` a batch of one,
    ``trace`` [T, ...], ``init_latent`` [H, A]."""
    return receding_horizon_plan_batch(
        params, cluster, tcfg, state0,
        ExogenousTrace(*(x[None] for x in trace)), init_latent[None],
        horizon=horizon, replan_every=replan_every, iters=iters,
        forecaster=forecaster, history_steps=history_steps, graph=graph)[0]


def receding_horizon_rollout(params: SimParams, cluster: ClusterConfig,
                             tcfg: TrainConfig, states0: ClusterState,
                             traces: ExogenousTrace,
                             init_latents: torch.Tensor, seed: int = 0, *,
                             horizon: int, replan_every: int, iters: int,
                             stochastic: bool = True, forecaster=None,
                             history_steps: int = 0):
    """Closed-loop receding-horizon MPC over [N, T, ...] traces: each
    segment replans against its window (true future or forecast), then
    executes its first ``replan_every`` actions on the true trace,
    stochastic if asked (interruptions drawn at the global tick from
    ``seed``'s Philox stream). Returns ``(final_state, metrics)`` with
    per-tick metrics [N, T, ...], like `sim/rollout.py::rollout`.
    ``traces.steps`` must be a multiple of ``replan_every``."""
    states, plan, parts = states0, init_latents.detach(), []
    for s, (window, seg) in enumerate(_segment_windows(
            traces, horizon, replan_every, forecaster, history_steps)):
        plan = optimize_plan_batch(params, cluster, tcfg, states, window,
                                   plan, iters=iters).plan_latent
        with torch.no_grad():
            states, metrics = rollout_actions(
                params, states,
                latent_to_action(plan[:, :replan_every], cluster), seg, seed,
                stochastic=stochastic, tick0=s * replan_every)
        parts.append(metrics)
        plan = torch.roll(plan, -replan_every, dims=1)
    return states, StepMetrics(*(torch.cat(x, dim=1) for x in zip(*parts)))


def zero_latent(cluster: ClusterConfig, device=None) -> torch.Tensor:
    """The codec's zero point [A], the planner's warm start: all zones
    open, both capacity types, hpa_scale = 1, at full gradient (the
    neutral profile's exact 0/1 coordinates would saturate the sigmoid)."""
    return torch.zeros_like(action_to_latent(
        neutral_action(cluster, device), cluster))


class MPCBackend(PolicyBackend):
    """Receding-horizon diff-MPC controller.

    ``decide`` executes the current plan position (the host-side live
    loop), :meth:`replan` refreshes the plan from the latest state and
    window (on a CUDA device through a graph of the optimization, the
    hot entry "mpc.replan"), :meth:`evaluate` runs the closed loop
    (:func:`receding_horizon_rollout`). ``forecaster`` None plans against
    the true future (the oracle reference); a `forecast` backend plans
    against predictions while execution bills against the true trace."""

    requires_receding_horizon = True

    def __init__(self, cfg: FrameworkConfig, *, horizon: int | None = None,
                 iters: int | None = None, replan_every: int = 8,
                 forecaster=None, history_steps: int | None = None,
                 device=None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.cluster = cfg.cluster
        self.params = SimParams.from_config(cfg, device=dev)
        self.tcfg = cfg.train
        self.horizon = horizon or cfg.train.mpc_horizon
        self.iters = iters or cfg.train.mpc_iters
        self.replan_every = replan_every
        self.forecaster = forecaster
        self.history_steps = (
            history_steps if history_steps is not None
            else (forecaster.wanted_history(self.horizon)
                  if forecaster is not None else 0))
        base = zero_latent(self.cluster, dev)
        self._plan = base.expand(self.horizon, *base.shape).clone()
        self._graphs = (watch_jit(
            _PlanGraphs(self.params, self.cluster, self.tcfg, self.iters),
            "mpc.replan", hot=True, shared_stats=True)
            if dev.type == "cuda" else None)

    def replan(self, state: ClusterState, window: ExogenousTrace
               ) -> PlanResult:
        """Plan the clusters of ``state`` against ``window`` ([N, >= H,
        ...]), warm-started from the current plan ([H, A] or [N, H, A])."""
        window = window.slice_steps(0, self.horizon)
        n = state.nodes.shape[0]
        init = (self._plan if self._plan.dim() == 3
                else self._plan.expand(n, *self._plan.shape))
        if self._graphs is not None:
            result = self._graphs(state, window, init)
        else:
            result = optimize_plan_batch(self.params, self.cluster,
                                         self.tcfg, state, window, init,
                                         iters=self.iters)
        self._plan = result.plan_latent
        return result

    def decide(self, state: ClusterState, exo: ExoStep, t: int) -> Action:
        idx = min(int(t) % self.replan_every, self.horizon - 1)
        return latent_to_action(self._plan[..., idx, :], self.cluster)

    def action_fn(self):
        """Refused: ``decide`` reads the mutable plan, so a rollout that
        took it as a fixed policy would never replan."""
        raise RuntimeError(
            "MPCBackend.action_fn() would freeze the current plan; use "
            "MPCBackend.evaluate() / receding_horizon_rollout() for "
            "closed-loop runs, or decide() in the live host loop.")

    def evaluate(self, states0: ClusterState, traces: ExogenousTrace,
                 seed: int = 0, *, stochastic: bool = True):
        """Closed-loop run over [N, T, ...] ``traces``; returns
        ``(final_state, metrics [N, T, ...])``. A horizon that is not a
        multiple of ``replan_every`` is padded with its last tick
        (persistence) and the metrics cut back to T ticks; the state
        reflects the padded run."""
        T = traces.steps
        R = self.replan_every
        pad = (-T) % R
        if pad:
            traces = ExogenousTrace(*(
                torch.cat([x, x[:, -1:].expand(
                    -1, pad, *x.shape[2:])], dim=1) for x in traces))
        n = states0.nodes.shape[0]
        init = (self._plan if self._plan.dim() == 3
                else self._plan.expand(n, *self._plan.shape))
        final, metrics = receding_horizon_rollout(
            self.params, self.cluster, self.tcfg, states0, traces, init,
            seed, horizon=self.horizon, replan_every=R, iters=self.iters,
            stochastic=stochastic, forecaster=self.forecaster,
            history_steps=self.history_steps)
        if pad:
            metrics = StepMetrics(*(m[:, :T] for m in metrics))
        return final, metrics
