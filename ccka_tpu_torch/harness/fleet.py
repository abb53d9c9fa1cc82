"""Fleet-scale control: ONE batched decide per tick, N per-cluster sinks.

The PyTorch form of `ccka_tpu/harness/fleet.py`. The policy runs once per
tick over all N cluster states as one batch-first call, and only the
rendered per-cluster NodePool patches fan out host-side to each cluster's
ActuationSink.

One tick is one device program. The JAX package jits it; on the card the
port captures the whole chain once as a CUDA graph and replays it every
tick (:func:`_compiled_fleet_tick`):

- the exo slice at the tick (a device tick index, ``t mod horizon``, read
  by ``index_select``: nothing of the tick is baked into the graph), the
  batched decide, the rule shadow and the tournament roster's candidate
  lanes, the deterministic estimate step of the chosen and of the shadow
  action, the decision columns, and the pack into one ``[N, A+1]`` row
  block plus the per-cluster ``[N, W]`` block;
- its inputs are static tensors the controller copies into (states, the
  tick, and the traces when another controller last used the graph);
- one device -> host copy a tick: both blocks go ``non_blocking`` into a
  pinned host slot with a CUDA event, right behind the replay;
- pipelined ticks: :meth:`FleetController.run` dispatches tick t+1
  before it harvests and fans out tick t (sound because sink results
  never feed the device state estimate); every in-flight tick owns its
  pinned slot, so a later copy never overwrites an unharvested one;
- thread-pooled fan-out: per-sink render + apply through a worker pool
  in contiguous chunks.

On the CPU the same body runs eagerly. Every entry runs on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.actuation.patches import render_nodepool_patches
from ccka_tpu_torch.actuation.reconcile import Reconciler
from ccka_tpu_torch.actuation.sink import ActuationSink
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.graphs import Graph, copy_in, static
from ccka_tpu_torch.policy.base import PolicyBackend
from ccka_tpu_torch.signals.base import SignalSource
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.dynamics import step as sim_step
from ccka_tpu_torch.sim.rollout import exo_steps, initial_state
from ccka_tpu_torch.sim.types import Action, ClusterState, SimParams

# Rank of each Action leaf for one cluster ([P, Z], [P, 2], [P], [P], [C]).
_ACTION_RANKS = (2, 2, 1, 1, 1)


@dataclasses.dataclass
class FleetTickReport:
    """One fleet tick: aggregate KPIs + per-cluster apply health."""

    t: int
    n_clusters: int
    applied: int               # clusters whose patches all applied
    slo_ok: int                # clusters meeting the SLO gate this tick
    cost_usd_hr: float         # fleet-total spend rate
    carbon_g_hr: float         # fleet-total emission rate
    pending_pods: float        # fleet-total backlog
    decide_ms: float           # host time blocked on device work
    fanout_ms: float           # host render + sink apply


@dataclasses.dataclass
class _Dispatched:
    """In-flight device work for one tick: the tick's host slot (pinned
    on the card, with the event its copy records) or, on the CPU, the
    blocks themselves."""

    t: int
    packed: torch.Tensor       # [N, A+1] actions ++ is_peak column
    # [N, W] per-cluster rows: slo_ok, cost, carbon, pending in the first
    # four columns, then the decision-provenance columns + rule-shadow
    # action (`obs/decisions.decision_row_layout`).
    per_metrics: torch.Tensor
    dispatch_ms: float
    event: "torch.cuda.Event | None" = None
    slot: "_HostSlot | None" = None


def action_layout(cluster) -> tuple[list[tuple], list[int]]:
    """Host-side (shapes, sizes) unpack plan for a packed action row,
    derived from a template Action so it tracks the NamedTuple's field
    order and leaf shapes by construction."""
    template = Action.neutral(cluster.n_pools, cluster.n_zones,
                              device="cpu")
    shapes = [tuple(leaf.shape) for leaf in template]
    sizes = [int(np.prod(s)) for s in shapes]
    return shapes, sizes


def unpack_action_row(row: np.ndarray, shapes, sizes) -> Action:
    """One packed [A] row (is_peak column already stripped) -> Action."""
    leaves, off = [], 0
    for shape, size in zip(shapes, sizes):
        leaves.append(row[off:off + size].reshape(shape))
        off += size
    return Action(*leaves)


# -- the device-side tick pieces ---------------------------------------------


def exo_at(xs_all: ExoStep, t: torch.Tensor, horizon_ticks: int) -> ExoStep:
    """Every [N, T, ...] trace leaf at tick ``t`` (a 0-dim int64 tensor on
    the traces' device), mod the horizon: ``index_select`` on a device
    index, so a captured graph replays at whatever tick is copied in."""
    t_mod = torch.remainder(t, horizon_ticks).reshape(1)
    return ExoStep(*(x.index_select(1, t_mod).squeeze(1) for x in xs_all))


def batched_action(action: Action, n: int) -> Action:
    """``action`` with the cluster axis in front of every leaf (a shared
    leaf is expanded to the fleet)."""
    return Action(*(x.expand(n, *x.shape) if x.dim() == r else x
                    for x, r in zip(action, _ACTION_RANKS)))


def flatten_actions(actions: Action, n: int) -> torch.Tensor:
    """Batched Action -> [N, A] packed rows (field order)."""
    return torch.cat([a.reshape(n, -1) for a in batched_action(actions, n)],
                     dim=-1)


def pack_rows(flat: torch.Tensor, exo_n: ExoStep) -> torch.Tensor:
    """[N, A] action rows ++ the is_peak column -> [N, A+1]."""
    return torch.cat([flat, (exo_n.is_peak > 0.5).to(torch.float32)[:, None]],
                     dim=-1)


def per_cluster_metrics(metrics) -> torch.Tensor:
    """StepMetrics -> [N, 4] rows: slo_ok, cost, carbon, pending."""
    pending = metrics.pending_pods
    return torch.stack([
        metrics.slo_ok.to(torch.float32),
        metrics.cost_usd,
        metrics.carbon_g,
        pending.sum(dim=tuple(range(1, pending.dim()))),
    ], dim=-1)


def _capturable_backends() -> tuple:
    """Backends whose decide is a fixed chain of tensor operations of the
    batch: no Python branch on ``t`` or on a tensor's value, no host
    read. These capture into the fleet graph. The MPC backend does not:
    its decide turns the tick into a Python int to pick its plan slot,
    and its replans run on the host's cadence (its ``action_fn`` refuses
    a fixed-policy caller in both packages)."""
    from ccka_tpu_torch.obs.tournament import OverProvisionPolicy
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.train.ppo import PPOBackend

    return (RulePolicy, CarbonAwarePolicy, PPOBackend, OverProvisionPolicy)


def _require_capturable(backend, role: str) -> None:
    if not isinstance(backend, _capturable_backends()):
        name = getattr(backend, "name", type(backend).__name__)
        raise ValueError(
            f"fleet tick: {role} {name!r} ({type(backend).__name__}) cannot "
            "be captured into the fleet's CUDA graph (its decide is not a "
            "fixed chain of tensor operations); the captured backends are "
            "rule, carbon, ppo and the tournament's registered candidates")


class _FleetTick:
    """A batched tick body ``body(states, xs_all, *scalars_and_rows)``. On
    the card (``graphed``) it is captured once as a CUDA graph at its
    first call and replayed at every later one: the inputs live in static
    tensors copied into before each replay, and the outputs are the
    graph's own tensors, overwritten by the next replay, so a caller
    copies them out first. On the CPU every call runs the body eagerly.
    :meth:`eager` runs the body without the graph (the bitwise
    reference); ``captures`` counts the captures.

    After the states and the ``[N, T, ...]`` traces come the body's other
    inputs: an int (the tick, a row offset) is a device int64 scalar
    filled before each replay; a tensor (the service's lanes and held
    rows) is copied into its static slot. The traces are copied into the
    graph's slot only when another tensor than the last one is passed
    (``stream_copies`` counts those copies): one caller replaying the
    graph never copies its stream again."""

    def __init__(self, body, graphed: bool):
        self._body = body
        self._graphed = graphed
        self._graph = None
        self._xs_src = None
        self.captures = 0
        self.stream_copies = 0

    @staticmethod
    def _scalars(args, device):
        return tuple(a if isinstance(a, torch.Tensor)
                     else torch.tensor(int(a), dtype=torch.int64,
                                       device=device) for a in args)

    @torch.no_grad()
    def eager(self, states, xs_all, *args):
        return self._body(states, xs_all,
                          *self._scalars(args, xs_all.is_peak.device))

    @torch.no_grad()
    def __call__(self, states, xs_all, *args):
        if not self._graphed:
            return self.eager(states, xs_all, *args)
        if self._graph is None:
            self._states, self._xs = static(states), static(xs_all)
            self._xs_src = xs_all
            self._args = static(self._scalars(args, states[0].device))
            self._graph = Graph(lambda: self._body(self._states, self._xs,
                                                   *self._args))
            self.captures += 1
            self.stream_copies += 1
        copy_in(self._states, states)
        if xs_all is not self._xs_src:
            copy_in(self._xs, xs_all)
            self._xs_src = xs_all
            self.stream_copies += 1
        for slot, a in zip(self._args, args):
            if isinstance(a, torch.Tensor):
                slot.copy_(a)
            else:
                slot.fill_(int(a))
        self._graph.graph.replay()
        return self._graph.out


@functools.lru_cache(maxsize=32)
def _compiled_fleet_tick(cfg: FrameworkConfig, backend, n: int,
                         horizon_ticks: int, device: str):
    """The batched fleet tick, built ONCE per (config, backend, fleet
    size, horizon, device) — the roster names ride ``cfg.obs`` and so key
    it too, while the host toggle ``obs.tournament_enabled`` is never
    read here. Keyed on the BACKEND instance (identity-hashed);
    ``backend.action_fn()`` is resolved inside the builder. Returns
    ``(packed [N, A+1], new_states, per [N, W])`` — per-CLUSTER metric
    rows whose first four columns are slo_ok/cost/carbon/pending,
    followed by the decision-provenance columns and the rule-shadow
    action (`obs/decisions.decision_row_layout`) and, with a roster, the
    tournament block: the rule profile and every candidate evaluated on
    the SAME states and observed exo in the SAME program. The shadow and
    candidate lanes run UNCONDITIONALLY — a ledger toggling on can never
    select another graph, which is what makes ledger-on/off bitwise
    non-interference hold by construction.

    On ``cuda`` the body is captured into one CUDA graph at its first
    call (a backend or candidate that cannot be captured is refused here,
    naming itself: there is no eager fallback on the card); on the CPU
    it runs eagerly. Watched as ``fleet.tick`` (`obs/compile.py`), hot,
    with shared stats: one capture per key is expected, any later one is
    counted as a recapture."""
    from ccka_tpu_torch.obs.compile import watch_jit
    from ccka_tpu_torch.obs.decisions import shadow_decision_columns
    from ccka_tpu_torch.obs.tournament import (TournamentRoster,
                                               add_candidate_lanes,
                                               region_onehot)
    from ccka_tpu_torch.policy.rule import RulePolicy

    dev = torch.device(device)
    roster = TournamentRoster(cfg, cfg.obs.tournament_roster, device=dev)
    if dev.type == "cuda":
        _require_capturable(backend, "backend")
        for name in roster.names:
            _require_capturable(roster.backend(name), f"candidate {name!r}")
    action_fn = backend.action_fn()
    shadow_fn = RulePolicy(cfg.cluster, device=dev).action_fn()
    params = SimParams.from_config(cfg, device=dev)
    cand_fns = roster.action_fns()
    zone_region_index = cfg.cluster.zone_region_index
    n_regions = cfg.cluster.n_regions
    # Made before the capture: a captured body may not copy from the host.
    onehot = region_onehot(zone_region_index, n_regions, dev)

    def step_n(states, actions, exo_n):
        return sim_step(params, states, actions, exo_n, stochastic=False)

    def fleet_tick(states, xs_all, t):
        """Slice exo, decide (+ rule shadow + tournament candidates),
        estimate all, pack per cluster."""
        exo_n = exo_at(xs_all, t, horizon_ticks)
        actions = batched_action(action_fn(states, exo_n, t), n)
        shadow = batched_action(shadow_fn(states, exo_n, t), n)
        new_states, metrics = step_n(states, actions, exo_n)
        # Counterfactual one-step projection: same pre-step states, same
        # exo — only the action differs. The shadow's next state is
        # discarded (the real estimate chain must not fork).
        _sh_states, sh_metrics = step_n(states, shadow, exo_n)
        flat = flatten_actions(actions, n)
        flat_sh = flatten_actions(shadow, n)
        packed = pack_rows(flat, exo_n)
        blocks = [
            per_cluster_metrics(metrics),
            shadow_decision_columns(metrics, sh_metrics, exo_n, flat,
                                    flat_sh),
            flat_sh,
        ]
        if cand_fns:
            blocks.append(add_candidate_lanes(
                states, exo_n, t, flat, cand_fns, step_n, n,
                zone_region_index, n_regions, onehot=onehot))
        return packed, new_states, torch.cat(blocks, dim=-1)

    return watch_jit(_FleetTick(fleet_tick, graphed=dev.type == "cuda"),
                     "fleet.tick", hot=True, shared_stats=True)


class _HostSlot:
    """Pinned host buffers for one in-flight tick's two blocks, and the
    event its device -> host copy records."""

    def __init__(self, packed: torch.Tensor, per: torch.Tensor):
        self.packed = torch.empty(packed.shape, dtype=packed.dtype,
                                  pin_memory=True)
        self.per = torch.empty(per.shape, dtype=per.dtype, pin_memory=True)
        self.event = torch.cuda.Event()


class FleetController:
    """N homogeneous clusters, one batched decide, N sinks.

    ``sinks`` is one ActuationSink per cluster (dry-run in tests; kubectl
    with per-cluster contexts live — `actuation.sink.context_runner`).
    Traces are sampled on ``device`` for ``horizon_ticks`` from the
    source's ``batch_trace_device`` (a generator seeded with ``seed``);
    each cluster gets its own stream. ``backend`` lives on ``device``.

    ``fanout_workers``: thread-pool width for the per-sink render+apply
    fan-out (no sink is ever driven from two workers at once).
    ``ledger`` (an `obs.decisions.DecisionLedger`) records every tick's
    rows after its decisions; with ``incident_log`` too, a windowed
    divergence spike stamps ``policy_divergence``.
    """

    def __init__(self, cfg: FrameworkConfig, backend: PolicyBackend,
                 source: SignalSource, sinks: Sequence[ActuationSink],
                 *, horizon_ticks: int = 2880, seed: int = 0,
                 fanout_workers: int = 8, tracer=None, ledger=None,
                 incident_log=None, device=None,
                 log_fn: Callable[[str], None] | None = None):
        from ccka_tpu_torch.obs.decisions import decision_row_layout
        from ccka_tpu_torch.obs.trace import SpanTracer

        if not hasattr(source, "batch_trace_device"):
            raise ValueError(
                "FleetController needs a device-batched signal source "
                "(synthetic or replay); live fleets should shard "
                "per-cluster sources onto per-cluster controllers instead")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.backend = backend
        self.sinks = list(sinks)
        self.n = len(self.sinks)
        # Desired-state reconciliation per cluster: the fan-out converges
        # each sink onto its rendered patches (retry + read-back). Backoff
        # is tiny: the worker pool already parallelizes per-sink stalls.
        self._reconcilers = [
            Reconciler(s, max_rounds=2, backoff_s=0.01, deadline_s=2.0,
                       seed=seed ^ (0x5EC0 + i))
            for i, s in enumerate(self.sinks)]
        self.params = SimParams.from_config(cfg, device=self.device)
        self.log_fn = log_fn or (lambda s: None)
        # Retention-bounded by default: a fleet daemon ticks forever.
        self.tracer = tracer or SpanTracer(max_spans=4096)
        n = self.n

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._traces = source.batch_trace_device(horizon_ticks, gen, n,
                                                 device=self.device)
        self.horizon_ticks = horizon_ticks
        self._seed = seed
        self.states: ClusterState = initial_state(cfg, n, device=self.device)

        self._action_shapes, self._action_sizes = action_layout(
            cfg.cluster)
        self._pool = (ThreadPoolExecutor(max_workers=fanout_workers,
                                         thread_name_prefix="ccka-fanout")
                      if fanout_workers > 1 else None)
        self._workers = max(1, fanout_workers)

        self._xs_all = exo_steps(self._traces)    # [N, T, ...] on device
        self._tick_fn = _compiled_fleet_tick(cfg, backend, n, horizon_ticks,
                                             str(self.device))
        self._slots: list[_HostSlot] = []
        self.ledger = ledger
        self.incident_log = incident_log
        self._dec_layout = decision_row_layout(
            cfg.cluster, candidates=cfg.obs.tournament_roster)
        # The latest harvested (t, packed [N, A+1], per [N, W]) host
        # blocks, for callers scoring rows beside the ledger.
        self.last_rows: tuple | None = None

    def _fleet_tick(self, states, t):
        """The batched tick over this fleet's traces (a bound entry the
        tests probe directly); the outputs are the graph's on the card."""
        return self._tick_fn(states, self._xs_all, t)

    # -- device side --------------------------------------------------------

    def _dispatch(self, t: int) -> _Dispatched:
        """Queue tick t's device work and start its host copy; don't
        block."""
        # Deliberately UNFENCED: host time to queue the tick.
        with self.tracer.span("fleet.dispatch", t=t) as sp:
            packed, new_states, per = self._fleet_tick(self.states, t)
            if self.device.type != "cuda":
                self.states = new_states
                disp = _Dispatched(t, packed, per, 0.0)
            else:
                # Graph outputs are overwritten by the next replay: the
                # states and both blocks leave them now, in stream order.
                for d, s in zip(self.states, new_states):
                    d.copy_(s)
                slot = (self._slots.pop() if self._slots
                        else _HostSlot(packed, per))
                slot.packed.copy_(packed, non_blocking=True)
                slot.per.copy_(per, non_blocking=True)
                slot.event.record()
                disp = _Dispatched(t, slot.packed, slot.per, 0.0,
                                   event=slot.event, slot=slot)
        disp.dispatch_ms = sp.dur_ms
        return disp

    # -- host side ----------------------------------------------------------

    def _unpack_action(self, row: np.ndarray) -> Action:
        return unpack_action_row(row, self._action_shapes,
                                 self._action_sizes)

    def _fanout(self, packed: np.ndarray) -> int:
        """Render + apply every cluster's patches; returns #applied-ok."""
        def chunk(lo: int, hi: int) -> int:
            ok = 0
            for i in range(lo, hi):
                a_i = self._unpack_action(packed[i, :-1])
                is_peak = packed[i, -1] > 0.5
                patches = render_nodepool_patches(
                    a_i, self.cfg.cluster,
                    op="add" if is_peak else "replace")
                ok += self._reconcilers[i].converge(patches).converged
            return ok

        w = min(self._workers, self.n)
        if self._pool is None or w <= 1:
            return chunk(0, self.n)
        bounds = np.linspace(0, self.n, w + 1).astype(int)
        futures = [self._pool.submit(chunk, int(lo), int(hi))
                   for lo, hi in zip(bounds[:-1], bounds[1:])]
        return sum(f.result() for f in futures)

    def _harvest_and_fanout(self, disp: _Dispatched) -> FleetTickReport:
        # The harvest span blocks on the tick's copy, so decide_ms =
        # dispatch + harvest is host time blocked on device work.
        with self.tracer.span("fleet.harvest", t=disp.t) as sp_h:
            if disp.event is not None:
                disp.event.synchronize()
            packed = disp.packed.numpy().copy()
            per_np = disp.per_metrics.numpy().copy()
            if disp.slot is not None:
                self._slots.append(disp.slot)
            agg = per_np[:, :4].sum(axis=0)
        self.last_rows = (disp.t, packed, per_np)
        # Decision provenance: host-side recording strictly AFTER the
        # tick's decisions, before fan-out. A bare fleet tick has no lane
        # machinery, so every row records as the fresh lane.
        if self.ledger is not None:
            surfaces = self.ledger.observe_tick(disp.t, per_np, packed,
                                                self._dec_layout)
            spike = surfaces.get("spike")
            if spike is not None and self.incident_log is not None:
                self.incident_log.stamp("policy_divergence", t=disp.t,
                                        **spike)
        with self.tracer.span("fleet.fanout", t=disp.t) as sp_f:
            applied = self._fanout(packed)

        dt_hr = float(np.float32(self.cfg.sim.dt_s)) / 3600.0
        report = FleetTickReport(
            t=disp.t,
            n_clusters=self.n,
            applied=applied,
            slo_ok=int(agg[0]),
            cost_usd_hr=float(agg[1]) / dt_hr,
            carbon_g_hr=float(agg[2]) / dt_hr,
            pending_pods=float(agg[3]),
            decide_ms=round(disp.dispatch_ms + sp_h.dur_ms, 3),
            fanout_ms=round(sp_f.dur_ms, 3),
        )
        self.log_fn(
            f"fleet t={report.t}: {report.applied}/{self.n} applied, "
            f"{report.slo_ok}/{self.n} slo-ok, "
            f"${report.cost_usd_hr:.2f}/hr, decide {report.decide_ms}ms, "
            f"fanout {report.fanout_ms}ms")
        return report

    def tick(self, t: int) -> FleetTickReport:
        """Synchronous single tick (tests / cadenced live loops)."""
        return self._harvest_and_fanout(self._dispatch(t))

    # -- durable snapshot / resume ------------------------------------------
    #
    # The fleet's device state is the [N, ...] ClusterState batch; the
    # estimate step draws nothing (deterministic mode), so unlike the JAX
    # package's body there is no PRNG key. Traces regenerate
    # deterministically from (source, seed) at construction.

    def snapshot_body(self, next_tick: int) -> dict:
        from ccka_tpu_torch.harness import snapshot as snap

        return {
            "kind": "fleet",
            "next_tick": int(next_tick),
            "n_clusters": int(self.n),
            "seed": int(self._seed),
            "horizon_ticks": int(self.horizon_ticks),
            "config_sha256": snap.config_digest(self.cfg),
            "states": snap.encode_tree(self.states),
        }

    def write_snapshot(self, path: str, next_tick: int) -> str:
        from ccka_tpu_torch.harness.snapshot import save_snapshot
        return save_snapshot(path, self.snapshot_body(next_tick))

    def restore(self, body: dict) -> int:
        """Restore device state from a snapshot body; returns the resume
        tick. Identity mismatches (config, fleet size, seed, horizon) are
        refused: the exo streams would fork from the run being
        resumed."""
        from ccka_tpu_torch.harness import snapshot as snap

        if body.get("kind") != "fleet":
            raise snap.SnapshotError(
                f"snapshot kind {body.get('kind')!r} is not a fleet "
                "snapshot")
        if body.get("config_sha256") != snap.config_digest(self.cfg):
            raise snap.SnapshotError(
                "fleet snapshot was taken under a different config")
        if int(body.get("n_clusters", -1)) != self.n:
            raise snap.SnapshotError(
                f"fleet snapshot holds {body.get('n_clusters')} clusters, "
                f"this controller drives {self.n}")
        if (int(body.get("seed", -1)) != self._seed
                or int(body.get("horizon_ticks", -1))
                != self.horizon_ticks):
            raise snap.SnapshotError(
                "fleet snapshot seed/horizon mismatch — the exo streams "
                "would fork from the run being resumed")
        self.states = snap.decode_like(self.states, body["states"])
        return int(body["next_tick"])

    def run(self, ticks: int, start_tick: int = 0, *,
            pipeline_depth: int = 2) -> list[FleetTickReport]:
        """Pipelined loop: up to ``pipeline_depth`` ticks of device work
        stay in flight ahead of the host harvest + fan-out. Peak in-flight
        is briefly ``depth + 1`` (the new dispatch is issued before the
        oldest is harvested), each tick with its own host slot."""
        from collections import deque

        depth = max(1, pipeline_depth)
        reports: list[FleetTickReport] = []
        inflight: deque[_Dispatched] = deque()
        for t in range(start_tick, start_tick + ticks):
            inflight.append(self._dispatch(t))
            if len(inflight) > depth:
                reports.append(self._harvest_and_fanout(inflight.popleft()))
        while inflight:
            reports.append(self._harvest_and_fanout(inflight.popleft()))
        return reports

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def fleet_controller_from_config(cfg: FrameworkConfig,
                                 backend: PolicyBackend, n_clusters: int,
                                 *, horizon_ticks: int = 2880,
                                 seed: int = 0, fanout_workers: int = 8,
                                 log_fn=None, device=None
                                 ) -> FleetController:
    """Dry-run fleet wiring on ``device`` (the card unless
    ``device="cpu"``): N in-memory sinks over the synthetic source. Live
    fleets construct FleetController directly with per-cluster
    KubectlSinks (`context_runner` per kube-context)."""
    from ccka_tpu_torch.actuation.sink import DryRunSink
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    device = resolve_device(device)
    source = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                   cfg.signals)
    sinks = [DryRunSink() for _ in range(n_clusters)]
    return FleetController(cfg, backend, source, sinks,
                           horizon_ticks=horizon_ticks, seed=seed,
                           fanout_workers=fanout_workers, log_fn=log_fn,
                           device=device)
