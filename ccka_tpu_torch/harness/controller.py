"""The live closed-loop controller.

The PyTorch form of `ccka_tpu/harness/controller.py`: a daemon composing
the pieces the port already has, on the 30 s metrics cadence:

    scrape (SignalSource.tick) -> decide (PolicyBackend) -> render
    (NodePool patches) -> apply (Reconciler over an ActuationSink) ->
    verify (read-back) -> estimate (simulator state estimate) -> KPI line

The controller carries a :class:`ClusterState` estimate of one cluster (a
batch of one, on the controller's device) advanced through the
simulator's expected dynamics with the applied action each tick, so
policies see the observation surface they were trained on; scraped
prices, carbon, demand and is_peak are the measured inputs.

Every entry runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.actuation.patches import render_region_nodepool_patches
from ccka_tpu_torch.actuation.reconcile import Reconciler
from ccka_tpu_torch.actuation.sink import ActuationSink
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.policy.base import PolicyBackend
from ccka_tpu_torch.signals.base import ExogenousTrace, SignalSource
from ccka_tpu_torch.sim.dynamics import ExoStep, clip
from ccka_tpu_torch.sim.dynamics import step as sim_step
from ccka_tpu_torch.sim.rollout import initial_state
from ccka_tpu_torch.sim.types import (CT_SPOT, Action, ClusterState,
                                      SimParams, StepMetrics)

# Rank of each Action leaf for one cluster ([P, Z], [P, 2], [P], [P], [C]).
_ACTION_RANKS = (2, 2, 1, 1, 1)


def _batch1(action: Action) -> Action:
    """``action`` with the batch axis of one cluster in front of every
    leaf (a shared leaf gains it, a per-cluster leaf keeps it)."""
    return Action(*(x[None] if x.dim() == r else x
                    for x, r in zip(action, _ACTION_RANKS)))


def _one(tup):
    """The first cluster of a batch-first tuple of tensors."""
    return type(tup)(*(x[0] for x in tup))


def _lead(tup):
    """A tuple of one cluster's tensors as a batch of one."""
    return type(tup)(*(x[None] for x in tup))


@functools.lru_cache(maxsize=16)
def _compiled_steps(cfg: FrameworkConfig, device: str):
    """The estimate steps of one config and device, shared across
    Controller instances (a resumed controller reuses the dead one's),
    watched under the JAX package's names."""
    from ccka_tpu_torch.obs.compile import watch_jit

    params = SimParams.from_config(cfg, device=device)
    step = watch_jit(
        lambda s, a, e: sim_step(params, s, a, e, stochastic=False),
        "controller.step", hot=True, shared_stats=True)
    step_wl = watch_jit(
        lambda s, ws, a, e, w: sim_step(params, s, a, e, stochastic=False,
                                        workload=w, wl_state=ws),
        "controller.step_wl", hot=True, shared_stats=True)
    return step, step_wl


@dataclasses.dataclass
class TickReport:
    """One control tick's structured record (the KPI log line); the JAX
    package's fields, in its order."""

    t: int
    is_peak: bool
    profile: str               # backend-reported mode, e.g. "peak"/"offpeak"
    applied: bool              # all pool patches accepted
    verified: bool             # read-back matches the rendered intent
    fallbacks: int             # pools that needed the legacy schema path
    cost_usd_hr: float         # estimated fleet $/hr after this tick
    carbon_g_hr: float         # estimated gCO2/hr
    nodes_spot: float
    nodes_od: float
    pending_pods: float
    slo_ok: bool
    detail: str = ""
    latency_p95_ms: float = 0.0
    usd_per_kreq: float = 0.0
    g_co2_per_kreq: float = 0.0
    waste_frac: float = 0.0
    interruption_warnings: int = 0
    nodes_drained: int = 0
    slo_metrics: dict = dataclasses.field(default_factory=dict)
    # Per-stage wall timings (ms): scrape, decide, render, apply, verify,
    # estimate, slo_scrape (and interruptions when a feed is wired).
    timings_ms: dict = dataclasses.field(default_factory=dict)
    # Degraded-mode machine: 0 ok / 1 hold / 2 fallback.
    signal_stale: bool = False
    degraded: str = "ok"
    degraded_level: int = 0
    degraded_ticks_total: int = 0
    denied_nodes: float = 0.0
    delayed_nodes: float = 0.0
    inference_queue_depth: float = 0.0
    batch_backlog: float = 0.0
    inference_slo_violations_total: float = 0.0
    batch_deadline_misses_total: float = 0.0
    reconcile_retries: int = 0
    reconcile_retries_total: int = 0
    reconcile_diverged: int = 0
    actuation_failures: int = 0
    actuation_failures_total: int = 0
    snapshot_age_ticks: int = 0
    resumes_total: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


# Ticks an acked but unmatched terminate warning is retried before being
# dropped (at the 30 s cadence, 4 ticks = the 2-minute notice window).
_PENDING_WARNING_TTL = 4


class ControllerLockHeld(RuntimeError):
    """Another controller daemon holds this cluster's single-writer lock."""


class ControllerLock:
    """Advisory single-writer lock per cluster: an exclusive ``flock`` on a
    per-cluster lockfile, so a second daemon on one cluster fails fast
    (:class:`ControllerLockHeld`, with the holder's pid) instead of
    interleaving patches. The lockfile is never unlinked (unlinking on
    release would let two openers each lock their own inode)."""

    def __init__(self, cluster_name: str, *, lock_dir: str | None = None):
        d = lock_dir or os.path.join(tempfile.gettempdir(),
                                     f"ccka-locks-{os.getuid()}")
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"controller-{cluster_name}.lock")
        self._fh = None

    def acquire(self) -> None:
        import fcntl

        fh = open(self.path, "a+")
        try:
            fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            fh.seek(0)
            holder = fh.read().strip() or "unknown pid"
            fh.close()
            raise ControllerLockHeld(
                f"another controller holds {self.path} ({holder}); two "
                "control loops on one cluster would ping-pong NodePool "
                "patches — stop the other instance first")
        fh.truncate(0)
        fh.write(f"pid={os.getpid()}\n")
        fh.flush()
        self._fh = fh

    def release(self) -> None:
        if self._fh is not None:
            import fcntl

            fcntl.flock(self._fh, fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None


def _workload_clock_anchor(source: SignalSource, dt_s: float) -> float:
    """Unix-seconds anchor of the workload-family arrival track: the
    source's own clock when it has one (synthetic and live carry
    ``start_unix_s``; replay its recorded clock plus its offset), the
    wall clock otherwise. A timestamp, not a timing."""
    start = getattr(source, "start_unix_s", None)
    if start is None:
        try:
            m = source.meta()
            start = (m.start_unix_s
                     + getattr(source, "offset_steps", 0) * (m.dt_s or dt_s))
        except Exception:  # noqa: BLE001 — a source without a clock
            start = time.time()
    return float(start)


class Controller:
    """Scrape -> decide -> act loop over a pluggable backend, source and
    sink, on ``device`` (the card unless ``device="cpu"``).

    ``backend`` must live on the same device. ``interval_s`` defaults to
    the signals' scrape cadence; tests inject ``sleep_fn``/``log_fn`` and
    run with interval 0. ``workload_steps`` (a `WorkloadStep` of [T]
    leaves, the horizon of the arrival track) replaces the track the
    controller would sample, so a test can hand it another
    implementation's draws.
    """

    def __init__(self,
                 cfg: FrameworkConfig,
                 backend: PolicyBackend,
                 source: SignalSource,
                 sink: "ActuationSink | dict[str, ActuationSink]",
                 *,
                 device=None,
                 interval_s: float | None = None,
                 seed: int = 0,
                 apply_hpa: bool = False,
                 apply_keda: bool = False,
                 lock: bool = False,
                 lock_dir: str | None = None,
                 degraded_fallback_after: int = 3,
                 reconcile_rounds: int = 3,
                 reconcile_backoff_s: float = 0.05,
                 reconcile_deadline_s: float = 5.0,
                 snapshot_path: str = "",
                 snapshot_every: int = 1,
                 telemetry_path: str = "",
                 exporter=None,
                 tracer=None,
                 interruption_feed=None,
                 incident_log=None,
                 decision_ledger=None,
                 workload_steps=None,
                 log_fn: Callable[[str], None] | None = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.interruption_feed = interruption_feed
        # Insertion-ordered: the oldest is evicted first.
        self._drained_instances: dict[str, None] = {}
        # Terminate warnings no node listing resolved yet (acked at poll
        # time, so this is their only memory): {instance: (warning, ttl)}.
        self._pending_warnings: dict[str, tuple] = {}
        self.exporter = exporter
        self.tracer = tracer
        self.backend = backend
        self.source = source
        # One sink per regional cluster; a bare sink serves every region.
        if isinstance(sink, dict):
            missing = [r.name for r in cfg.cluster.regions
                       if r.name not in sink] if cfg.cluster.regions else (
                [cfg.cluster.region] if cfg.cluster.region not in sink
                else [])
            if missing:
                raise ValueError(f"no sink for region(s) {missing}")
            self.region_sinks = dict(sink)
        else:
            names = ([r.name for r in cfg.cluster.regions]
                     or [cfg.cluster.region])
            self.region_sinks = {name: sink for name in names}
        # Home-region sink: workload-scoped objects (HPA, KEDA) live here.
        self.sink = self.region_sinks.get(
            cfg.cluster.region, next(iter(self.region_sinks.values())))
        # One reconciler per distinct sink object: regions sharing a sink
        # share its retry state.
        by_sink: dict[int, Reconciler] = {}
        self._reconcilers: dict[str, Reconciler] = {}
        for region, snk in self.region_sinks.items():
            rec = by_sink.get(id(snk))
            if rec is None:
                rec = by_sink[id(snk)] = Reconciler(
                    snk, max_rounds=reconcile_rounds,
                    backoff_s=reconcile_backoff_s,
                    deadline_s=reconcile_deadline_s,
                    seed=seed ^ 0x5EC0)
            self._reconcilers[region] = rec
        # Incident log (`obs/incidents.py`; None disables): the degraded
        # machine's hold -> rule-fallback escalation and every reconciler
        # give-up stamp ONE structured incident each. The give-up trigger
        # rides the reconciler's own hook (`actuation/reconcile.on_giveup`).
        self.incident_log = incident_log
        # Decision-provenance ledger (`obs/decisions.py`; None disables):
        # one row per tick — the observed exo, the state estimate, the
        # chosen action's objective terms and the RULE SHADOW stepped on
        # the same inputs, strictly after the real estimate, so recording
        # cannot steer a decision.
        self.decision_ledger = decision_ledger
        self._obs_tick = 0
        # Regions may SHARE a reconciler (one per distinct sink), so the
        # give-up's region is stamped from the converge call site.
        self._obs_region = ""
        if incident_log is not None:
            for rec in by_sink.values():
                rec.on_giveup = self._stamp_giveup
        self.interval_s = (cfg.signals.scrape_interval_s
                           if interval_s is None else interval_s)
        self.apply_hpa = apply_hpa
        self.apply_keda = apply_keda
        if apply_keda and not (cfg.workload.sqs_queue_name
                               and cfg.workload.aws_account_id):
            raise ValueError(
                "apply_keda requires workload.sqs_queue_name and "
                "workload.aws_account_id (the reference's CREATE_SQS/"
                "SQS_QUEUE_NAME stub, `.env:10-12`)")
        self.seed = seed
        # Degraded-mode machine: a stale scrape (or a reconciler give-up)
        # first HOLDS the last action, and after
        # ``degraded_fallback_after`` consecutive such ticks FALLS BACK to
        # the rule policy, whose only signal input (the clock's is_peak)
        # survives every outage. A fresh tick returns to the backend.
        self.degraded_fallback_after = max(1, int(degraded_fallback_after))
        from ccka_tpu_torch.policy.rule import RulePolicy
        self._fallback_policy = RulePolicy(cfg.cluster, device=self.device)
        self._degraded = "ok"
        self._stale_streak = 0
        self._diverge_streak = 0
        self._last_action: Action | None = None
        self.degraded_ticks_total = 0
        self.reconcile_retries_total = 0
        self.actuation_failures_total = 0
        self.resumes_total = 0
        self.snapshot_path = snapshot_path
        self.snapshot_every = max(1, int(snapshot_every))
        self._last_snapshot_tick: int | None = None
        self._last_verified_desired: dict = {}
        self._force_replan = False
        self.log_fn = log_fn if log_fn is not None else (
            lambda line: print(line, flush=True))
        self.sleep_fn = sleep_fn
        self.params = SimParams.from_config(cfg, device=self.device)
        # The report's constants, read off the params once (float32
        # values, as the JAX package's float() of its arrays gives them).
        self._dt_s, self._rps, self._base_od, self._ppn = (
            float(np.float32(x)) for x in (
                cfg.sim.dt_s, cfg.sim.rps_per_pod, cfg.cluster.base_nodes,
                self.params.pods_per_node.item()))
        self.state: ClusterState = initial_state(cfg, 1, device=self.device)
        # Acquired before anything with a side effect, so a lock-held
        # refusal leaves no telemetry file behind.
        self._lock = None
        if lock:
            self._lock = ControllerLock(cfg.cluster.name, lock_dir=lock_dir)
            self._lock.acquire()
        self.telemetry = None
        if telemetry_path:
            from ccka_tpu_torch.harness.telemetry import TelemetryWriter
            self.telemetry = TelemetryWriter(telemetry_path)
        self._step, self._step_wl = _compiled_steps(cfg, str(self.device))
        # Workload-family track: with families enabled the estimate also
        # carries per-family queues fed by a seeded arrival sample of a
        # whole number of days, tiled by ``t % horizon``.
        self._wl_steps = None
        self._wl_seam = workload_steps is not None
        wl_cfg = cfg.workloads
        self.inference_slo_violations_total = 0.0
        self.batch_deadline_misses_total = 0.0
        if wl_cfg is not None and wl_cfg.enabled:
            from ccka_tpu_torch.workloads.types import WorkloadState
            day = max(1, int(round(86400.0 / cfg.sim.dt_s)))
            self._wl_horizon = -(-max(int(cfg.sim.horizon_steps), day)
                                 // day) * day
            # Snapshot state: a resumed run re-samples the same track.
            self._wl_anchor = _workload_clock_anchor(source, cfg.sim.dt_s)
            self._wl_cfg = wl_cfg
            if workload_steps is not None:
                self._wl_steps = type(workload_steps)(*(
                    torch.as_tensor(np.array(x, np.float32),
                                    device=self.device)
                    for x in workload_steps))
                self._wl_horizon = int(self._wl_steps[0].shape[0])
            else:
                self._wl_steps = self._sample_workload_steps()
            self._wl_state = WorkloadState.zero(
                int(self.params.wl_batch_deadline_ticks), 1,
                device=self.device)
        # Receding-horizon backends replan against a window: a forecaster's
        # prediction from observed history when the backend carries one,
        # the source's own forecast otherwise.
        self._replan_every = getattr(backend, "replan_every", 0)
        self._horizon = getattr(backend, "horizon", 0)
        self._forecaster = getattr(backend, "forecaster", None)
        self._hist_steps = 0
        if self._forecaster is not None:
            self._hist_steps = (getattr(backend, "history_steps", 0)
                                or self._forecaster.wanted_history(
                                    self._horizon))

    def _sample_workload_steps(self):
        from ccka_tpu_torch.signals.synthetic import family_generator
        from ccka_tpu_torch.sim.lanes import WORKLOAD_KEY_TAG
        from ccka_tpu_torch.workloads.process import sample_workload_steps

        gen = family_generator(self.seed, WORKLOAD_KEY_TAG, self.device)
        return sample_workload_steps(
            self._wl_cfg, gen, self._wl_horizon, self.cfg.cluster.n_zones,
            dt_s=self.cfg.sim.dt_s, start_unix_s=self._wl_anchor)

    # -- spot interruption response -----------------------------------------

    def _drain_for_warnings(self, warnings) -> int:
        """Cordon and drain the spot nodes named by terminate warnings and
        take the lost capacity off the state estimate at once. Instance
        ids map to nodes through ``spec.providerID`` over each region
        sink's spot-node listing; a rebalance recommendation is advisory
        and only counted."""
        from ccka_tpu_torch.config import ConfigError

        drained = 0
        by_instance: dict[str, tuple[dict, ActuationSink]] = {}
        for sink in dict.fromkeys(self.region_sinks.values()):
            try:
                nodes = sink.list_objects(
                    "node", selector="karpenter.sh/capacity-type=spot")
            except NotImplementedError:
                continue
            for node in nodes:
                provider = str(node.get("spec", {}).get("providerID", ""))
                if provider:
                    by_instance[provider.rsplit("/", 1)[-1]] = (node, sink)
        zones = list(self.cfg.cluster.zones)
        prev_pending = self._pending_warnings
        next_pending: dict[str, tuple] = {}
        for w in warnings:
            if w.action != "terminate":
                self.log_fn(f"# rebalance recommendation: {w!r} (no action)")
                continue
            # At-least-once delivery: an instance already drained must not
            # drain (or decrement the estimate) twice.
            if w.instance_id in self._drained_instances:
                self.log_fn(f"# duplicate interruption warning for "
                            f"{w.instance_id} (already drained)")
                continue

            def carry(reason: str) -> None:
                _w, ttl = prev_pending.get(w.instance_id,
                                           (w, _PENDING_WARNING_TTL + 1))
                if ttl - 1 > 0:
                    next_pending[w.instance_id] = (w, ttl - 1)
                    self.log_fn(f"# {reason} — retrying {ttl - 1} more "
                                f"tick(s)")
                else:
                    self.log_fn(f"# {reason} — dropped (TTL exhausted)")

            hit = by_instance.get(w.instance_id)
            if hit is None:
                carry(f"interruption warning for unresolved instance "
                      f"{w.instance_id}")
                continue
            node, sink = hit
            name = node.get("metadata", {}).get("name", "")
            if not name or not sink.drain_node(name):
                carry(f"drain of {name or w.instance_id} failed")
                continue
            self._remember_drained(w.instance_id)
            drained += 1
            labels = node.get("metadata", {}).get("labels", {})
            zone = labels.get("topology.kubernetes.io/zone", "")
            pool = labels.get("karpenter.sh/nodepool", "")
            try:
                zi = zones.index(zone)
                pi = self.cfg.cluster.pool_index(pool)
            except (ValueError, ConfigError):
                # A fresh node may not carry its labels yet: the drain
                # happened, the estimate is left alone.
                self.log_fn(f"# drained {name} but cannot attribute "
                            f"zone={zone!r} pool={pool!r} — estimate "
                            f"unchanged")
                continue
            nodes = self.state.nodes.clone()
            nodes[0, pi, zi, CT_SPOT] -= 1.0
            self.state = self.state._replace(nodes=clip(nodes, 0.0))
        self._pending_warnings = next_pending
        return drained

    def _remember_drained(self, instance_id: str) -> None:
        """Bounded already-drained memory (dedupe across redeliveries)."""
        self._drained_instances[instance_id] = None
        while len(self._drained_instances) > 256:
            self._drained_instances.pop(
                next(iter(self._drained_instances)))

    # -- incident stamps (no-ops without an incident_log) -------------------

    def _stamp_giveup(self, outcome) -> None:
        """`actuation/reconcile.on_giveup` hook: one incident per give-up,
        keyed on the tick and region the apply loop is in."""
        self.incident_log.stamp(
            "reconcile_giveup", t=self._obs_tick,
            region=self._obs_region,
            diverged=list(outcome.diverged),
            retries=int(outcome.retries))

    # -- one tick ----------------------------------------------------------

    def _window(self, t: int) -> ExogenousTrace:
        """The replan's [1, H, ...] window at tick ``t``."""
        if self._forecaster is not None:
            from ccka_tpu_torch.forecast.base import planning_window
            hist = self.source.history(t, self._hist_steps, seed=self.seed,
                                       device=self.device)
            return planning_window(self._forecaster, _lead(hist),
                                   self._horizon)
        return _lead(self.source.forecast(t, self._horizon, seed=self.seed,
                                          device=self.device))

    def tick(self, t: int) -> TickReport:
        from ccka_tpu_torch.harness.telemetry import StageTimer

        self._obs_tick = t
        timer = StageTimer(self.tracer)
        # 1. scrape: a one-step trace is a batch of one tick.
        with timer.stage("scrape"):
            exo = ExoStep(*self.source.tick(t, seed=self.seed,
                                            device=self.device))
            is_peak = bool(float(exo.is_peak[0]) > 0.5)

        # 1a. degraded-mode machine, classified BEFORE the decide on the
        #     source's staleness flag and the previous tick's divergence.
        stale = bool(getattr(self.source, "last_scrape_stale", False))
        self._stale_streak = self._stale_streak + 1 if stale else 0
        streak = max(self._stale_streak, self._diverge_streak)
        prev_mode = self._degraded
        if streak == 0:
            self._degraded = "ok"
        elif (streak >= self.degraded_fallback_after
              or self._last_action is None):
            self._degraded = "fallback"
        else:
            self._degraded = "hold"
        if self._degraded != "ok":
            self.degraded_ticks_total += 1
        if prev_mode != self._degraded:
            self.log_fn(f"# degraded-mode: {prev_mode} -> "
                        f"{self._degraded} (stale streak "
                        f"{self._stale_streak}, diverge streak "
                        f"{self._diverge_streak})")
            if self._degraded == "fallback" and \
                    self.incident_log is not None:
                # The loop stopped trusting fresh intent entirely: an
                # incident, not just a log line.
                self.incident_log.stamp(
                    "hold_fallback", t=t, prev_mode=prev_mode,
                    stale_streak=int(self._stale_streak),
                    diverge_streak=int(self._diverge_streak))

        # 1b. spot interruption warnings -> cordon and drain BEFORE the
        #     decide, so the displaced pods go Pending under this tick's
        #     profile.
        n_warnings = n_drained = 0
        if self.interruption_feed is not None:
            with timer.stage("interruptions"):
                warnings = self.interruption_feed.poll()
                n_warnings = len(warnings)
                fresh_ids = {w.instance_id for w in warnings}
                carried = [w for iid, (w, _t)
                           in self._pending_warnings.items()
                           if iid not in fresh_ids]
                batch = list(warnings) + carried
                if batch:
                    n_drained = self._drain_for_warnings(batch)

        # 2. decide; receding-horizon backends replan on their cadence
        #    (skipped while degraded), and once right after a resume from
        #    a snapshot that carried no plan.
        with timer.stage("decide") as sp_decide:
            sp_decide.args["degraded"] = self._degraded
            if self._degraded == "hold":
                action = self._last_action
            elif self._degraded == "fallback":
                action = _batch1(self._fallback_policy.decide(
                    self.state, exo, t))
            else:
                if self._replan_every and (
                        t % self._replan_every == 0 or self._force_replan):
                    self._force_replan = False
                    self.backend.replan(self.state, self._window(t))
                action = _batch1(self.backend.decide(self.state, exo, t))
                self._last_action = action
            sp_decide.fence(action)

        # 3. render: peak uses op:add (demo_21:65), off-peak op:replace
        #    (demo_20:69); one patch set per region.
        with timer.stage("render"):
            host_action = Action(*(x[0].detach().cpu() for x in action))
            per_region = render_region_nodepool_patches(
                host_action, self.cfg.cluster,
                op="add" if is_peak else "replace")

        # 4. apply through each region's reconciler (deadline-bounded
        #    retries with read-back verification), then HPA/KEDA objects.
        with timer.stage("apply") as sp_apply:
            results = []
            tick_retries = tick_failures = diverged_pools = 0
            pools_converged = True
            for region, patches in per_region.items():
                self._obs_region = region
                outcome = self._reconcilers[region].converge(patches)
                results += outcome.results
                tick_retries += outcome.retries
                tick_failures += outcome.failures
                diverged_pools += len(outcome.diverged)
                pools_converged &= outcome.converged
            n_pool_results = len(results)
            if self.apply_hpa:
                from ccka_tpu_torch.actuation.patches import (
                    render_hpa_manifests)
                results += self.sink.apply_manifests(
                    render_hpa_manifests(host_action, self.cfg.cluster,
                                         self.cfg.workload,
                                         namespace=self.cfg.workload.namespace))
            if self.apply_keda:
                from ccka_tpu_torch.actuation.patches import (
                    render_keda_scaledobject)
                wl = self.cfg.workload
                results.append(self.sink.apply_manifest(
                    render_keda_scaledobject(
                        host_action, wl.sqs_queue_name, wl.aws_account_id,
                        namespace=wl.namespace,
                        region=self.cfg.cluster.region)))
            applied = all(r.ok for r in results)
            fallbacks = sum(1 for r in results if r.used_fallback)
            self.reconcile_retries_total += tick_retries
            # Manifest failures only: the reconciler's own failed applies
            # are already in outcome.failures.
            tick_failures += sum(
                1 for r in results[n_pool_results:] if not r.ok)
            self.actuation_failures_total += tick_failures
            sp_apply.args["retries"] = tick_retries
            sp_apply.args["diverged"] = diverged_pools

        # 5. verify: every pool converged (the reconciler read each back)
        #    and every manifest applied; a give-up feeds the next tick's
        #    degraded-mode streak.
        with timer.stage("verify"):
            verified = applied and pools_converged
            self._diverge_streak = (0 if pools_converged
                                    else self._diverge_streak + 1)
            if verified:
                self._last_verified_desired = {
                    region: {ps.pool: {
                        "consolidationPolicy": ps.disruption_merge["spec"]
                        ["disruption"]["consolidationPolicy"],
                        "requirements": {
                            r["key"]: r["values"]
                            for r in ps.requirements_json[0]["value"]},
                    } for ps in patches}
                    for region, patches in per_region.items()}

        # 6. advance the state estimate (expectation dynamics; with
        #    families enabled the queues advance in the same step).
        with timer.stage("estimate") as sp_est:
            state_pre = self.state
            wl_state_pre = (self._wl_state if self._wl_steps is not None
                            else None)
            w = None
            if self._wl_steps is not None:
                k = t % self._wl_horizon
                w = type(self._wl_steps)(*(x[k:k + 1]
                                           for x in self._wl_steps))
                self.state, metrics, self._wl_state = self._step_wl(
                    self.state, self._wl_state, action, exo, w)
            else:
                self.state, metrics = self._step(self.state, action, exo)
            # The report reads these on the host below; the fence puts the
            # device time in this stage.
            sp_est.fence((self.state, metrics))
        m = _host_metrics(metrics)
        if self._wl_steps is not None:
            self.inference_slo_violations_total += float(
                m.inf_slo_violation[0])
            self.batch_deadline_misses_total += float(
                m.batch_deadline_miss[0])

        # 6a. decision provenance (no-op without a ledger): the rule shadow
        #     stepped on the SAME pre-step state and observed exo, strictly
        #     after this tick's real decide/apply/estimate.
        if self.decision_ledger is not None:
            self._observe_decision(t, action, exo, m, state_pre,
                                   wl_state_pre, w, stale)

        # 7. measured app-level SLO metrics, when the source scrapes them.
        with timer.stage("slo_scrape"):
            slo_metrics = self.source.slo_snapshot()

        dt_hr = self._dt_s / 3600.0
        profile = ""
        if self._degraded == "fallback":
            profile = ("degraded-fallback:"
                       + self._fallback_policy.profile_name(is_peak))
        elif self._degraded == "hold":
            profile = "degraded-hold"
        elif hasattr(self.backend, "profile_name"):
            profile = self.backend.profile_name(is_peak)
        # Tick-rate KPIs (EpisodeSummary's formulas over one tick).
        effective = float(np.minimum(m.served_pods, m.demand_pods).sum())
        kreq = effective * self._rps * self._dt_s / 1000.0
        served_total = float(m.served_pods.sum())
        capacity = ((float(m.nodes_by_ct.sum()) + self._base_od)
                    * self._ppn)
        report = TickReport(
            t=t,
            is_peak=is_peak,
            profile=profile or self.backend.name,
            applied=applied,
            verified=verified,
            fallbacks=fallbacks,
            cost_usd_hr=float(m.cost_usd[0]) / dt_hr,
            carbon_g_hr=float(m.carbon_g[0]) / dt_hr,
            nodes_spot=float(m.nodes_by_ct[0, 0]),
            nodes_od=float(m.nodes_by_ct[0, 1]),
            pending_pods=float(m.pending_pods.sum()),
            slo_ok=bool(float(m.slo_ok[0]) > 0.5),
            detail="; ".join(r.detail for r in results if r.detail)[:500],
            latency_p95_ms=float(m.latency_p95_ms[0]),
            usd_per_kreq=float(m.cost_usd[0]) / max(kreq, 1e-9),
            g_co2_per_kreq=float(m.carbon_g[0]) / max(kreq, 1e-9),
            waste_frac=max(capacity - served_total, 0.0) / max(capacity,
                                                               1e-9),
            interruption_warnings=n_warnings,
            nodes_drained=n_drained,
            slo_metrics=slo_metrics,
            timings_ms=timer.timings_ms(),
            signal_stale=stale,
            degraded=self._degraded,
            degraded_level={"ok": 0, "hold": 1,
                            "fallback": 2}[self._degraded],
            degraded_ticks_total=self.degraded_ticks_total,
            denied_nodes=float(m.denied_nodes[0]),
            delayed_nodes=float(m.delayed_nodes[0]),
            inference_queue_depth=float(m.inf_queue_depth[0]),
            batch_backlog=float(m.batch_backlog[0]),
            inference_slo_violations_total=(
                self.inference_slo_violations_total),
            batch_deadline_misses_total=self.batch_deadline_misses_total,
            reconcile_retries=tick_retries,
            reconcile_retries_total=self.reconcile_retries_total,
            reconcile_diverged=diverged_pools,
            actuation_failures=tick_failures,
            actuation_failures_total=self.actuation_failures_total,
            resumes_total=self.resumes_total,
        )
        # 8. durable snapshot at the END of the tick (next_tick = t+1),
        #    written atomically: a kill anywhere resumes at the last
        #    completed tick boundary.
        if self.snapshot_path:
            if t % self.snapshot_every == 0:
                self.write_snapshot(t + 1)
                self._last_snapshot_tick = t
            report.snapshot_age_ticks = (
                t - self._last_snapshot_tick
                if self._last_snapshot_tick is not None else t + 1)
        self.log_fn(report.to_json())
        if self.telemetry is not None:
            self.telemetry.write(dataclasses.asdict(report))
        if self.exporter is not None:
            self.exporter.update(report)
        return report

    # -- decision provenance (obs/decisions.py) -----------------------------

    def _observe_decision(self, t: int, action, exo, m, state_pre,
                          wl_state_pre, w, stale: bool) -> None:
        """One ledger row: the chosen step's metrics (``m``, on the host)
        against the rule shadow's on identical inputs (same pre-step
        state, same observed exo, same step). The degraded machine maps
        onto the decision lanes: ok -> fresh, hold -> hold, fallback ->
        fallback (a fallback tick's divergence is 0 by construction)."""
        lane = {"ok": "fresh", "hold": "hold",
                "fallback": "fallback"}[self._degraded]
        shadow_action = _batch1(self._fallback_policy.decide(state_pre,
                                                             exo, t))
        if self._wl_steps is not None:
            _s, sh_metrics, _ws = self._step_wl(
                state_pre, wl_state_pre, shadow_action, exo, w)
        else:
            _s, sh_metrics = self._step(state_pre, shadow_action, exo)
        sh = _host_metrics(sh_metrics)

        def decomp(mm) -> dict:
            pend = np.maximum(mm.demand_pods[0] - mm.served_pods[0], 0.0)
            return {"cost_usd": float(mm.cost_usd[0]),
                    "carbon_g": float(mm.carbon_g[0]),
                    "pend_c0": float(pend[0]),
                    "pend_c1": float(pend[1]),
                    "slo_ok": float(mm.slo_ok[0])}

        def flat(a) -> np.ndarray:
            return np.concatenate([
                leaf[0].detach().cpu().numpy().astype(np.float64).reshape(-1)
                for leaf in a])

        host_exo = ExoStep(*(x[0].detach().cpu().numpy() for x in exo))
        surfaces = self.decision_ledger.observe_single(
            t, lane=lane, action=flat(action),
            shadow_action=flat(shadow_action),
            exo={
                "spot_price_hr": float(host_exo.spot_price_hr.mean()),
                "od_price_hr": float(host_exo.od_price_hr.mean()),
                "carbon_g_kwh": float(host_exo.carbon_g_kwh.mean()),
                "demand_pods": float(host_exo.demand_pods.sum()),
                "is_peak": bool(float(host_exo.is_peak) > 0.5),
                "stale": bool(stale),
            },
            state={"nodes_spot": float(m.nodes_by_ct[0, 0]),
                   "nodes_od": float(m.nodes_by_ct[0, 1])},
            chosen=decomp(m), shadow=decomp(sh))
        # A windowed divergence spike is an incident here exactly as on
        # the fleet path: one edge-triggered stamp, re-armed below the bar.
        spike = surfaces.get("spike")
        if spike is not None and self.incident_log is not None:
            self.incident_log.stamp("policy_divergence", t=t, **spike)

    # -- durable snapshot / resume ------------------------------------------

    def _backend_plan(self):
        """The backend's plan as one cluster's [H, A], or None."""
        plan = getattr(self.backend, "_plan", None)
        if plan is None:
            return None
        return plan[0] if plan.dim() == 3 else plan

    def snapshot_body(self, next_tick: int) -> dict:
        """Everything a fresh process needs to continue this run bitwise:
        the tick index, the state estimate, the degraded-mode machine,
        the session counters, the backend's plan and the last applied
        and verified desired state. Unlike the JAX package's body there is
        no ``prng_key``: the estimate step draws nothing in deterministic
        mode (`sim/dynamics.py::step` reads uniforms only when
        stochastic), so the port carries no key. Tensors are encoded as
        one cluster's leaves, the JAX body's shapes."""
        from ccka_tpu_torch.harness import snapshot as snap

        body: dict = {
            "kind": "controller",
            "next_tick": int(next_tick),
            "seed": int(self.seed),
            "backend": getattr(self.backend, "name",
                               type(self.backend).__name__),
            "config_sha256": snap.config_digest(self.cfg),
            "state": snap.encode_tree(_one(self.state)),
            "degraded": self._degraded,
            "stale_streak": int(self._stale_streak),
            "diverge_streak": int(self._diverge_streak),
            "degraded_ticks_total": int(self.degraded_ticks_total),
            "reconcile_retries_total": int(self.reconcile_retries_total),
            "actuation_failures_total": int(self.actuation_failures_total),
            "resumes_total": int(self.resumes_total),
            "drained_instances": list(self._drained_instances),
            # The carried-over unresolved warnings' only memory.
            "pending_warnings": [
                {"instance_id": w.instance_id, "action": w.action,
                 "detail_type": w.detail_type, "region": w.region,
                 "ttl": int(ttl)}
                for w, ttl in self._pending_warnings.values()],
            "desired": self._last_verified_desired,
            "last_action": (snap.encode_tree(_one(self._last_action))
                            if self._last_action is not None else None),
            "wl": None,
        }
        plan = self._backend_plan()
        if plan is not None:
            body["backend_plan"] = snap.encode_tree(plan)
            body["backend_plan_age"] = int(
                getattr(self.backend, "_plan_age", 0))
        if self._wl_steps is not None:
            body["wl"] = {
                "state": snap.encode_tree(_one(self._wl_state)),
                "anchor_unix_s": float(self._wl_anchor),
                "inference_slo_violations_total": float(
                    self.inference_slo_violations_total),
                "batch_deadline_misses_total": float(
                    self.batch_deadline_misses_total),
            }
        return body

    def write_snapshot(self, next_tick: int) -> str:
        from ccka_tpu_torch.harness.snapshot import save_snapshot
        return save_snapshot(self.snapshot_path, self.snapshot_body(
            next_tick))

    def restore(self, body: dict) -> int:
        """Restore from a snapshot body (`snapshot.load_snapshot`); returns
        the tick to resume at. Refuses a config, backend or seed that is
        not this controller's: resuming another run's snapshot would
        silently corrupt the estimate."""
        from ccka_tpu_torch.harness import snapshot as snap

        if body.get("kind") != "controller":
            raise snap.SnapshotError(
                f"snapshot kind {body.get('kind')!r} is not a controller "
                "snapshot")
        digest = snap.config_digest(self.cfg)
        if body.get("config_sha256") != digest:
            raise snap.SnapshotError(
                "snapshot was taken under a different config "
                f"(stored {body.get('config_sha256', '')[:12]}…, running "
                f"{digest[:12]}…) — resuming across configs would corrupt "
                "the state estimate; rerun with the original config")
        want_backend = getattr(self.backend, "name",
                               type(self.backend).__name__)
        if body.get("backend") != want_backend:
            raise snap.SnapshotError(
                f"snapshot was taken with backend {body.get('backend')!r}, "
                f"this controller runs {want_backend!r} — the decision "
                "stream would silently change policy mid-run")
        if int(body.get("seed", -1)) != int(self.seed):
            raise snap.SnapshotError(
                f"snapshot seed {body.get('seed')} != controller seed "
                f"{self.seed} — the run would fork")
        self.state = _lead(snap.decode_like(_one(self.state), body["state"]))
        la = body.get("last_action")
        template = Action.neutral(self.cfg.cluster.n_pools,
                                  self.cfg.cluster.n_zones,
                                  device=self.device)
        self._last_action = (_lead(snap.decode_like(template, la))
                             if la is not None else None)
        self._degraded = body.get("degraded", "ok")
        self._stale_streak = int(body.get("stale_streak", 0))
        self._diverge_streak = int(body.get("diverge_streak", 0))
        self.degraded_ticks_total = int(body.get("degraded_ticks_total", 0))
        self.reconcile_retries_total = int(
            body.get("reconcile_retries_total", 0))
        self.actuation_failures_total = int(
            body.get("actuation_failures_total", 0))
        self.resumes_total = int(body.get("resumes_total", 0)) + 1
        self._drained_instances = dict.fromkeys(
            body.get("drained_instances", []))
        if body.get("pending_warnings"):
            from ccka_tpu_torch.signals.live import InterruptionWarning
            self._pending_warnings = {
                rec["instance_id"]: (
                    InterruptionWarning(rec["instance_id"], rec["action"],
                                        rec["detail_type"],
                                        rec.get("region", "")),
                    int(rec["ttl"]))
                for rec in body["pending_warnings"]}
        self._last_verified_desired = body.get("desired", {})
        wl = body.get("wl")
        if wl is not None and self._wl_steps is not None:
            self._wl_state = _lead(snap.decode_like(_one(self._wl_state),
                                                    wl["state"]))
            self.inference_slo_violations_total = float(
                wl["inference_slo_violations_total"])
            self.batch_deadline_misses_total = float(
                wl["batch_deadline_misses_total"])
            if wl["anchor_unix_s"] != self._wl_anchor:
                # Re-sample on the ORIGINAL clock anchor: a live resume
                # must not re-phase the arrivals to its own start time.
                self._wl_anchor = float(wl["anchor_unix_s"])
                if not self._wl_seam:
                    self._wl_steps = self._sample_workload_steps()
        next_tick = int(body["next_tick"])
        self._last_snapshot_tick = next_tick - 1
        # The backend's plan comes back with the snapshot (the resume
        # stays bitwise); a snapshot without one replans at once, so the
        # first resumed decide never runs a plan that died with the old
        # process.
        bp = body.get("backend_plan")
        plan = self._backend_plan()
        if bp is not None and plan is not None:
            self.backend._plan = snap.decode_like(plan, bp).reshape(
                self.backend._plan.shape)
            if hasattr(self.backend, "_plan_age"):
                self.backend._plan_age = int(
                    body.get("backend_plan_age", 0))
            self._force_replan = False
        else:
            self._force_replan = bool(self._replan_every)
        self.log_fn(f"# resumed from snapshot at tick {next_tick} "
                    f"(resume #{self.resumes_total})")
        return next_tick

    # -- the loop ----------------------------------------------------------

    def run(self, ticks: int | None = None,
            start_tick: int = 0) -> list[TickReport]:
        """Drive the loop for ``ticks`` iterations (None = forever),
        sleeping ``interval_s`` between ticks; returns the reports of a
        bounded run (an unbounded one only logs)."""
        reports: list[TickReport] = []
        t = start_tick
        while ticks is None or t < start_tick + ticks:
            report = self.tick(t)
            if ticks is not None:
                reports.append(report)
            t += 1
            more = ticks is None or t < start_tick + ticks
            if more and self.interval_s > 0:
                self.sleep_fn(self.interval_s)
        return reports

    def close(self) -> None:
        """Release the telemetry writer and the lock (the controller's
        owner calls this; every telemetry write is flushed already)."""
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        if self._lock is not None:
            self._lock.release()
            self._lock = None


def _host_metrics(metrics: StepMetrics) -> StepMetrics:
    """A batch's step metrics on the host as float32 arrays, in one copy
    off the device."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in metrics])
    host = flat.cpu().numpy()
    out, i = [], 0
    for x in metrics:
        n = x.numel()
        out.append(host[i:i + n].reshape(tuple(x.shape)))
        i += n
    return StepMetrics(*out)


def controller_from_config(cfg: FrameworkConfig, backend: PolicyBackend,
                           *, device=None, live: bool = False,
                           runner=None, region_runners=None,
                           interruption_runner=None,
                           **kwargs) -> Controller:
    """Wire a controller with the configured signal source and a sink:
    DryRunSink by default, KubectlSink with ``live=True`` (runner
    injectable for tests). A live multi-region controller needs a kubectl
    path per region (``region_runners`` or every region's
    ``kube_context``): one shared context would apply both regions'
    patches to one cluster each tick, so that wiring is refused."""
    from ccka_tpu_torch.actuation.sink import (DryRunSink, KubectlSink,
                                               context_runner)
    from ccka_tpu_torch.signals.live import make_signal_source

    device = resolve_device(device)
    source = make_signal_source(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals, faults=cfg.faults,
                                workloads=cfg.workloads)

    if cfg.signals.interruption_queue_url and "interruption_feed" not in kwargs:
        from ccka_tpu_torch.signals.live import SpotInterruptionFeed
        kwargs["interruption_feed"] = SpotInterruptionFeed(
            cfg.signals.interruption_queue_url, region=cfg.cluster.region,
            runner=interruption_runner)

    chaos_on = cfg.chaos.enabled and (
        cfg.chaos.timeout_prob + cfg.chaos.transient_exit_prob
        + cfg.chaos.drop_prob + cfg.chaos.rewrite_prob) > 0.0
    if chaos_on and live:
        raise ValueError(
            "chaos injection (cfg.chaos) is a dry-run recovery-harness "
            "tool; injecting failures into a live kubectl path would "
            "fight a real cluster — drop --live or disable chaos")

    def wrap(s, idx=0):
        if not chaos_on:
            return s
        from ccka_tpu_torch.actuation.chaos import ChaosSink
        # Per-region seeds: one shared seed would fail every region alike.
        return ChaosSink(s, cfg.chaos,
                         seed=kwargs.get("seed", 0) ^ (0xC4A05 + idx))

    if cfg.cluster.regions:
        if live:
            runners = dict(region_runners or {})
            for r in cfg.cluster.regions:
                if r.name not in runners and r.kube_context:
                    runners[r.name] = context_runner(r.kube_context)
            missing = [r.name for r in cfg.cluster.regions
                       if r.name not in runners]
            if missing:
                raise ValueError(
                    "live multi-region controller requires one kubectl "
                    f"runner per region; missing for {missing}. Set "
                    "RegionSpec.kube_context on every region (e.g. "
                    'CCKA_CLUSTER_REGIONS=\'[{"name": ..., '
                    '"kube_context": ...}]\') or pass region_runners= — a '
                    "shared kube-context would ping-pong the same "
                    "NodePools between the regions' zone sets every tick.")
            sink = {r.name: KubectlSink(runners[r.name])
                    for r in cfg.cluster.regions}
        else:
            sink = {r.name: wrap(DryRunSink(), i)
                    for i, r in enumerate(cfg.cluster.regions)}
    else:
        if live:
            sink = KubectlSink(runner) if runner else KubectlSink()
        else:
            sink = wrap(DryRunSink())
    return Controller(cfg, backend, source, sink, device=device, **kwargs)
