"""Overload-safe multi-tenant fleet service.

The PyTorch form of `ccka_tpu/harness/service.py`: the fleet loop of
`harness/fleet.py` rebuilt with robustness as the design axis, so the
control plane stays responsive under the load it manages:

- **bounded batched ticks** — each tick has a hard deadline
  (`ServiceConfig.tick_deadline_ms`), split between a scrape/admission
  budget and a fan-out budget. Tenant scrapes that would run past the
  scrape budget are abandoned at the budget edge and DEFERRED to the
  next tick (a straggler is never awaited); all admitted decides still
  pack into ONE device dispatch per tick, with held/fallback lanes
  selected per tenant *inside* the same dispatch so a degraded fleet
  never pays a second device round trip.
- **per-tenant bulkheads + circuit breakers** — scrape timeouts/stale
  samples and reconcile give-ups feed a per-tenant
  closed→open→half-open :class:`CircuitBreaker` (seeded-jitter
  exponential probe schedule). While open, the tenant's scrape AND
  actuation are skipped outright and its decision lane degrades to
  hold-last-action, escalating to the rule fallback after
  ``hold_fallback_after`` open ticks. Healthy tenants proceed
  untouched: their decide rows are bitwise the calm run's.
- **backpressure + load shedding** — `ServiceConfig.admission_queue_cap`
  bounds admitted decides per tick; overflow is shed by EXPLICIT
  priority (stale-tolerant tenants first), every shed/deferral is
  counted on the report, and sustained saturation degrades
  stale-tolerant tenants' decide cadence (bounded divisor).

The device half is the lane-selecting service tick
(:func:`_compiled_service_tick`): on the card one CUDA graph of the
whole chain (`harness/fleet.py::_FleetTick`, the fleet tick's capture),
replayed every tick; on the CPU the same body eagerly. A fleet of
thousands of tenants rides :func:`_compiled_service_tick_chunk`: ONE
graph of k tenants, replayed for every chunk, reading its rows of the
resident ``[N, T, ...]`` stream through a device row offset (the stream
is never copied per replay).

The host half — the breaker banks, the counter-addressed draws and the
admission machine — is the JAX package's numpy code, as it is: the same
seeds give the same draws, transitions and lanes.

Time is read through an injectable :class:`VirtualClock` so the
dry-run overload harness (`harness/overload.py`) models slow/hung
scrapes by advancing the clock instead of sleeping. All host timing
here rides inside tracer spans (`tests/test_torch_timing_guard.py`
scans this hot loop, `time.monotonic` included).

The ``off`` preset (`config.SERVICE_PRESETS`) is a hard gate: every tick
delegates verbatim to the wrapped :class:`FleetController`,
byte-identical packed actions and per-sink command streams.

Every entry runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.actuation.patches import render_nodepool_patches
from ccka_tpu_torch.actuation.sink import ActuationSink
from ccka_tpu_torch.config import FrameworkConfig, ServiceConfig
from ccka_tpu_torch.harness.fleet import (FleetController, action_layout,
                                          unpack_action_row)
from ccka_tpu_torch.policy.base import PolicyBackend
from ccka_tpu_torch.signals.base import SignalSource
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.types import Action, ClusterState

# Decision lanes, selected per tenant INSIDE the one batched dispatch.
LANE_FRESH = 0      # admitted scrape → the backend's fresh decide
LANE_HOLD = 1       # shed/deferred/breaker-open → hold last fresh action
LANE_FALLBACK = 2   # breaker open past hold_fallback_after → rule profile


@dataclasses.dataclass(frozen=True)
class TenantProfile:
    """A tenant's behavioral archetype for the dry-run service harness.

    ``scrape_delay_ms`` is virtual host time one scrape consumes
    (advanced on the service's :class:`VirtualClock`); a delay larger
    than the remaining scrape budget models the hung scrape that times
    out at the budget edge. ``chaos`` names a `config.CHAOS_PRESETS`
    intensity wrapped onto the tenant's sink (its kubectl edge).
    ``priority`` orders admission AND shedding: lower numbers scrape
    first, higher numbers shed first; ``stale_tolerant`` additionally
    opts the tenant into cadence degradation under sustained saturation.
    """

    name: str
    scrape_delay_ms: float = 0.0
    scrape_fail_prob: float = 0.0
    chaos: str = ""
    priority: int = 1
    stale_tolerant: bool = False


# The named tenant archetypes `bench_overload` / `ccka overload-eval`
# compose into fleets; unknown names are rejected up front (the
# chaos-eval convention).
TENANT_PROFILES: dict[str, TenantProfile] = {
    # The well-behaved tenant: instant scrape, honest kubectl edge.
    "healthy": TenantProfile("healthy"),
    # Stale-tolerant batch tenant: first to shed, cadence-degradable.
    "batch": TenantProfile("batch", priority=2, stale_tolerant=True),
    # Slow-but-bounded scrape: consumes real budget, never times out on
    # a default-posture budget (deferral pressure without breaker trips).
    "jittery": TenantProfile("jittery", scrape_delay_ms=20.0),
    # The hung scrape from the issue: always exceeds any sane scrape
    # budget, so every attempt times out at the budget edge.
    "slow": TenantProfile("slow", scrape_delay_ms=400.0),
    # Byzantine edge: failing scrapes AND severe kubectl chaos.
    "flaky": TenantProfile("flaky", scrape_fail_prob=0.35,
                           chaos="severe"),
}


def resolve_profiles(names: Sequence) -> list[TenantProfile]:
    """Profile names (or explicit TenantProfile instances, e.g. the
    overload grid's chaos-composed derivatives) -> profiles, rejecting
    unknown names up front — a typo must fail fast, not produce an
    empty/meaningless board."""
    out: list[TenantProfile] = []
    bad: set[str] = set()
    for p in names:
        if isinstance(p, TenantProfile):
            out.append(p)
        elif p in TENANT_PROFILES:
            out.append(TENANT_PROFILES[p])
        else:
            bad.add(str(p))
    if bad:
        raise ValueError(f"unknown tenant profiles {sorted(bad)}; known: "
                         f"{sorted(TENANT_PROFILES)}")
    return out


class VirtualClock:
    """Monotonic clock plus injectable virtual delay.

    The overload harness models slow/hung tenant scrapes by calling
    :meth:`advance` instead of sleeping, so stress runs are
    deterministic and wall-clock-fast while every deadline comparison
    is arithmetically identical to real time. The base clock is
    injectable for fully-virtual tests."""

    def __init__(self, base: Callable[[], float] = time.monotonic):
        self._base = base
        self._offset = 0.0

    def __call__(self) -> float:
        return self._base() + self._offset

    def advance(self, seconds: float) -> None:
        self._offset += float(seconds)

    @property
    def offset(self) -> float:
        """Cumulative virtual seconds injected so far. The host-loop
        µs/tenant gauge reads real host time as (clock delta) minus
        (offset delta), so simulated scrape delays never inflate it."""
        return self._offset


_BREAKER_LEVEL = {"closed": 0, "half-open": 1, "open": 2}
_BREAKER_STATE = ("closed", "half-open", "open")

# ---- counter-based per-tenant RNG streams ---------------------------------
#
# The fleet's draw machinery at 10^4 tenants cannot afford N
# `random.Random` objects walked one tenant at a time: every draw is
# instead ADDRESSED as (stream seed, draw index) through a stateless
# splitmix64-style hash, so the object breaker, the vectorized breaker
# bank and the vectorized scrape phase all read the SAME streams —
# identical probe schedules and scrape-fail draws whichever host loop
# runs (pinned by the paired parity test in tests/test_torch_service.py).

_U64 = np.uint64
_GOLD = _U64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized, uint64 wraparound)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def counter_u01(seed, counter) -> np.ndarray:
    """Uniform draw(s) in [0, 1) addressed by (stream seed, draw
    index) — one seeded generator for the whole fleet, no per-tenant
    RNG objects. Accepts scalars or equal-length arrays; float64 out."""
    s = np.asarray(seed, _U64)
    c = np.asarray(counter, _U64)
    with np.errstate(over="ignore"):
        z = _mix64(_mix64(s + _GOLD)
                   ^ _mix64(c * _GOLD + _U64(0xD1B54A32D192ED03)))
    return (z >> _U64(11)).astype(np.float64) * (2.0 ** -53)


class CircuitBreaker:
    """Per-tenant closed→open→half-open breaker.

    ``breaker_failures`` consecutive failures (scrape timeout/stale or
    reconcile give-up) OPEN the breaker; while open, :meth:`allow`
    refuses work until the seeded-jittered probe tick arrives, at which
    point ONE half-open probe is allowed through — success re-closes,
    failure re-opens with the probe delay doubled (capped at
    ``breaker_max_probe_ticks``). Jitter draws come from the
    counter-based stream addressed by (seed, ``draws``) — no RNG
    object, and the draw index is exposed so paired runs (and the
    vectorized breaker bank) can prove they consumed the identical
    schedule (`RetryingFetch` idiom, counter form)."""

    def __init__(self, svc: ServiceConfig, seed: int = 0):
        self._svc = svc
        self._seed = _U64(seed & 0xFFFFFFFFFFFFFFFF)
        self.draws = 0  # jitter draws consumed (one per open)
        self.state = "closed"
        self._fails = 0          # consecutive failures while closed
        self._opens = 0          # consecutive opens (probe backoff expo)
        self._probe_at = 0
        self._opened_at: int | None = None
        self.transitions = {"opened": 0, "half_open": 0, "closed": 0}

    @property
    def level(self) -> int:
        return _BREAKER_LEVEL[self.state]

    def open_ticks(self, t: int) -> int:
        """Ticks since the breaker first left closed (0 when closed)."""
        return 0 if self._opened_at is None else max(0, t - self._opened_at)

    def allow(self, t: int) -> bool:
        """May this tenant's scrape/actuation be attempted at tick t?
        Transitions open→half-open when the probe is due."""
        if self.state == "closed":
            return True
        if self.state == "open" and t >= self._probe_at:
            self.state = "half-open"
            self.transitions["half_open"] += 1
            return True
        return self.state == "half-open"

    def record_success(self) -> None:
        if self.state != "closed":
            self.transitions["closed"] += 1
        self.state = "closed"
        self._fails = 0
        self._opens = 0
        self._opened_at = None

    def record_failure(self, t: int) -> None:
        self._fails += 1
        if self.state == "half-open" or self._fails >= \
                self._svc.breaker_failures:
            self._open(t)

    def _open(self, t: int) -> None:
        svc = self._svc
        if self.state != "open":
            self.transitions["opened"] += 1
        if self._opened_at is None:
            self._opened_at = t
        self.state = "open"
        self._opens += 1
        self._fails = 0
        base = svc.breaker_probe_ticks * (2.0 ** min(self._opens - 1, 8))
        u = float(counter_u01(self._seed, self.draws))
        self.draws += 1
        jit = 1.0 + svc.breaker_probe_jitter * (2.0 * u - 1.0)
        delay = int(round(base * jit))
        self._probe_at = t + max(1, min(delay, svc.breaker_max_probe_ticks))


class _ObjectBreakerBank:
    """The per-tenant breaker OBJECTS, kept as the paired
    baseline the fleet-scale bench measures the vectorized machine
    against. Same stream seeds, same draw addressing — `host_loop=
    "object"` must produce bitwise the vectorized path's schedules."""

    kind = "object"

    def __init__(self, svc: ServiceConfig, seed: int, n: int):
        self.breakers = [CircuitBreaker(svc, seed=seed ^ (0xB4EA + i))
                         for i in range(n)]

    def views(self):
        return self.breakers

    def level_of(self, i: int) -> int:
        return self.breakers[i].level

    def is_open(self, i: int) -> bool:
        return self.breakers[i].state == "open"

    def open_ticks(self, i: int, t: int) -> int:
        return self.breakers[i].open_ticks(t)

    def record_success(self, i: int) -> None:
        self.breakers[i].record_success()

    def record_failure(self, i: int, t: int) -> None:
        self.breakers[i].record_failure(t)

    def levels(self) -> np.ndarray:
        return np.asarray([b.level for b in self.breakers], np.int8)

    def opened_counts(self) -> list:
        return [b.transitions["opened"] for b in self.breakers]

    def transitions_total(self) -> int:
        return sum(sum(b.transitions.values()) for b in self.breakers)

    def transition_counts(self) -> dict:
        out = {"opened": 0, "half_open": 0, "closed": 0}
        for b in self.breakers:
            for k, v in b.transitions.items():
                out[k] += v
        return out

    def states_dict(self) -> dict:
        return {str(i): b.level for i, b in enumerate(self.breakers)}


class _BreakerView:
    """Read-only object facade over ONE tenant's row of the vectorized
    breaker bank — the ``svc.breakers[i]`` surface the board accessors
    and pinned tests read (state/level/transitions/open_ticks), without
    resurrecting N stateful objects."""

    __slots__ = ("_bank", "_i")

    def __init__(self, bank: "_VectorBreakerBank", i: int):
        self._bank = bank
        self._i = i

    @property
    def state(self) -> str:
        return _BREAKER_STATE[int(self._bank.level[self._i])]

    @property
    def level(self) -> int:
        return int(self._bank.level[self._i])

    @property
    def draws(self) -> int:
        return int(self._bank.draws[self._i])

    @property
    def transitions(self) -> dict:
        b, i = self._bank, self._i
        return {"opened": int(b.tr_opened[i]),
                "half_open": int(b.tr_half[i]),
                "closed": int(b.tr_closed[i])}

    def open_ticks(self, t: int) -> int:
        oa = int(self._bank.opened_at[self._i])
        return 0 if oa < 0 else max(0, t - oa)


class _VectorBreakerBank:
    """All N breakers as flat arrays: level/probe-deadline vectors,
    counter-based jitter streams, masked transitions. Scalar methods
    mirror :class:`_ObjectBreakerBank` for the shared fan-out loop;
    the float arithmetic per element is EXACTLY the object breaker's
    (``np.rint`` is half-to-even like Python ``round`` — the parity
    test pins the probe schedules bitwise)."""

    kind = "vectorized"

    def __init__(self, svc: ServiceConfig, seed: int, n: int):
        self._svc = svc
        self.n = n
        self.level = np.zeros(n, np.int8)       # 0 closed/1 half/2 open
        self.fails = np.zeros(n, np.int64)
        self.opens = np.zeros(n, np.int64)
        self.probe_at = np.zeros(n, np.int64)
        self.opened_at = np.full(n, -1, np.int64)   # -1 = closed epoch
        self.tr_opened = np.zeros(n, np.int64)
        self.tr_half = np.zeros(n, np.int64)
        self.tr_closed = np.zeros(n, np.int64)
        # Identical per-tenant seed derivation to the object bank.
        idx = np.arange(n, dtype=np.int64)
        self.seeds = ((_U64(seed & 0xFFFFFFFFFFFFFFFF)
                       ^ (idx + 0xB4EA).astype(_U64))
                      if n else np.zeros(0, _U64))
        self.draws = np.zeros(n, np.int64)
        # O(1) count of not-closed breakers: the calm-fleet fast paths
        # (no probe gate, no escalation scan) key off this instead of
        # scanning N levels every tick.
        self.n_tripped = 0
        self._state_keys = [str(i) for i in range(n)]

    @property
    def all_closed(self) -> bool:
        return self.n_tripped == 0

    def views(self) -> list:
        return [_BreakerView(self, i) for i in range(self.n)]

    # -- vectorized admission interface ---------------------------------

    def allow_due(self, due: np.ndarray, t: int):
        """Vectorized :meth:`CircuitBreaker.allow` over the due set:
        returns (allowed mask, probing mask) aligned with ``due``,
        flipping open→half-open exactly where the probe is due."""
        lv = self.level[due]
        flip = (lv == 2) & (t >= self.probe_at[due])
        idx = due[flip]
        self.level[idx] = 1
        self.tr_half[idx] += 1
        allowed = (lv != 2) | flip
        probing = (lv == 1) | flip
        return allowed, probing

    def record_success_idx(self, idx: np.ndarray) -> None:
        if idx.size == 0:
            return
        was_tripped = self.level[idx] != 0
        self.tr_closed[idx] += was_tripped
        self.n_tripped -= int(was_tripped.sum())
        self.level[idx] = 0
        self.fails[idx] = 0
        self.opens[idx] = 0
        self.opened_at[idx] = -1

    def record_failure_idx(self, idx: np.ndarray, t: int) -> None:
        if idx.size == 0:
            return
        self.fails[idx] += 1
        opening = (self.level[idx] == 1) | (
            self.fails[idx] >= self._svc.breaker_failures)
        self._open_idx(idx[opening], t)

    def _open_idx(self, idx: np.ndarray, t: int) -> None:
        if idx.size == 0:
            return
        svc = self._svc
        self.tr_opened[idx] += (self.level[idx] != 2)
        self.n_tripped += int((self.level[idx] == 0).sum())
        fresh = self.opened_at[idx] < 0
        self.opened_at[idx] = np.where(fresh, t, self.opened_at[idx])
        self.level[idx] = 2
        self.opens[idx] += 1
        self.fails[idx] = 0
        base = svc.breaker_probe_ticks * np.power(
            2.0, np.minimum(self.opens[idx] - 1, 8).astype(np.float64))
        u = counter_u01(self.seeds[idx], self.draws[idx])
        self.draws[idx] += 1
        jit = 1.0 + svc.breaker_probe_jitter * (2.0 * u - 1.0)
        delay = np.clip(np.rint(base * jit), 1,
                        svc.breaker_max_probe_ticks).astype(np.int64)
        self.probe_at[idx] = t + delay

    def open_ticks_vec(self, t: int) -> np.ndarray:
        return np.where(self.opened_at >= 0,
                        np.maximum(0, t - self.opened_at), 0)

    # -- scalar interface (shared fan-out loop) -------------------------

    def level_of(self, i: int) -> int:
        return int(self.level[i])

    def is_open(self, i: int) -> bool:
        return self.level[i] == 2

    def open_ticks(self, i: int, t: int) -> int:
        oa = int(self.opened_at[i])
        return 0 if oa < 0 else max(0, t - oa)

    def record_success(self, i: int) -> None:
        self.record_success_idx(np.asarray([i], np.int64))

    def record_failure(self, i: int, t: int) -> None:
        self.record_failure_idx(np.asarray([i], np.int64), t)

    # -- reporting ------------------------------------------------------

    def levels(self) -> np.ndarray:
        return self.level.astype(np.int8, copy=True)

    def opened_counts(self) -> list:
        return self.tr_opened.tolist()

    def transitions_total(self) -> int:
        return int(self.tr_opened.sum() + self.tr_half.sum()
                   + self.tr_closed.sum())

    def transition_counts(self) -> dict:
        return {"opened": int(self.tr_opened.sum()),
                "half_open": int(self.tr_half.sum()),
                "closed": int(self.tr_closed.sum())}

    def states_dict(self) -> dict:
        # tolist() yields python ints — same values, ~6x cheaper than
        # per-element int() at fleet scale (this dict is per tick).
        return dict(zip(self._state_keys, self.level.tolist()))



def exo_rows(xs_all: ExoStep, t: torch.Tensor, row0: torch.Tensor,
             rows: torch.Tensor, horizon_ticks: int) -> ExoStep:
    """Rows ``row0 + rows`` of every [N, T, ...] trace leaf at tick ``t``
    (mod the horizon), gathered in place: each leaf is read as its
    [N*T, ...] view at the flat index ``(row0 + r) * T + t``, so a
    captured chunk graph replays at whatever row offset and tick are
    copied in, and no chunk ever copies its rows of the stream."""
    t_mod = torch.remainder(t, horizon_ticks)
    out = []
    for x in xs_all:
        idx = (row0 + rows) * x.shape[1] + t_mod
        out.append(x.view(x.shape[0] * x.shape[1], *x.shape[2:])
                   .index_select(0, idx))
    return ExoStep(*out)


def _build_service_tick(cfg: FrameworkConfig, backend, k: int,
                        horizon_ticks: int, device: str, chunked: bool):
    """The lane-selecting batched tick of k tenants:
    `fleet._compiled_fleet_tick` with the service's three decision lanes
    folded into the SAME single dispatch: the backend's fresh decide and
    the rule fallback are both computed batched, then selected per row
    by the host-built lane vector, with held actions supplied as an
    input. One device round trip per tick regardless of how degraded
    the fleet is. Keyed on the backend INSTANCE (identity hash), so the
    overload board's paired stressed/calm services share one graph.

    The JAX tick threads ``split(fold_in(key, t), n)`` PRNG keys into
    its step; the step reads a key only when stochastic, and the service
    steps deterministically (as the port's fleet tick does), so there is
    no key input here and chunking cannot change any tenant's draws.

    The per-tenant rows widen past the slo_ok/cost/carbon/pending block
    with the decision-provenance columns and the rule SHADOW action
    (`obs/decisions.decision_row_layout`): the fallback lane's rule
    decide — already computed batched for the lane select — doubles as
    the counterfactual, stepped through the same expectation dynamics on
    the same pre-step states and observed exo; with a roster
    (``cfg.obs.tournament_roster``) the candidate lanes follow. These
    are computed whether or not a ledger reads them: toggling a ledger
    can never select another graph, which is the construction behind
    the ledger-on/off bitwise gate.

    Unchunked, the body is ``(states, xs_all, t, lanes, held)`` over the
    whole fleet; ``chunked``, ``(states, xs_all, t, row0, lanes, held)``
    over k tenants whose exo rows start at ``row0`` of the resident
    stream. Returns ``(packed [k, A+1], new_states, per [k, W])``."""
    from ccka_tpu_torch.harness.fleet import (_FleetTick, _require_capturable,
                                              batched_action, exo_at,
                                              flatten_actions, pack_rows,
                                              per_cluster_metrics)
    from ccka_tpu_torch.obs.decisions import shadow_decision_columns
    from ccka_tpu_torch.obs.tournament import (TournamentRoster,
                                               add_candidate_lanes,
                                               region_onehot)
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.sim.dynamics import step as sim_step
    from ccka_tpu_torch.sim.types import SimParams

    dev = torch.device(device)
    if dev.type == "cuda":
        _require_capturable(backend, "backend")
    roster = TournamentRoster(cfg, cfg.obs.tournament_roster, device=dev)
    if dev.type == "cuda":
        for name in roster.names:
            _require_capturable(roster.backend(name), f"candidate {name!r}")
    action_fn = backend.action_fn()
    fallback_fn = RulePolicy(cfg.cluster, device=dev).action_fn()
    params = SimParams.from_config(cfg, device=dev)
    shapes, sizes = action_layout(cfg.cluster)
    cand_fns = roster.action_fns()
    zone_region_index = cfg.cluster.zone_region_index
    n_regions = cfg.cluster.n_regions
    # Made before the capture: a captured body may not copy from the host.
    onehot = region_onehot(zone_region_index, n_regions, dev)
    rows = torch.arange(k, dtype=torch.int64, device=dev)

    def _unflatten(flat: torch.Tensor) -> Action:
        leaves, off = [], 0
        for shape, size in zip(shapes, sizes):
            leaves.append(flat[:, off:off + size].reshape((k,) + shape))
            off += size
        return Action(*leaves)

    def step_n(states, actions, exo_n):
        return sim_step(params, states, actions, exo_n, stochastic=False)

    def tick_core(states, exo_n, t, lanes, held):
        fresh = batched_action(action_fn(states, exo_n, t), k)
        fb = batched_action(fallback_fn(states, exo_n, t), k)
        flat_fb = flatten_actions(fb, k)
        lane_col = lanes[:, None]
        flat_sel = torch.where(
            lane_col == LANE_FRESH, flatten_actions(fresh, k),
            torch.where(lane_col == LANE_HOLD, held, flat_fb))
        new_states, metrics = step_n(states, _unflatten(flat_sel), exo_n)
        # Rule-shadow counterfactual: same pre-step states and exo; only
        # the action differs. Shadow next-states are discarded — the real
        # estimate chain must not fork.
        _sh_states, sh_metrics = step_n(states, _unflatten(flat_fb), exo_n)
        packed = pack_rows(flat_sel, exo_n)
        blocks = [
            per_cluster_metrics(metrics),
            shadow_decision_columns(metrics, sh_metrics, exo_n, flat_sel,
                                    flat_fb),
            flat_fb,
        ]
        if cand_fns:
            # Unconditional K-candidate lanes (obs/tournament.py): the
            # tournament ledger toggling on/off can never select another
            # graph.
            blocks.append(add_candidate_lanes(
                states, exo_n, t, flat_sel, cand_fns, step_n, k,
                zone_region_index, n_regions, onehot=onehot))
        return packed, new_states, torch.cat(blocks, dim=-1)

    if chunked:
        def service_tick_chunk(states, xs_all, t, row0, lanes, held):
            exo_n = exo_rows(xs_all, t, row0, rows, horizon_ticks)
            return tick_core(states, exo_n, t, lanes, held)
        body, name = service_tick_chunk, "service.tick_chunk"
    else:
        def service_tick(states, xs_all, t, lanes, held):
            return tick_core(states, exo_at(xs_all, t, horizon_ticks), t,
                             lanes, held)
        body, name = service_tick, "service.tick"
    from ccka_tpu_torch.obs.compile import watch_jit
    return watch_jit(_FleetTick(body, graphed=dev.type == "cuda"), name,
                     hot=True, shared_stats=True)


@functools.lru_cache(maxsize=32)
def _compiled_service_tick(cfg: FrameworkConfig, backend, n: int,
                           horizon_ticks: int, device: str):
    """The whole-fleet service tick, built ONCE per (config, backend,
    fleet size, horizon, device); the roster names ride ``cfg.obs`` and
    so key it too, while the host toggles (``obs.enabled``,
    ``obs.decisions_enabled``, ``obs.tournament_enabled``) are never
    read here. Watched as ``service.tick``."""
    return _build_service_tick(cfg, backend, n, horizon_ticks, device,
                               chunked=False)


@functools.lru_cache(maxsize=32)
def _compiled_service_tick_chunk(cfg: FrameworkConfig, backend, k: int,
                                 horizon_ticks: int, device: str,
                                 rows_total: int):
    """The k-tenant chunk graph, cached apart from the unchunked tick so
    a chunked N=10240 fleet captures exactly ONE chunk graph, not one per
    chunk index, and replays it for every chunk of every tick. The key
    also holds the fleet size ``rows_total``: the graph reads the
    resident [rows_total, T, ...] stream in place (its static stream
    slot has that shape), which is what keeps the stream from being
    copied per replay. Watched as ``service.tick_chunk``."""
    del rows_total  # a key, not an input: the body reads the stream's rows
    return _build_service_tick(cfg, backend, k, horizon_ticks, device,
                               chunked=True)


def _rows(tree, lo: int, hi: int):
    """Rows lo..hi-1 of every leaf (views)."""
    return type(tree)(*(x[lo:hi] for x in tree))


@dataclasses.dataclass
class ServiceTickReport:
    """One service tick: fleet KPIs + the overload-control surfaces."""

    t: int
    n_tenants: int
    admitted: int              # tenants whose fresh decide was used
    deferred: int              # scrape stragglers abandoned at the budget
    shed: int                  # decides shed by admission backpressure
    cadence_skipped: int       # stale-tolerant tenants skipped by backoff
    bulkhead_skipped: int      # open-breaker tenants not even attempted
    scrape_failed: int         # scrapes attempted but timed out / failed
    probes: int                # half-open probes attempted this tick
    applied: int               # tenants whose reconcile converged
    fanout_deferred: int       # tenants un-actuated at the tick deadline
    slo_ok: int                # tenants meeting the SLO gate
    cost_usd_hr: float
    carbon_g_hr: float
    pending_pods: float
    tick_latency_ms: float     # admission+decide+fanout on the clock
    admission_queue_depth: int  # decides wanting in this tick (pre-cap)
    sheds_total: int           # session-cumulative (promexport counter)
    deferrals_total: int
    breaker_transitions_total: int
    cadence_divisor: int       # 1 = full cadence for stale-tolerant rows
    decide_ms: float
    fanout_ms: float
    # Per-tenant breaker levels {tenant index as str: 0|1|2}; promexport
    # sums this dict ("breaker_states.*") into the fleet's aggregate
    # breaker-pressure gauge.
    breaker_states: dict = dataclasses.field(default_factory=dict)
    # Incident-grade observability surfaces (`obs/`;
    # all 0 with the obs layer off — the gauges then read as a quiet
    # fleet, exactly like the degraded/fault gauges on a calm run).
    slo_burn_rate: float = 0.0        # fast-window fleet SLO burn
    slo_burn_rate_slow: float = 0.0   # slow-window (the flap damper)
    incident_active: int = 0          # burning OR a fresh incident
    incidents_total: int = 0          # session incident stamps
    recorder_dumps_total: int = 0     # session checksummed captures
    # Device-time observatory surfaces (obs/costmodel +
    # obs/occupancy): the compile registry's session dispatch count,
    # plus whatever the observatory last PUBLISHED (`ccka perf` /
    # bench --perf-only writes a pipeline snapshot). None/{} means no
    # measurement exists — the exporter then SKIPS the series, the
    # established never-fake-zeros contract.
    program_dispatches_total: "int | None" = None
    achieved_roofline_fraction: "float | None" = None
    pipeline_occupancy: dict = dataclasses.field(default_factory=dict)
    shard_imbalance: "float | None" = None
    # Decision-provenance surfaces (obs/decisions.py): the
    # windowed shadow-disagreement rate, the fleet's objective-term
    # attribution shares (promexport reads the dotted "cost" share),
    # and the tick's projected chosen-minus-rule-shadow SLO/$ deltas.
    # None/{} when the ledger is off — the exporter SKIPS the series
    # (never-fake-zeros), same as the perf surfaces above.
    policy_divergence_rate: "float | None" = None
    objective_term_shares: dict = dataclasses.field(default_factory=dict)
    shadow_slo_delta: "float | None" = None
    shadow_usd_delta: "float | None" = None
    # Geo-arbitrage surfaces (regions/geo.py): whatever the
    # geo overlay last PUBLISHED (`publish_geo_snapshot` — the costmodel
    # costmodel publish/read idiom; the tick never threads geo state).
    # {} when no geo rollout has run — the exporter SKIPS the series.
    region_migration_rate: dict = dataclasses.field(default_factory=dict)
    region_carbon_intensity: dict = dataclasses.field(default_factory=dict)
    # Shadow-tournament surfaces (obs/tournament.py): the
    # per-candidate windowed win rates (promexport sums the dict — the
    # "challenger pressure" gauge) and the current board leader's
    # roster index. {}/None when no tournament ledger runs — the
    # exporter SKIPS both series (never-fake-zeros).
    candidate_win_rate: dict = dataclasses.field(default_factory=dict)
    tournament_leader: "int | None" = None
    # Fleet-scale host-loop surfaces: real host microseconds
    # the admission/accounting machine spent per tenant this tick
    # (virtual scrape delay subtracted via the clock offset; dispatch
    # and fan-out excluded — they are common to both host loops), and
    # the tenant count that entered the scrape/dispatch phase. None on
    # reports that never measured them — the exporter SKIPS the series
    # (never-fake-zeros).
    host_loop_us_per_tenant: "float | None" = None
    active_tenants: "int | None" = None



class FleetService:
    """N tenant clusters behind one bounded, bulkheaded batched tick.

    Construction mirrors :class:`FleetController` (which it wraps for
    the device machinery and per-tenant reconcilers) plus per-tenant
    ``profiles`` (names into :data:`TENANT_PROFILES`; default all
    "healthy") and a ``service`` posture (default ``cfg.service``).
    Tenants whose profile names a chaos intensity get their sink wrapped
    in a seeded `ChaosSink` (per-tenant seed derivation, the fleet
    idiom), so the breaker's actuation-failure signal is driven by the
    same injected kubectl edge the recovery scoreboard uses.

    With ``service.enabled`` False every tick delegates verbatim to the
    wrapped FleetController — the zero-overhead "off" gate.

    ``device``: the card unless ``"cpu"`` is given; without a GPU and
    without that request construction raises. On the card a backend or
    roster candidate that cannot be captured is refused, naming itself.
    """

    def __init__(self, cfg: FrameworkConfig, backend: PolicyBackend,
                 source: SignalSource, sinks: Sequence[ActuationSink],
                 *, profiles: Sequence[str] | None = None,
                 service: ServiceConfig | None = None,
                 obs=None,
                 horizon_ticks: int = 2880, seed: int = 0,
                 clock: VirtualClock | None = None, tracer=None,
                 host_loop: str = "vectorized",
                 dispatch_chunk: "int | None" = None,
                 transport=None, device=None,
                 log_fn: Callable[[str], None] | None = None):
        svc = cfg.service if service is None else service
        svc.validate()
        if host_loop not in ("vectorized", "object"):
            raise ValueError(f"host_loop={host_loop!r} — expected "
                             "'vectorized' or 'object'")
        self.device = resolve_device(device)
        self.svc = svc
        self.cfg = cfg
        n = len(sinks)
        names = list(profiles) if profiles is not None else ["healthy"] * n
        if len(names) != n:
            raise ValueError(f"{len(names)} profiles for {n} sinks — one "
                             "profile per tenant")
        self.profiles = resolve_profiles(names)
        self.profile_names = [p.name for p in self.profiles]
        # Per-tenant kubectl-edge chaos per the profile (seed derivation
        # per tenant: one shared seed would fail every tenant in
        # lockstep, hiding exactly the asymmetric-failure case bulkheads
        # exist for).
        wrapped: list[ActuationSink] = []
        for i, (snk, prof) in enumerate(zip(sinks, self.profiles)):
            if prof.chaos:
                from ccka_tpu_torch.actuation.chaos import make_chaos_sink
                snk = make_chaos_sink(snk, prof.chaos,
                                      seed=seed ^ (0xC4A05 + i))
            wrapped.append(snk)
        self.ctrl = FleetController(
            cfg, backend, source, wrapped, horizon_ticks=horizon_ticks,
            seed=seed, fanout_workers=1, tracer=tracer, log_fn=log_fn,
            device=self.device)
        self.n = n
        self.sinks = self.ctrl.sinks
        self.tracer = self.ctrl.tracer
        self.log_fn = log_fn or (lambda s: None)
        self._seed = seed
        if not svc.enabled:
            return  # hard gate: tick()/run() delegate to the controller

        self.clock = clock if clock is not None else VirtualClock()
        self._host_loop = host_loop
        self._transport = transport
        dev = str(self.device)
        # The resident [N, T, ...] stream every graph reads in place (a
        # chunk graph through its row offset): contiguous, so each leaf
        # has its flat [N*T, ...] view.
        self._xs = ExoStep(*(x.contiguous() for x in self.ctrl._xs_all))
        # Chunked tenant-axis dispatch: N=10^3-10^4 fleets ride
        # `sim/lanes.chunk_layout`-validated chunks through ONE k-tenant
        # graph.
        if dispatch_chunk is not None and dispatch_chunk < n:
            from ccka_tpu_torch.sim.lanes import chunk_layout
            self._n_chunks = chunk_layout(n, dispatch_chunk)
            self._chunk = int(dispatch_chunk)
            self._tick_fn = _compiled_service_tick_chunk(
                cfg, backend, self._chunk, horizon_ticks, dev, n)
        else:
            self._n_chunks = 1
            self._chunk = n
            self._tick_fn = _compiled_service_tick(cfg, backend, n,
                                                   horizon_ticks, dev)
        # Service-tuned reconcilers over the (chaos-wrapped) sinks: the
        # fleet controller's defaults carry a 2s internal deadline and
        # 10ms backoffs — one converge started just before the tick
        # deadline would blow through it. Each converge is budgeted to
        # a small slice of the fan-out share, and the fan-out loop only
        # STARTS a converge whose worst case still fits the remaining
        # tick budget, so the deadline is a guarantee, not a hope.
        from ccka_tpu_torch.actuation.reconcile import Reconciler
        if svc.tick_deadline_ms > 0.0:
            fan_budget_s = (svc.tick_deadline_ms
                            * (1.0 - svc.scrape_budget_frac) / 1e3)
            self._converge_budget_s = min(0.05, fan_budget_s / 4.0)
        else:
            self._converge_budget_s = 2.0
        # The converge deadline reads the service's clock, as every other
        # deadline of the tick does: on the real clock that is the JAX
        # service's time.monotonic; on a deterministic clock a host stall
        # inside a converge (a garbage collection) can no longer turn one
        # run's apply into a give-up that a paired run does not see.
        self._reconcilers = [
            Reconciler(snk, max_rounds=2, backoff_s=0.002,
                       deadline_s=self._converge_budget_s,
                       seed=seed ^ (0x5EC0 + i), clock=self.clock)
            for i, snk in enumerate(self.ctrl.sinks)]
        # Breaker machinery: flat arrays by default; the object bank is
        # the paired baseline the fleet-scale bench measures against
        # (same stream seeds → identical probe schedules either way).
        self._brk = (_VectorBreakerBank(svc, seed, n)
                     if host_loop == "vectorized"
                     else _ObjectBreakerBank(svc, seed, n))
        # Per-tenant scrape-fail streams, counter-addressed: draw order
        # across tenants is irrelevant by construction, which is what
        # lets the vectorized scrape phase batch the zero-delay tenants'
        # draws.
        idx_n = np.arange(n, dtype=np.int64)
        self._scrape_seeds = (_U64(seed & 0xFFFFFFFFFFFFFFFF)
                              ^ (idx_n + 0x5C12A9).astype(_U64))
        self._scrape_draws = np.zeros(n, np.int64)
        # Flat per-profile vectors for the vectorized admission machine.
        self._stale_arr = np.asarray(
            [p.stale_tolerant for p in self.profiles], bool)
        self._delay_s_arr = np.asarray(
            [p.scrape_delay_ms / 1e3 for p in self.profiles], np.float64)
        self._failp_arr = np.asarray(
            [p.scrape_fail_prob for p in self.profiles], np.float64)
        # Static profile facts the admission fast path keys off: a
        # fleet with no budget-consuming and no fallible scrapes skips
        # the whole scrape walk (profiles are fixed per service).
        self._any_delay = bool((self._delay_s_arr > 0.0).any())
        self._any_failp = bool((self._failp_arr > 0.0).any())
        # Held action rows [N, A] (packed layout minus the is_peak
        # column); neutral until a tenant's first fresh decide lands. On
        # the card the rows and the lane vector live in pinned host
        # memory, each copied to its device slot once a tick.
        neutral = np.concatenate(
            [leaf.numpy().astype(np.float32).reshape(-1)
             for leaf in Action.neutral(cfg.cluster.n_pools,
                                        cfg.cluster.n_zones,
                                        device="cpu")])
        a = neutral.shape[0]
        if self.device.type == "cuda":
            self._held_pin = torch.empty((n, a), dtype=torch.float32,
                                         pin_memory=True)
            self._lanes_pin = torch.empty(n, dtype=torch.int32,
                                          pin_memory=True)
            self._held = self._held_pin.numpy()
            self._held[:] = neutral[None, :]
            self._held_dev = torch.empty((n, a), dtype=torch.float32,
                                         device=self.device)
            self._lanes_dev = torch.empty(n, dtype=torch.int32,
                                          device=self.device)
            self._host_out = None      # pinned (packed, per), made lazily
            self._event = torch.cuda.Event()
        else:
            self._held = np.tile(neutral[None, :], (n, 1))
        # Admission order: priority ascending, index-stable — critical
        # tenants scrape (and actuate) inside the budget first.
        self._order = sorted(range(n),
                             key=lambda i: (self.profiles[i].priority, i))
        # The argsort-once form of the same order (lexsort is stable on
        # its last key, so ties break by index exactly like the tuple
        # sort above) — computed once, reused by every vectorized tick.
        self._order_arr = np.lexsort((
            np.arange(n, dtype=np.int64),
            np.asarray([p.priority for p in self.profiles], np.int64)))
        # Session counters + per-tenant accounting (the overload board's
        # isolation evidence reads these).
        self.sheds_total = 0
        self.deferrals_total = 0
        self.cadence_skips_total = 0
        self.bulkhead_skips_total = 0
        self.scrape_timeouts_total = 0
        self.scrape_failures_total = 0
        self.actuation_giveups_total = 0
        self.tenant_cost_usd = np.zeros(n, np.float64)
        self.tenant_slo_ticks = np.zeros(n, np.float64)
        self.tenant_fresh_ticks = np.zeros(n, np.int64)
        # Retention-bounded like the fleet's default tracer: a service
        # daemon ticks forever, and an unbounded per-tick float list on
        # the hot loop is a slow leak. 4096 covers any overload-board
        # run; long-lived owners wanting full history can drain it.
        from collections import deque
        self.latencies_ms: "deque[float]" = deque(maxlen=4096)
        self._sat_streak = 0
        self._cadence_divisor = 1
        # Incident-grade observability (`obs/`): flight recorder +
        # trigger stamps + burn-rate engine, all host-side and all AFTER
        # each tick's decisions — enabling this changes no decision and
        # no patch byte.
        ob = cfg.obs if obs is None else obs
        ob.validate()
        self.obs = ob
        self.recorder = None
        self.incidents = None
        self.burn = None
        self.decisions = None
        self.tournament = None
        if ob.enabled:
            from ccka_tpu_torch.obs.burnrate import BurnRateEngine
            from ccka_tpu_torch.obs.incidents import IncidentLog
            from ccka_tpu_torch.obs.recorder import FLEET_KEY, FlightRecorder
            self._fleet_key = FLEET_KEY
            self.recorder = FlightRecorder(ob)
            self.incidents = IncidentLog(ob.incident_log_path,
                                         recorder=self.recorder)
            self.burn = BurnRateEngine(ob.burn_fast_window,
                                       ob.burn_slow_window,
                                       ob.burn_threshold)
            # Trigger bookkeeping: breaker opens are counted off the
            # breakers' own transition tallies (one stamp per open, by
            # construction), lane escalations off the previous tick's
            # lane vector, give-ups off the reconciler's OWN hook (the
            # layer that defines "gave up" — actuation/reconcile.py).
            self._prev_opened = [0] * n
            self._prev_lanes = None
            self._giveups_this_tick: list[int] = []
            for i, rec in enumerate(self._reconcilers):
                rec.on_giveup = functools.partial(self._note_giveup, i)
            # Decision-provenance ledger (obs/decisions.py): host-side
            # recording of the shadow lanes the tick already emits.
            # Disabled-but-obs-on is the off-arm — the device graph is
            # the same either way.
            if ob.decisions_enabled:
                from ccka_tpu_torch.obs.decisions import DecisionLedger
                self.decisions = DecisionLedger(
                    ob, cfg.train,
                    policy=getattr(backend, "name",
                                   type(backend).__name__))
            # Shadow tournament (obs/tournament.py): the host-side win
            # ledger over the candidate lanes the tick already emits.
            # The roster is cfg.obs's (graph truth); an obs override
            # naming a DIFFERENT roster would score columns that don't
            # exist — refuse.
            roster = tuple(cfg.obs.tournament_roster)
            if obs is not None and tuple(ob.tournament_roster) not in (
                    (), roster):
                raise ValueError(
                    "obs override names tournament roster "
                    f"{ob.tournament_roster} but the compiled tick "
                    f"carries cfg.obs.tournament_roster={roster} — "
                    "the roster is program-shaping and must be set on "
                    "the FrameworkConfig, not the override")
            if roster and ob.tournament_enabled:
                from ccka_tpu_torch.obs.tournament import (TournamentLedger,
                                                           workload_class)
                self.tournament = TournamentLedger(
                    ob, cfg.train, roster,
                    classes=[workload_class(p.name)
                             for p in self.profiles],
                    policy=getattr(backend, "name",
                                   type(backend).__name__))
        # ONE row layout for both host ledgers, widened by the graph's
        # roster (K=0 -> exactly the rule-shadow layout).
        from ccka_tpu_torch.obs.decisions import decision_row_layout
        self._dec_layout = decision_row_layout(
            cfg.cluster, candidates=cfg.obs.tournament_roster)

    def _note_giveup(self, tenant: int, _outcome) -> None:
        """Reconciler give-up hook (`actuation/reconcile.on_giveup`):
        collected per tick, stamped in the tick's obs block with the
        tick key the incident timeline joins on."""
        self._giveups_this_tick.append(tenant)

    # -- delegation surface --------------------------------------------------

    @property
    def states(self):
        return self.ctrl.states

    @property
    def breakers(self) -> list:
        """Per-tenant breaker surface (objects in ``host_loop="object"``
        mode, read-only row views over the vectorized bank otherwise).
        Raises AttributeError when the service is disabled — the off
        preset carries no breaker machinery."""
        bank = self.__dict__.get("_brk")
        if bank is None:
            raise AttributeError("breakers (service disabled)")
        return bank.views()

    def close(self) -> None:
        if getattr(self, "incidents", None) is not None:
            self.incidents.close()
        if getattr(self, "decisions", None) is not None:
            self.decisions.close()
        if getattr(self, "tournament", None) is not None:
            self.tournament.close()
        self.ctrl.close()

    def warmup(self) -> None:
        """Capture (or reuse) the tick's CUDA graph without advancing any
        state: a cold service's first tick would otherwise spend its
        deadline inside the capture and defer its whole fan-out. The
        overload harness calls this before measuring latencies; a daemon
        may skip it and simply eat one deferred first tick. On the CPU
        the body runs eagerly and there is nothing to build."""
        if not self.svc.enabled or self.device.type != "cuda":
            return
        k = self._chunk
        lanes = torch.zeros(k, dtype=torch.int32, device=self.device)
        held = torch.from_numpy(self._held[:k]).to(self.device)
        st = _rows(self.ctrl.states, 0, k)
        if self._n_chunks > 1:
            packed, _, per = self._tick_fn(st, self._xs, 0, 0, lanes, held)
        else:
            packed, _, per = self._tick_fn(st, self._xs, 0, lanes, held)
        self._host_blocks(packed, per)
        torch.cuda.current_stream().synchronize()

    def _host_blocks(self, packed, per) -> tuple:
        """The pinned host (packed [N, A+1], per [N, W]) landing blocks,
        made once from the graph's output widths (a pinned allocation
        is slow: warmup makes them before the first tick)."""
        if self._host_out is None:
            self._host_out = tuple(
                torch.empty((self.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                            pin_memory=True) for x in (packed, per))
        return self._host_out

    def _dispatch(self, t: int, lanes: np.ndarray):
        """ONE batched dispatch, lanes selected on device — or, chunked on
        the tenant axis, the SAME graph over k-tenant slices, each
        chunk's outputs leaving the graph before the next replay (the
        new states into their rows of the service's states, the packed
        and per rows into their rows of the host blocks). Returns the
        host (packed [N, A+1], per [N, W]) blocks."""
        k, chunked = self._chunk, self._n_chunks > 1
        cuda = self.device.type == "cuda"
        states = self.ctrl.states
        if cuda:
            # The lane vector and the held rows go to their device slots
            # once a tick (pinned, in stream order); every graph output
            # is copied out before the next replay overwrites it.
            self._lanes_pin.numpy()[:] = lanes
            self._lanes_dev.copy_(self._lanes_pin, non_blocking=True)
            self._held_dev.copy_(self._held_pin, non_blocking=True)
            lanes_t, held_t = self._lanes_dev, self._held_dev
        else:
            lanes_t = torch.from_numpy(lanes)
            held_t = torch.from_numpy(self._held)
        parts = []
        for lo in range(0, self.n, k):
            hi = lo + k
            rows = _rows(states, lo, hi)
            args = ((t, lo, lanes_t[lo:hi], held_t[lo:hi]) if chunked
                    else (t, lanes_t, held_t))
            packed, new_states, per = self._tick_fn(rows, self._xs, *args)
            if not cuda:
                parts.append((packed, new_states, per))
                continue
            host_packed, host_per = self._host_blocks(packed, per)
            for d, s in zip(rows, new_states):
                d.copy_(s)
            host_packed[lo:hi].copy_(packed, non_blocking=True)
            host_per[lo:hi].copy_(per, non_blocking=True)
        if cuda:
            self._event.record()
            self._event.synchronize()
            # Copies: the pinned blocks are the next tick's landing slots.
            return host_packed.numpy().copy(), host_per.numpy().copy()
        self.ctrl.states = ClusterState(*(
            torch.cat(leaves, dim=0) for leaves in zip(*(p[1] for p in parts))))
        return (torch.cat([p[0] for p in parts]).numpy(),
                torch.cat([p[2] for p in parts]).numpy())

    # -- scrape simulation ---------------------------------------------------

    def _scrape(self, i: int, budget_s: float) -> tuple[bool, bool]:
        """Attempt tenant i's scrape within ``budget_s``; returns
        (ok, timed_out). A profile delay larger than the remaining
        budget consumes the WHOLE remaining budget and times out — the
        straggler is abandoned at the budget edge, exactly what a
        scrape-with-timeout does to a hung endpoint. With a concurrent
        ``transport`` injected (signals/transport.py) the real fetch
        replaces the VirtualClock profile simulation behind the same
        contract."""
        if self._transport is not None:
            return self._transport.scrape(i, budget_s)
        prof = self.profiles[i]
        delay_s = prof.scrape_delay_ms / 1e3
        if delay_s > 0.0:
            if delay_s > budget_s:
                self.clock.advance(max(budget_s, 0.0))
                return False, True
            self.clock.advance(delay_s)
        if prof.scrape_fail_prob > 0.0 and \
                self._scrape_fail_draw(i) < prof.scrape_fail_prob:
            return False, False
        return True, False

    def _scrape_fail_draw(self, i: int) -> float:
        """One draw from tenant i's counter-addressed scrape stream."""
        u = float(counter_u01(self._scrape_seeds[i],
                              int(self._scrape_draws[i])))
        self._scrape_draws[i] += 1
        return u

    # -- admission machine (steps 1-5 of the tick) ---------------------------

    def _admit_object(self, t: int, scrape_end: float):
        """The per-tenant admission loop (cadence →
        bulkheads → cap/shed → bounded scrape → lanes), kept verbatim
        as the paired baseline the fleet-scale bench measures the
        vectorized machine against. Returns the admission tuple shared
        with :meth:`_admit_vectorized`."""
        svc = self.svc
        brs = self._brk.breakers

        # 1. arrivals: every tenant is due unless cadence-degraded
        #    (stale-tolerant tenants decide every `divisor` ticks
        #    while the queue has been saturating). Tenants whose
        #    breaker is not closed are NEVER cadence-skipped: the
        #    seeded probe schedule must not silently depend on
        #    admission outcomes.
        due: list[int] = []
        cadence_skipped = 0
        div = self._cadence_divisor
        for i in self._order:
            if (div > 1 and self.profiles[i].stale_tolerant
                    and brs[i].state == "closed"
                    and (t + i) % div != 0):
                cadence_skipped += 1
                continue
            due.append(i)

        # 2. bulkheads BEFORE the cap: an open breaker must not
        #    consume an admission slot (known-bad tenants filling
        #    the queue would starve healthy ones into being shed —
        #    the inverse of the isolation contract). allow() is the
        #    probe gate: it flips open→half-open exactly when the
        #    seeded schedule says so.
        live: list[int] = []
        probing: set[int] = set()
        bulkhead_skipped = 0
        for i in due:
            br = brs[i]
            if not br.allow(t):
                # Bulkheaded for the WHOLE tick (scrape and fan-out
                # both skipped); the fan-out loop must not count it
                # again.
                bulkhead_skipped += 1
                continue
            live.append(i)
            if br.state == "half-open":
                probing.add(i)
        queue_depth = len(live)

        # 3. admission cap: shed overflow from the BACK of the
        #    priority order (stale-tolerant/low-priority first).
        #    Due half-open probes are EXEMPT from the cap — the
        #    seeded probe schedule must not be shed by backpressure
        #    — but they keep their priority position in the scrape
        #    order, so a probe never burns the budget ahead of a
        #    healthier tenant.
        cap = svc.admission_queue_cap or self.n
        non_probing = [i for i in live if i not in probing]
        shed = max(0, len(non_probing) - cap)
        keep = set(non_probing[:cap]) | probing
        ready = [i for i in live if i in keep]

        # 4. bounded scrape loop: stragglers defer when the budget
        #    runs out — abandoned at the budget edge, never awaited.
        admitted: list[int] = []
        scraped_ok = np.zeros(self.n, bool)
        deferred = scrape_failed = probes = 0
        for pos, i in enumerate(ready):
            now = self.clock()
            if now >= scrape_end:
                deferred += len(ready) - pos
                self.deferrals_total += len(ready) - pos
                break
            if brs[i].state == "half-open":
                probes += 1
            ok, timed_out = self._scrape(i, scrape_end - now)
            if ok:
                admitted.append(i)
                scraped_ok[i] = True
            else:
                scrape_failed += 1
                self.scrape_timeouts_total += int(timed_out)
                self.scrape_failures_total += int(not timed_out)
                brs[i].record_failure(t)

        # 5. lanes: fresh for admitted; open breakers escalate
        #    hold → rule-fallback after hold_fallback_after ticks.
        lanes = np.full(self.n, LANE_HOLD, np.int32)
        if admitted:
            lanes[np.asarray(admitted, int)] = LANE_FRESH
        for i in range(self.n):
            if lanes[i] == LANE_HOLD and brs[i].open_ticks(
                    t) >= svc.hold_fallback_after:
                lanes[i] = LANE_FALLBACK
        return (cadence_skipped, bulkhead_skipped, queue_depth, shed,
                len(ready), np.asarray(admitted, np.int64), scraped_ok,
                deferred, scrape_failed, probes, lanes)

    def _admit_vectorized(self, t: int, scrape_end: float):
        """Steps 1-5 as flat array ops: masked cadence/shed accounting
        over the argsort-once admission order, the breaker bank's
        vectorized probe gate, batched counter-stream fail draws for
        zero-delay tenants, and a sequential walk over ONLY the tenants
        whose scrapes consume budget (their VirtualClock advances are
        order-dependent by design — the budget edge is a shared
        resource). Decisions, patch streams and report counters are
        bitwise `_admit_object`'s on the det clock."""
        svc = self.svc
        bank = self._brk
        n = self.n
        order = self._order_arr

        # 1. cadence (closed breakers only — the probe schedule must
        #    not depend on admission outcomes).
        div = self._cadence_divisor
        if div > 1:
            skip = (self._stale_arr[order]
                    & (bank.level[order] == 0)
                    & ((t + order) % div != 0))
            cadence_skipped = int(skip.sum())
        else:
            cadence_skipped = 0
        due = order[~skip] if cadence_skipped else order

        # 2. bulkheads BEFORE the cap (vectorized probe gate). With
        #    every breaker closed (the calm-fleet common case, O(1) via
        #    the bank's tripped count) the gate trivially allows all
        #    and probes none — same outputs, no mask machinery.
        if bank.all_closed:
            bulkhead_skipped = 0
            live = due
            probing = None
        else:
            allowed, probing_all = bank.allow_due(due, t)
            bulkhead_skipped = int(due.size) - int(allowed.sum())
            live = due[allowed]
            probing = probing_all[allowed]
        queue_depth = int(live.size)

        # 3. admission cap: probes exempt, overflow shed from the back
        #    of the priority order (rank among non-probing rows; with
        #    no probes the kept set is exactly the first `cap` rows).
        cap = svc.admission_queue_cap or n
        if probing is None:
            shed = max(0, queue_depth - cap)
            ready = live[:cap] if shed else live
        else:
            non_probing = ~probing
            shed = max(0, int(non_probing.sum()) - cap)
            rank = np.cumsum(non_probing) - 1
            keep = probing | (non_probing & (rank < cap))
            ready = live[keep]

        # 4. bounded scrape phase. Zero-delay tenants never move the
        #    clock, so their fail draws batch through the counter
        #    streams; only budget-consuming tenants walk sequentially
        #    (stragglers abandoned at the budget edge, never awaited).
        nr = int(ready.size)
        if self._transport is None and not self._any_delay \
                and not self._any_failp:
            # Every scrape is free and cannot fail: all ready rows
            # admit, nothing defers, no draws are consumed — exactly
            # what the general walk below computes, without building
            # its masks.
            probes = (0 if probing is None
                      else int((bank.level[ready] == 1).sum()))
            admitted = ready
            scraped_ok = np.zeros(n, bool)
            lanes = np.full(n, LANE_HOLD, np.int32)
            if admitted.size:
                a0 = int(admitted.min())
                a1 = int(admitted.max())
                if a1 - a0 + 1 == admitted.size:
                    # Pigeonhole: distinct indices spanning their
                    # range ARE the range — strided stores, no
                    # scatter.
                    scraped_ok[a0:a1 + 1] = True
                    lanes[a0:a1 + 1] = LANE_FRESH
                else:
                    scraped_ok[admitted] = True
                    lanes[admitted] = LANE_FRESH
            if not bank.all_closed:
                esc = (lanes == LANE_HOLD) & (
                    bank.open_ticks_vec(t) >= svc.hold_fallback_after)
                lanes[esc] = LANE_FALLBACK
            return (cadence_skipped, bulkhead_skipped, queue_depth,
                    shed, nr, admitted.astype(np.int64, copy=False),
                    scraped_ok, 0, 0, probes, lanes)
        half_open_before = bank.level[ready] == 1
        ok_mask = np.zeros(nr, bool)
        fail_mask = np.zeros(nr, bool)
        timeout_mask = np.zeros(nr, bool)
        cut = nr
        if self._transport is not None:
            # Concurrent fan-in: every ready tenant's fetch launches
            # at once, each bounded by the remaining scrape budget.
            budget = max(scrape_end - self.clock(), 0.0)
            res = self._transport.fan_in(
                [int(i) for i in ready], budget)
            for q in range(nr):
                ok, timed_out = res[int(ready[q])]
                ok_mask[q] = ok
                if not ok:
                    fail_mask[q] = True
                    timeout_mask[q] = timed_out
        else:
            delays = self._delay_s_arr[ready]
            failp = self._failp_arr[ready]
            clk = self.clock
            for q in np.flatnonzero(delays > 0.0):
                q = int(q)
                rem = scrape_end - clk()
                if rem <= 0.0:
                    cut = q
                    break
                i = int(ready[q])
                if delays[q] > rem:
                    clk.advance(max(rem, 0.0))
                    fail_mask[q] = True
                    timeout_mask[q] = True
                    cut = q + 1
                    break
                clk.advance(delays[q])
                if failp[q] > 0.0 and \
                        self._scrape_fail_draw(i) < failp[q]:
                    fail_mask[q] = True
                else:
                    ok_mask[q] = True
                if clk() >= scrape_end:
                    cut = q + 1
                    break
            free = delays == 0.0
            free[cut:] = False
            free_pos = np.flatnonzero(free)
            drawp = free_pos[failp[free_pos] > 0.0]
            if drawp.size:
                ids = ready[drawp]
                u = counter_u01(self._scrape_seeds[ids],
                                self._scrape_draws[ids])
                self._scrape_draws[ids] += 1
                f = u < failp[drawp]
                fail_mask[drawp] = f
                ok_mask[drawp] = ~f
            ok_mask[free_pos[failp[free_pos] == 0.0]] = True
        deferred = nr - cut
        if deferred:
            self.deferrals_total += deferred
        probes = int(half_open_before[:cut].sum())
        scrape_failed = int(fail_mask.sum())
        self.scrape_timeouts_total += int(timeout_mask.sum())
        self.scrape_failures_total += int(
            (fail_mask & ~timeout_mask).sum())
        bank.record_failure_idx(ready[fail_mask], t)
        admitted = ready[ok_mask]
        scraped_ok = np.zeros(n, bool)
        scraped_ok[admitted] = True

        # 5. lanes (masked hold→fallback escalation; with every
        #    breaker closed — checked AFTER this tick's failures
        #    recorded — no opened_at stamp exists and the scan is
        #    vacuous).
        lanes = np.full(n, LANE_HOLD, np.int32)
        lanes[admitted] = LANE_FRESH
        if not bank.all_closed:
            esc = (lanes == LANE_HOLD) & (bank.open_ticks_vec(t)
                                          >= svc.hold_fallback_after)
            lanes[esc] = LANE_FALLBACK
        return (cadence_skipped, bulkhead_skipped, queue_depth, shed,
                nr, admitted.astype(np.int64), scraped_ok,
                deferred, scrape_failed, probes, lanes)


    # -- one bounded tick ----------------------------------------------------

    def tick(self, t: int) -> "ServiceTickReport | object":
        if not self.svc.enabled:
            # The "off" gate: verbatim pre-service fleet behavior.
            return self.ctrl.tick(t)
        svc = self.svc
        with self.tracer.span("service.tick", t=t):
            t0 = self.clock()
            has_deadline = svc.tick_deadline_ms > 0.0
            deadline = (t0 + svc.tick_deadline_ms / 1e3
                        if has_deadline else math.inf)
            scrape_end = (t0 + svc.tick_deadline_ms
                          * svc.scrape_budget_frac / 1e3
                          if has_deadline else math.inf)

            # 1-5. the admission machine (cadence → bulkheads →
            #    cap/shed → bounded scrape → lanes): flat-array
            #    vectorized by default, the per-tenant object loop
            #    kept as the paired host_loop="object" baseline —
            #    bitwise-identical decisions on the det clock.
            off0 = self.clock.offset
            admit = (self._admit_object if self._host_loop == "object"
                     else self._admit_vectorized)
            (cadence_skipped, bulkhead_skipped, queue_depth, shed,
             n_ready, admitted, scraped_ok, deferred, scrape_failed,
             probes, lanes) = admit(t, scrape_end)
            self.sheds_total += shed
            self.last_lanes = lanes.copy()
            # Real host seconds the admission machine consumed: clock
            # delta minus the virtual scrape delay injected into it.
            host_adm_s = ((self.clock() - t0)
                          - (self.clock.offset - off0))

            # 6. ONE batched dispatch, lanes selected on device — or,
            #    chunked on the tenant axis, the SAME graph over k-tenant
            #    slices, per-chunk rows gathered on host so device output
            #    stays bounded by the chunk width (see _dispatch).
            with self.tracer.span("service.dispatch", t=t) as sp_d:
                packed_np, per_np = self._dispatch(t, lanes)

            # 7. bounded fan-out through the per-tenant reconcilers
            #    (priority order; open breakers bulkheaded; stragglers
            #    deferred at the tick deadline).
            with self.tracer.span("service.fanout", t=t) as sp_f:
                bank = self._brk
                applied = fanout_deferred = 0
                for pos, i in enumerate(self._order):
                    if bank.is_open(i):
                        # Not re-counted: either it was bulkheaded at
                        # scrape time (already in bulkhead_skipped) or
                        # it opened on THIS tick's scrape/probe failure
                        # (already in scrape_failed) — one tenant, one
                        # bucket per tick.
                        continue
                    # Only START a converge whose worst case (its own
                    # bounded deadline) still fits the tick budget,
                    # with one further converge-budget of headroom for
                    # host noise and post-loop accounting — stragglers
                    # defer rather than overshooting the deadline.
                    if self.clock() + 2.0 * self._converge_budget_s \
                            >= deadline:
                        rest = len(self._order) - pos
                        fanout_deferred += rest
                        self.deferrals_total += rest
                        break
                    a_i = unpack_action_row(
                        packed_np[i, :-1], self.ctrl._action_shapes,
                        self.ctrl._action_sizes)
                    is_peak = packed_np[i, -1] > 0.5
                    patches = render_nodepool_patches(
                        a_i, self.cfg.cluster,
                        op="add" if is_peak else "replace")
                    outcome = self._reconcilers[i].converge(patches)
                    if outcome.converged:
                        applied += 1
                        # A probe (or a plain tick) closes the breaker
                        # only when scrape AND actuation both held.
                        if scraped_ok[i]:
                            bank.record_success(i)
                    else:
                        self.actuation_giveups_total += 1
                        bank.record_failure(i, t)

            # 8. held rows advance for fresh lanes; accounting (masked
            #    — part of the host-loop window the µs/tenant gauge
            #    measures, like the admission machine above).
            acct0 = self.clock()
            aoff0 = self.clock.offset
            if admitted.size:
                a0 = int(admitted.min())
                a1 = int(admitted.max())
                if a1 - a0 + 1 == admitted.size:
                    # Distinct indices spanning exactly their range ARE
                    # that range (pigeonhole) — a strided copy instead
                    # of a gather/scatter pair. Uniform-priority fleets
                    # admit a contiguous prefix every calm tick.
                    sl = slice(a0, a1 + 1)
                    self._held[sl] = packed_np[sl, :-1]
                    self.tenant_fresh_ticks[sl] += 1
                else:
                    self._held[admitted] = packed_np[admitted, :-1]
                    self.tenant_fresh_ticks[admitted] += 1
            # In-place += casts f32 rows without materializing a f64
            # temporary (bitwise the old astype-then-add).
            self.tenant_cost_usd += per_np[:, 1]
            self.tenant_slo_ticks += per_np[:, 0]

            # 9. cadence degradation: sustained shedding doubles the
            #    stale-tolerant divisor (bounded); relief halves it.
            if shed > 0:
                self._sat_streak += 1
                if self._sat_streak >= svc.shed_backoff_after:
                    self._cadence_divisor = min(
                        self._cadence_divisor * 2, svc.cadence_backoff_max)
            else:
                self._sat_streak = 0
                if self._cadence_divisor > 1:
                    self._cadence_divisor //= 2
            self.cadence_skips_total += cadence_skipped
            self.bulkhead_skips_total += bulkhead_skipped
            host_loop_s = host_adm_s + ((self.clock() - acct0)
                                        - (self.clock.offset - aoff0))
            host_loop_us = max(host_loop_s, 0.0) * 1e6 / max(self.n, 1)

            # 10. incident-grade observation (`obs/`):
            #     burn windows, ring recording, trigger stamps and
            #     recorder dumps — host-side, strictly AFTER every
            #     decision this tick made (bitwise non-interference is
            #     pinned by the paired recorder-on/off test). Inside
            #     the span and before the final clock read, so the
            #     recorder's cost shows up in tick_latency_ms honestly
            #     instead of hiding between ticks.
            slo_burn = slo_burn_slow = 0.0
            incident_active = 0
            dec = tour = None
            if self.burn is not None:
                slo_burn, slo_burn_slow, incident_active, dec, tour = \
                    self._observe_tick(t, t0, lanes, shed, scraped_ok,
                                       per_np, packed_np, applied,
                                       deadline if has_deadline
                                       else None)

            latency_ms = (self.clock() - t0) * 1e3
        self.latencies_ms.append(latency_ms)
        # KPI aggregates come from the base metric block only — the
        # decision-provenance tail (shadow metrics + shadow
        # actions) must never leak into fleet sums (fleet.py idiom).
        agg = per_np[:, :4].sum(axis=0)
        dt_hr = float(np.float32(self.cfg.sim.dt_s)) / 3600.0
        report = ServiceTickReport(
            t=t,
            n_tenants=self.n,
            admitted=int(admitted.size),
            deferred=deferred,
            shed=shed,
            cadence_skipped=cadence_skipped,
            bulkhead_skipped=bulkhead_skipped,
            scrape_failed=scrape_failed,
            probes=probes,
            applied=applied,
            fanout_deferred=fanout_deferred,
            slo_ok=int(agg[0]),
            cost_usd_hr=float(agg[1]) / dt_hr,
            carbon_g_hr=float(agg[2]) / dt_hr,
            pending_pods=float(agg[3]),
            tick_latency_ms=round(latency_ms, 3),
            admission_queue_depth=queue_depth,
            sheds_total=self.sheds_total,
            deferrals_total=self.deferrals_total,
            breaker_transitions_total=self._brk.transitions_total(),
            cadence_divisor=self._cadence_divisor,
            decide_ms=round(sp_d.dur_ms, 3),
            fanout_ms=round(sp_f.dur_ms, 3),
            breaker_states=self._brk.states_dict(),
            host_loop_us_per_tenant=round(host_loop_us, 4),
            active_tenants=int(n_ready),
            slo_burn_rate=round(slo_burn, 6),
            slo_burn_rate_slow=round(slo_burn_slow, 6),
            incident_active=int(incident_active),
            incidents_total=(self.incidents.total
                             if self.incidents is not None else 0),
            recorder_dumps_total=(self.recorder.dumps_total
                                  if self.recorder is not None else 0),
            policy_divergence_rate=(dec or {}).get(
                "policy_divergence_rate"),
            objective_term_shares=(dec or {}).get(
                "objective_term_shares") or {},
            shadow_slo_delta=(dec or {}).get("shadow_slo_delta"),
            shadow_usd_delta=(dec or {}).get("shadow_usd_delta"),
            candidate_win_rate=(tour or {}).get("candidate_win_rate")
            or {},
            tournament_leader=(tour or {}).get("tournament_leader"),
            **self._perf_surfaces(),
            **self._geo_surfaces(),
        )
        self.log_fn(
            f"service t={t}: {report.admitted}/{self.n} fresh, "
            f"{report.shed} shed, {report.deferred} deferred, "
            f"{report.bulkhead_skipped} bulkheaded, "
            f"latency {report.tick_latency_ms:.1f}ms")
        return report

    def _perf_surfaces(self) -> dict:
        """The observatory gauges' tick fields: dict lookups
        only (no device work, no probes) — the obs layer's budget rules
        here exactly as they rule the recorder. With the obs layer off
        every field stays at its skip value."""
        if self.burn is None:  # the obs layer's hard "off" gate
            return {}
        from ccka_tpu_torch.obs import costmodel

        snap = costmodel.pipeline_snapshot() or {}
        return {
            "program_dispatches_total": costmodel.total_dispatches(),
            "achieved_roofline_fraction": snap.get("achieved_fraction"),
            "pipeline_occupancy": snap.get("occupancy") or {},
            "shard_imbalance": snap.get("shard_imbalance"),
        }

    def _geo_surfaces(self) -> dict:
        """Geo-arbitrage gauges: whatever rollout snapshot the geo
        overlay last published (`regions/geo.py::publish_geo_snapshot`,
        from `regions/pareto.py::run_geo_suite` and `geo`) — dict lookups
        only, the perf surfaces' budget rule and "off" gate. Before any
        publish both fields hold the skip value {} (the exporter then
        skips both series, never fake zeros)."""
        if self.burn is None:  # the obs layer's hard "off" gate
            return {}
        from ccka_tpu_torch.regions import geo as geo_dyn

        snap = geo_dyn.geo_snapshot() or {}
        return {
            "region_migration_rate": snap.get("migration_rate") or {},
            "region_carbon_intensity": snap.get("carbon_intensity") or {},
        }

    def _observe_tick(self, t: int, t0: float, lanes, shed: int,
                      scraped_ok, per_np, packed_np, applied: int,
                      deadline: "float | None"):
        """The tick's obs pass: update burn windows, append ring rows,
        record the decision ledger's rows, stamp one incident per
        trigger occurrence (breaker open, lane escalation, reconcile
        give-up, deadline overshoot, shed spike, divergence spike) and
        return the (fast burn, slow burn, incident_active, decision
        surfaces) report tuple. Every value recorded is a native host
        scalar — the recorder must never force a device transfer, and
        the dump codec (canonical JSON) would refuse numpy scalars
        anyway."""
        ob = self.obs
        n = self.n
        lat_pre_ms = (self.clock() - t0) * 1e3
        slo_ok_n = float(per_np[:, 0].sum())
        overshoot = deadline is not None and self.clock() > deadline
        self.burn.update("slo", n - slo_ok_n, n)
        self.burn.update("deadline", 1.0 if overshoot else 0.0, 1.0)
        self.burn.update("shed", float(shed), float(n))

        # Ring rows: one fleet-loop row + one per-tenant row per tick.
        # Flat scalars only — the rows are serialized 3x per dump
        # (canonical digest + envelope), so nesting here is dump cost.
        self.recorder.record(self._fleet_key, {
            "t": int(t), "shed": int(shed), "applied": int(applied),
            "latency_ms": round(lat_pre_ms, 3),
            "burn_slo_fast": round(self.burn.rate("slo", "fast"), 4),
            "burn_slo_slow": round(self.burn.rate("slo", "slow"), 4),
        })
        lvls = self._brk.levels()
        for i in range(n):
            self.recorder.record(i, {
                "t": int(t), "lane": int(lanes[i]),
                "breaker": int(lvls[i]),
                "scraped": bool(scraped_ok[i]),
            })

        # Triggers — exactly ONE stamp per occurrence (the incident
        # counting contract). Breaker opens
        # come off the breakers' own transition tallies; both the
        # scrape phase and the fan-out phase already happened, so the
        # tallies are final for this tick.
        opened = self._brk.opened_counts()
        for i in range(n):
            while self._prev_opened[i] < opened[i]:
                self._prev_opened[i] += 1
                self.incidents.stamp(
                    "breaker_open", t=t, tenant=i,
                    open_number=self._prev_opened[i],
                    state=_BREAKER_STATE[int(lvls[i])],
                    profile=self.profile_names[i])
        prev = self._prev_lanes
        for i in range(n):
            if lanes[i] == LANE_FALLBACK and (
                    prev is None or prev[i] != LANE_FALLBACK):
                self.incidents.stamp(
                    "hold_fallback", t=t, tenant=i,
                    open_ticks=int(self._brk.open_ticks(i, t)),
                    profile=self.profile_names[i])
        self._prev_lanes = lanes.copy()
        for i in self._giveups_this_tick:
            self.incidents.stamp("reconcile_giveup", t=t, tenant=i,
                                 profile=self.profile_names[i])
        self._giveups_this_tick.clear()
        if overshoot:
            self.incidents.stamp(
                "deadline_overshoot", t=t,
                latency_ms=round(lat_pre_ms, 3),
                deadline_ms=float(self.svc.tick_deadline_ms))
        if shed >= max(1, math.ceil(ob.shed_spike_frac * n)):
            self.incidents.stamp("shed_spike", t=t, shed=int(shed),
                                 n_tenants=n)

        # Decision provenance: record every tenant's row
        # from the shadow lanes the dispatch already computed; an
        # edge-triggered divergence spike stamps ONE policy_divergence
        # incident carrying its flight-recorder dump like every other
        # trigger. Host floats only — same budget discipline as the
        # recorder rows above.
        dec = None
        if self.decisions is not None:
            dec = self.decisions.observe_tick(
                t, per_np, packed_np, self._dec_layout, lanes=lanes)
            spike = dec.pop("spike", None)
            if spike is not None:
                self.incidents.stamp("policy_divergence", t=t, **spike)

        # Shadow tournament: score the candidate lanes the
        # dispatch already computed; a sustained challenger stamps ONE
        # edge-triggered challenger_sustained_win with its dump and
        # the signed promotion audit's evidence. Host floats only.
        tour = None
        if self.tournament is not None:
            tour = self.tournament.observe_tick(
                t, per_np, self._dec_layout, lanes=lanes)
            for ch in tour.get("challengers", ()):
                self.incidents.stamp("challenger_sustained_win", t=t,
                                     **ch)

        slo_burn = self.burn.rate("slo", "fast")
        slo_burn_slow = self.burn.rate("slo", "slow")
        last = self.incidents.last_tick()
        incident_active = int(
            self.burn.any_burning
            or (last is not None and t - last < ob.burn_fast_window))
        return slo_burn, slo_burn_slow, incident_active, dec, tour

    def run(self, ticks: int, start_tick: int = 0) -> list:
        """Sequential bounded ticks (the deadline is a per-tick host
        contract, so the fleet controller's dispatch pipelining does not
        apply — the dispatch itself is still a single device round
        trip)."""
        return [self.tick(t) for t in range(start_tick,
                                            start_tick + ticks)]

    # -- board accessors -----------------------------------------------------

    def breaker_transition_counts(self) -> dict:
        return self._brk.transition_counts()

    def chaos_injected(self) -> dict:
        """Summed injected-failure stats over chaos-wrapped tenant
        sinks (zeros when no tenant profile carries chaos)."""
        out = {"commands": 0, "timeouts": 0, "transient_exits": 0,
               "dropped": 0, "rewrites": 0}
        for snk in self.sinks:
            stats = getattr(snk, "stats", None)
            if stats:
                for k in out:
                    out[k] += stats.get(k, 0)
        return out

    def tenant_usd_per_slo_hr(self) -> np.ndarray:
        """Per-tenant $/SLO-hour over the run so far (the paired-ratio
        numerator/denominator of the overload board)."""
        dt_hr = float(np.float32(self.cfg.sim.dt_s)) / 3600.0
        slo_hr = self.tenant_slo_ticks * dt_hr
        return self.tenant_cost_usd / np.maximum(slo_hr, 1e-9)


def fleet_service_from_config(cfg: FrameworkConfig,
                              backend: PolicyBackend, n_tenants: int,
                              *, profiles: Sequence[str] | None = None,
                              service: ServiceConfig | None = None,
                              obs=None,
                              horizon_ticks: int = 2880, seed: int = 0,
                              clock: VirtualClock | None = None,
                              host_loop: str = "vectorized",
                              dispatch_chunk: "int | None" = None,
                              transport=None, device=None,
                              log_fn=None) -> FleetService:
    """Dry-run service wiring on ``device`` (the card unless
    ``device="cpu"``): N in-memory sinks over the synthetic source
    (per-tenant chaos wraps ride the profiles)."""
    from ccka_tpu_torch.actuation.sink import DryRunSink
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    device = resolve_device(device)
    source = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                   cfg.signals)
    sinks = [DryRunSink() for _ in range(n_tenants)]
    return FleetService(cfg, backend, source, sinks, profiles=profiles,
                        service=service, obs=obs,
                        horizon_ticks=horizon_ticks,
                        seed=seed, clock=clock, host_loop=host_loop,
                        dispatch_chunk=dispatch_chunk,
                        transport=transport, device=device, log_fn=log_fn)
