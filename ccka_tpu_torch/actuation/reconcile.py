"""Desired-state reconciliation: one-shot apply_all becomes convergence.

The PyTorch port's form of `ccka_tpu/actuation/reconcile.py`: a copy: host code, no tensors.

The base sink's ``apply_all`` is fire-once: a kubectl timeout, a dropped
patch or an admission rewrite leaves the cluster silently diverged from
the rendered intent, and the reference's answer was a human re-running
`demo_20_offpeak_configure.sh`. The :class:`Reconciler` is that re-run as
code, with the discipline a controller daemon needs:

- **apply → read back → compare** per pool, against the RENDERED intent
  (never against what we meant to send) — the `ConfigureObserve` oracle
  skepticism (`harness/lifecycle.py`, `demo_20_offpeak_observe.sh:8-27`);
- **deadline-bounded retry rounds** with seeded-jitter exponential
  backoff — only still-diverged pools are re-applied, so a converged
  pool is never touched twice (idempotent actuation: patches carry full
  desired state, so a re-apply after a crash is safe but a gratuitous
  one is still avoided);
- **bounded give-up**: when rounds/deadline run out, the outcome lists
  the diverged pools and per-pool divergence counts instead of raising —
  the controller folds that into its degraded-mode state machine
  (`harness/controller.py`, ARCHITECTURE §12/§14) and the loop lives on.

Harness code never calls ``sink.apply_all`` directly anymore — the AST
guard in `tests/test_torch_timing_guard.py` pins that every actuation path in
`ccka_tpu/harness/` routes through ``Reconciler.converge``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Sequence

from ccka_tpu_torch.actuation.patches import NodePoolPatchSet
from ccka_tpu_torch.actuation.sink import ActuationSink, ApplyResult


def verify_pool(observed: dict, ps: NodePoolPatchSet) -> bool:
    """Rendered intent vs sink read-back (never vs what we meant to
    send). Moved here from `harness/controller.py` so the reconciler and
    the controller share ONE definition of 'converged'."""
    want_policy = ps.disruption_merge["spec"]["disruption"][
        "consolidationPolicy"]
    if observed.get("consolidationPolicy") != want_policy:
        return False
    want = {r["key"]: r["values"] for r in ps.requirements_json[0]["value"]}
    if observed.get("capacity_types") != want.get(
            "karpenter.sh/capacity-type"):
        return False
    if observed.get("zones") != want.get("topology.kubernetes.io/zone"):
        return False
    return True


@dataclasses.dataclass
class ReconcileOutcome:
    """What one convergence attempt achieved."""

    results: list[ApplyResult]        # final per-pool results, input order
    converged: bool                   # every pool applied AND read back ok
    rounds: int                       # apply rounds run (>= 1)
    retries: int                      # re-apply attempts beyond round 1
    failures: int                     # failed applies + failed read-backs
    diverged: tuple[str, ...]         # pools still diverged at give-up
    divergence: dict = dataclasses.field(default_factory=dict)  # pool -> n


class Reconciler:
    """Converge a sink onto a rendered desired state.

    ``max_rounds``/``deadline_s`` bound the attempt (whichever trips
    first); ``backoff_s`` doubles per round with multiplicative jitter in
    [1-jitter, 1+jitter) from a seeded RNG (deterministic for paired
    runs; thundering-herd-safe for fleet fan-outs). ``sleep_fn``/``clock``
    are injectable for tests.

    ``on_giveup`` is the incident hook: called ONCE per
    give-up — a converge that returns with pools still diverged — with
    the :class:`ReconcileOutcome`, AFTER the outcome is fully built and
    the session counters are updated, so the observer sees exactly what
    the caller will. The give-up trigger lives HERE, at the layer that
    defines "gave up", rather than being re-derived at every call site
    (`obs/incidents.py` stamps the record; the hook must never raise
    into the control loop — a broken observer is logged by its owner,
    not allowed to kill actuation).
    """

    def __init__(self, sink: ActuationSink, *,
                 max_rounds: int = 3,
                 backoff_s: float = 0.05,
                 deadline_s: float = 5.0,
                 jitter: float = 0.5,
                 seed: int = 0,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 on_giveup: "Callable[[ReconcileOutcome], None] | None"
                 = None):
        if max_rounds < 1:
            raise ValueError("reconciler: max_rounds must be >= 1")
        self.sink = sink
        self.max_rounds = max_rounds
        self.backoff_s = backoff_s
        self.deadline_s = deadline_s
        self.jitter = jitter
        self._rng = random.Random(seed)
        self.sleep_fn = sleep_fn
        self.clock = clock
        self.on_giveup = on_giveup
        # Session counters (the promexport _total sources).
        self.retries_total = 0
        self.failures_total = 0
        self.giveups_total = 0
        self.hook_errors = 0

    def converge(self, patchsets: Sequence[NodePoolPatchSet]
                 ) -> ReconcileOutcome:
        order = [ps.pool for ps in patchsets]
        pending: dict[str, NodePoolPatchSet] = {ps.pool: ps
                                                for ps in patchsets}
        results: dict[str, ApplyResult] = {}
        divergence: dict[str, int] = {}
        retries = failures = rounds = 0
        t_end = self.clock() + self.deadline_s
        while pending and rounds < self.max_rounds:
            if rounds:
                pause = (self.backoff_s * (2 ** (rounds - 1))
                         * (1.0 + self.jitter * (2.0 * self._rng.random()
                                                 - 1.0)))
                if self.clock() + pause >= t_end:
                    break        # no budget left for another round
                self.sleep_fn(pause)
            for pool, ps in list(pending.items()):
                r = self.sink.apply_nodepool(ps)
                results[pool] = r
                if rounds:
                    retries += 1
                ok = r.ok and verify_pool(
                    self.sink.observed_state(ps.pool), ps)
                if ok:
                    pending.pop(pool)
                else:
                    failures += 1
                    divergence[pool] = divergence.get(pool, 0) + 1
            rounds += 1
            if self.clock() >= t_end:
                break
        self.retries_total += retries
        self.failures_total += failures
        outcome = ReconcileOutcome(
            results=[results[p] for p in order],
            converged=not pending,
            rounds=rounds,
            retries=retries,
            failures=failures,
            diverged=tuple(pending),
            divergence=divergence,
        )
        if pending:
            self.giveups_total += 1
            if self.on_giveup is not None:
                # Enforced here, not merely documented: a broken
                # observer (full disk under the incident log, a buggy
                # hook) must never abort the actuation it observes.
                try:
                    self.on_giveup(outcome)
                except Exception as e:  # noqa: BLE001 — backstop
                    self.hook_errors += 1
                    if self.hook_errors == 1:
                        import sys
                        print(f"# reconciler on_giveup hook raised "
                              f"({e!r}); suppressed — further hook "
                              "errors counted in hook_errors",
                              file=sys.stderr)
        return outcome
