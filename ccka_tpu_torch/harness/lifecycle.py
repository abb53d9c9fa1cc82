"""Paired configure/observe stages — the reference's test discipline as code.

The PyTorch port's form of `ccka_tpu/harness/lifecycle.py`: a copy: host code, no tensors.

Every mutating stage in the reference ships with a read-only observer that
asserts post-state (`demo_10/20/21/30/40/50_{configure,observe}.sh`,
SURVEY.md §4 pattern 1). :class:`ConfigureObserve` makes that a first-class
object: ``apply()`` mutates through a sink, ``verify()`` reads back and
compares against the expected oracle (the printed expectation of
`demo_21_peak_observe.sh:18`), and ``run()`` does both with the reference's
apply→verify→fallback contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ccka_tpu_torch.actuation.patches import NodePoolPatchSet
from ccka_tpu_torch.actuation.reconcile import Reconciler
from ccka_tpu_torch.actuation.sink import ActuationSink, ApplyResult


@dataclass
class Stage:
    """A named lifecycle stage with its expected post-state oracle."""

    name: str
    patchsets: Sequence[NodePoolPatchSet]
    # oracle: pool name -> expected (consolidationPolicy, capacity-type values)
    expect: dict[str, tuple[str, list[str]]] = field(default_factory=dict)


class ConfigureObserve:
    """apply() + verify() over a sink, demo_2X_{configure,observe} style.

    ``rounds`` > 1 upgrades apply() from the reference's one-shot to
    reconciled convergence (actuation/reconcile.py) — the default stays
    1 so stage semantics (one apply pass, then the oracle check) are
    unchanged; either way actuation routes through the Reconciler, which
    the harness-wide AST guard requires.
    """

    def __init__(self, sink: ActuationSink, *, rounds: int = 1):
        self.sink = sink
        self._reconciler = Reconciler(sink, max_rounds=rounds,
                                      backoff_s=0.01)

    def apply(self, stage: Stage) -> list[ApplyResult]:
        return self._reconciler.converge(stage.patchsets).results

    def verify(self, stage: Stage) -> list[tuple[str, bool, str]]:
        """Read back each pool FROM THE SINK against the stage oracle —
        never from the intended patches, so a sink that silently dropped or
        mangled a mutation (mismatched schema path, admission webhook
        rewrite) fails verification. The same skepticism as the reference's
        jsonpath re-reads (`demo_20_offpeak_observe.sh:8-27`)."""
        out = []
        for ps in stage.patchsets:
            want = stage.expect.get(ps.pool)
            if want is None:
                out.append((ps.pool, True, "no oracle"))
                continue
            policy_want, cts_want = want
            observed = self.sink.observed_state(ps.pool)
            got_policy = observed.get("consolidationPolicy", "")
            got_cts = observed.get("capacity_types", [])
            ok = got_policy == policy_want and got_cts == cts_want
            detail = (f"observed policy={got_policy!r} cts={got_cts}"
                      if not ok else "")
            out.append((ps.pool, ok, detail))
        return out

    def run(self, stage: Stage) -> bool:
        applied = self.apply(stage)
        verified = self.verify(stage)
        return all(r.ok for r in applied) and all(ok for _, ok, _ in verified)
