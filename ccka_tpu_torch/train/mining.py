"""Ledger-mined weakness cells: where the live policy is measurably weak.

The PyTorch port's form of `ccka_tpu/train/mining.py`; it is host
arithmetic over recorded JSONL files and touches no tensor, so its
scores, rounding and ranking are the JAX package's to the last digit.

The continual-learning flywheel (`train/flywheel.py`) needs a TARGET
before it can improve anything: which (scenario x intensity x
workload-class x tenant-regime) cells does the incumbent policy lose?
The answer lives in three observability surfaces:

- the decision ledger (`obs/decisions.py`): per-row objective-term
  attribution (cost/carbon/slo_pending/slo_violation/migration, shares
  summing to 1) plus the rule-shadow counterfactual; a row whose shadow
  objective BEATS the chosen one is a recorded regret;
- the tournament board (`obs/tournament.py`): per-workload-class win
  ledgers of every shadow candidate against the live policy; a class
  where a carbon heuristic out-wins the incumbent is a class the
  incumbent is weak in;
- the incident log (`obs/incidents.py`): declared, edge-triggered
  anomalies (slo_burn, policy_divergence, ...).

:func:`mine_weakness_cells` folds all three into one deterministic
ranking, maps workload-class pressure onto the hand-named scenario
library via :data:`CLASS_SCENARIOS`, and lets minted adversarial
scenarios (a search-found worst case is a weakness by construction)
join the candidate set through `workloads/scenarios.
load_minted_scenarios`. :func:`curriculum_from_cells` turns the ranked
cells into the weakness-weighted pair allocation the factory consumes,
and :func:`curriculum_digest` pins the allocation under sha256 so a
challenger's provenance can prove which curriculum trained it.

Everything here is stdlib + json arithmetic: no torch, no device work,
deterministic for a fixed set of input files (ties rank by name).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

# The per-class pressure → scenario mapping: which hand-named scenarios
# exercise each workload class hardest (`workloads/scenarios.py` rate
# sizing). Inference pressure drills flash crowds before the calm
# diurnal profile; batch pressure drills the backfill waves; background
# pressure (cost/waste-driven) drills the all-three composite.
CLASS_SCENARIOS: dict[str, tuple[str, ...]] = {
    "inference": ("flash-crowd", "diurnal-inference"),
    "batch": ("batch-backfill",),
    "background": ("mixed",),
}

# The tenant regimes the decision ledger can attribute rows to without
# any side table: the exo is_peak flag splits every row stream into the
# two demand regimes the paper's rule profiles are hand-tuned around.
TENANT_REGIMES = ("peak", "offpeak")

# Objective-term → workload-class attribution for the ledger's pending
# split (`objective_terms` prices pend_c0/pend_c1 separately): class 0
# is the latency-sensitive inference queue, class 1 the deadline batch
# pipeline; the violation term rides the inference SLO; cost and carbon
# pressure land on the best-effort background floor.
_TERM_CLASS = {"class0": "inference", "class1": "batch"}

# Minted adversarial scenarios outrank every same-evidence hand-named
# cell: the search PROVED the policy loses there (its dominance gate),
# the ledger only suggests it.
MINTED_SCORE_BONUS = 1.5


@dataclass(frozen=True)
class WeaknessCell:
    """One ranked training target: a (scenario, intensity) factory cell
    carrying the workload-class and tenant-regime evidence that put it
    on the curriculum."""

    scenario: str
    intensity: str
    workload_class: str
    tenant_regime: str
    score: float
    evidence: dict = field(default_factory=dict)

    def key(self) -> tuple:
        return (self.scenario, self.intensity)


def _class_pressure(decision_rows: list[dict]) -> tuple[dict, dict, dict]:
    """(per-class share, per-regime shadow regret, totals) from the
    decision ledger's attribution rows."""
    cls_sum = {"inference": 0.0, "batch": 0.0, "background": 0.0}
    regret = dict.fromkeys(TENANT_REGIMES, 0.0)
    totals = {"rows": 0, "diverged": 0, "regret_rows": 0}
    for row in decision_rows:
        obj = row.get("objective")
        if not isinstance(obj, dict):
            continue
        totals["rows"] += 1
        shares = obj.get("shares", {})
        by_class = obj.get("by_class", {})
        # Split the pending share by the ledger's own class split; the
        # violation share rides inference, cost+carbon ride background.
        pend_total = sum(by_class.get(k, 0.0) for k in _TERM_CLASS) or 1.0
        for k, cls in _TERM_CLASS.items():
            cls_sum[cls] += (shares.get("slo_pending", 0.0)
                             * by_class.get(k, 0.0) / pend_total)
        cls_sum["inference"] += shares.get("slo_violation", 0.0)
        cls_sum["background"] += (shares.get("cost", 0.0)
                                  + shares.get("carbon", 0.0)) * 0.25
        sh = row.get("shadow", {})
        if isinstance(sh, dict):
            d = (obj.get("total", 0.0)
                 - sh.get("objective", {}).get("total", 0.0))
            if sh.get("diverged"):
                totals["diverged"] += 1
            if d > 0.0:  # the rule shadow beat the live policy here
                regime = ("peak" if row.get("exo", {}).get("is_peak")
                          else "offpeak")
                regret[regime] += d
                totals["regret_rows"] += 1
    n = max(totals["rows"], 1)
    cls_share = {c: v / n for c, v in cls_sum.items()}
    return cls_share, regret, totals


def _class_losses(tournament_rows: list[dict]) -> tuple[dict, dict]:
    """Per-class incumbent loss rate from the LAST tournament board row:
    the max over candidates of each class's win rate against the live
    policy (any candidate winning a class is the incumbent losing it)."""
    boards = [r for r in tournament_rows
              if isinstance(r, dict) and r.get("kind") == "board"]
    losses = {"inference": 0.0, "batch": 0.0, "background": 0.0}
    meta = {"board_rows": len(boards), "window_ticks": 0}
    if not boards:
        return losses, meta
    last = boards[-1]
    meta["window_ticks"] = int(last.get("window_ticks") or 0)
    for cand in (last.get("board") or {}).values():
        for cls, cell in (cand.get("classes") or {}).items():
            rate = cell.get("win_rate")
            if cls in losses and rate is not None:
                losses[cls] = max(losses[cls], float(rate))
    return losses, meta


def _incident_pressure(incident_rows: list[dict]) -> tuple[float, dict]:
    """Flat urgency multiplier from declared incidents: every stamped
    anomaly scales the whole ranking up (the flywheel should train
    HARDER after a bad window), saturating so one incident storm cannot
    drown the per-class structure."""
    counts: dict[str, int] = {}
    for rec in incident_rows:
        trig = rec.get("trigger")
        if isinstance(trig, str):
            counts[trig] = counts.get(trig, 0) + 1
    total = sum(counts.values())
    return min(1.0 + 0.1 * total, 2.0), {"counts": counts, "total": total}


def mine_weakness_cells(*, decisions_path: str = "",
                        tournament_path: str = "",
                        incidents_path: str = "",
                        minted_dir: str = "",
                        intensities: tuple = ("off", "moderate"),
                        top_k: int = 6) -> list[WeaknessCell]:
    """Rank weakness cells from the three recorded surfaces (any subset
    may be absent — "" skips it; an empty mine still returns the
    library floor so a cold-start flywheel has a curriculum).

    Deterministic: scores are pure arithmetic over the input files and
    ties break lexicographically on (scenario, intensity)."""
    from ccka_tpu_torch.obs.decisions import read_decisions
    from ccka_tpu_torch.obs.incidents import read_incidents
    from ccka_tpu_torch.obs.tournament import read_tournament
    from ccka_tpu_torch.workloads.scenarios import load_minted_scenarios

    cls_share, regret, led_totals = _class_pressure(
        read_decisions(decisions_path) if decisions_path else [])
    losses, board_meta = _class_losses(
        read_tournament(tournament_path) if tournament_path else [])
    urgency, inc_meta = _incident_pressure(
        read_incidents(incidents_path) if incidents_path else [])
    regret_total = sum(regret.values())
    worst_regime = max(TENANT_REGIMES,
                       key=lambda r: (regret[r], r == "peak"))

    cells: list[WeaknessCell] = []
    for cls, scenarios in CLASS_SCENARIOS.items():
        # The class score: ledger attribution share + tournament loss
        # rate + the regret mass the shadow recorded, all scaled by
        # incident urgency. The floor term keeps a zero-evidence class
        # on the board (never train a curriculum with a dead class —
        # that is how off-curriculum regressions start).
        base = (cls_share.get(cls, 0.0) + losses.get(cls, 0.0)
                + 0.25 * regret_total / max(led_totals["rows"], 1))
        score = urgency * (0.05 + base)
        for rank, scenario in enumerate(scenarios):
            for ii, intensity in enumerate(intensities):
                # Deeper intensities weigh slightly higher inside one
                # class (fault weather is where weak policies crack),
                # later scenarios slightly lower (CLASS_SCENARIOS
                # orders each class's scenarios hardest-first).
                cells.append(WeaknessCell(
                    scenario=scenario, intensity=intensity,
                    workload_class=cls, tenant_regime=worst_regime,
                    score=round(score * (1.0 + 0.1 * ii)
                                * (1.0 - 0.15 * rank), 9),
                    evidence={
                        "class_share": round(cls_share.get(cls, 0.0), 9),
                        "tournament_loss_rate": losses.get(cls, 0.0),
                        "shadow_regret": {k: round(v, 9)
                                          for k, v in regret.items()},
                        "urgency": urgency,
                        "ledger": led_totals, "board": board_meta,
                        "incidents": inc_meta,
                    }))
    if minted_dir:
        minted = load_minted_scenarios(minted_dir)  # digest-verified
        top = max((c.score for c in cells), default=0.05)
        for name in sorted(minted):
            sc = minted[name]
            cells.append(WeaknessCell(
                scenario=name, intensity="off",
                workload_class="inference", tenant_regime=worst_regime,
                score=round(top * MINTED_SCORE_BONUS, 9),
                evidence={"minted_by": sc.minted_by,
                          "params_digest": sc.params_digest,
                          "urgency": urgency}))
    cells.sort(key=lambda c: (-c.score, c.scenario, c.intensity))
    return cells[:max(int(top_k), 1)]


def curriculum_from_cells(cells: list[WeaknessCell], *,
                          pairs_base: int = 8,
                          pairs_max: int = 64) -> list[dict]:
    """Ranked cells → the weakness-weighted factory allocation: each
    distinct (scenario, intensity) gets MPC-teacher pairs proportional
    to its summed score, floored at ``pairs_base`` and capped at
    ``pairs_max`` (a runaway score must not starve every other cell).
    Deterministic integer allocation, insertion-ordered by rank."""
    if not cells:
        raise ValueError("empty weakness-cell list — mine first "
                         "(mine_weakness_cells returns the library "
                         "floor even with no evidence files)")
    merged: dict[tuple, dict] = {}
    for c in cells:
        row = merged.setdefault(c.key(), {
            "scenario": c.scenario, "intensity": c.intensity,
            "score": 0.0, "classes": [], "tenant_regime": c.tenant_regime})
        row["score"] = round(row["score"] + c.score, 9)
        if c.workload_class not in row["classes"]:
            row["classes"].append(c.workload_class)
    top = max(row["score"] for row in merged.values()) or 1.0
    out = []
    for row in merged.values():
        pairs = int(round(pairs_base
                          + (pairs_max - pairs_base) * row["score"] / top))
        out.append({**row, "pairs": max(min(pairs, pairs_max),
                                        pairs_base)})
    return out


def curriculum_digest(curriculum: list[dict]) -> str:
    """sha256 over the canonical curriculum JSON — the provenance pin
    (`train/flywheel.py` refuses a challenger whose recorded curriculum
    does not hash to the digest its provenance states)."""
    blob = json.dumps(curriculum, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()
