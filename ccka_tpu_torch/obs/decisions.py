"""Decision provenance: per-tick objective attribution + rule-shadow
counterfactuals (round 18).

The PyTorch form of `ccka_tpu/obs/decisions.py`: the layout and the host
half are the JAX package's, byte for byte in what they write; the device
half (:func:`shadow_decision_columns`) works on tensors and runs inside
the fleet tick (`harness/fleet.py`), captured into its CUDA graph on the
card.

Three observability rounds taught the repo to say *when* a decision
happened (trace spans, r7), *that* it went wrong (incidents, r14) and
*how fast* it ran (device-time observatory, r15) — but never *why*: no
decomposition of the step objective into the cost/carbon/SLO terms the
paper's whole pitch trades against, and no measure of where the learned
policy actually departs from the rule baseline. This module is that
ledger:

- **per-term objective attribution** — every recorded decide carries
  the `train/objective.step_cost` scalarization split into its terms
  (node cost, carbon price, per-workload-class pending, SLO-violation
  price), with shares summing to 1 by construction on every row.
- **batched rule-shadow counterfactual** — the rule profile evaluated
  on the SAME observed (possibly stale) exo and the SAME state
  estimate, as extra output lanes of the one lane-selecting batched
  tick (`harness/fleet._compiled_fleet_tick`): no second launch, no
  second capture, and — because the shadow lanes are computed whether
  or not a ledger exists — toggling the ledger can never select a
  different graph. Non-interference holds by construction and is
  re-proven bitwise by the tests and the chip smoke.
- **divergence drift gauges + the `policy_divergence` trigger** — a
  windowed shadow-disagreement rate (`ccka_policy_divergence_rate`),
  fleet objective-term shares (`ccka_objective_term_share`) and the
  projected chosen-minus-shadow SLO delta (`ccka_shadow_slo_delta`);
  the rate crossing `obs.divergence_spike_rate` from below stamps ONE
  edge-triggered `policy_divergence` incident with its flight-recorder
  dump.

Split of labor: the ``shadow_decision_columns`` helper is the DEVICE
side (called inside the compiled ticks); :class:`DecisionLedger` is
the HOST side — plain-float recording strictly after each tick's
decisions, the flight-recorder discipline. `ccka decisions
list|show|explain` renders a tick's "why" from the JSONL this ledger
writes.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from ccka_tpu_torch.config import ObsConfig, TrainConfig
from ccka_tpu_torch.sim.types import CT_OD, CT_SPOT, Action

# The objective terms of `train/objective.step_cost`, in J order:
#   J = cost + carbon_weight*gCO2 + slo_weight*pending
#       + slo_violation_weight*(1 - slo_ok)
#       [+ migration_weight*migration_cost_usd]   (geo overlay).
# "migration" is always present in the decomposition (0.0 on every
# non-geo tick — the zero-migration neutral contract), so `term_shares`
# keys are stable across rounds and still sum to 1.
TERM_NAMES = ("cost", "carbon", "slo_pending", "slo_violation",
              "migration")

# Leading per-cluster metric columns of the batched ticks
# (`harness/fleet.per_cluster_metrics`): slo_ok, cost, carbon, pending.
N_BASE_METRIC_COLS = 4

# Device-emitted decision columns, appended after the base metric
# block by `shadow_decision_columns` (order is the layout contract):
# the state estimate the row explains, the chosen per-class pending,
# the OBSERVED exo the policy saw, the rule shadow's step metrics on
# the same inputs, and the chosen-vs-shadow action divergence.
DECISION_COLS = (
    "nodes_spot", "nodes_od",              # state estimate (post-step)
    "pend_c0", "pend_c1",                  # chosen pending, per class
    "exo_spot_price_hr", "exo_od_price_hr",  # observed exo (zone mean)
    "exo_carbon_g_kwh", "exo_demand_pods", "exo_is_peak",
    "shadow_cost_usd", "shadow_carbon_g",  # rule shadow, same inputs
    "shadow_pend_c0", "shadow_pend_c1", "shadow_slo_ok",
    "div_max_abs", "div_l2",               # action divergence
)

# Decision-lane names shared with `harness/service` (LANE_FRESH=0,
# LANE_HOLD=1, LANE_FALLBACK=2); index-aligned by contract.
LANE_NAMES = ("fresh", "hold", "fallback")

# Per-candidate tournament columns (round 20, `obs/tournament.py`):
# appended once per roster candidate after the shadow action, each
# block followed by that candidate's per-region zone-weight lean
# shares. Same contract style as DECISION_COLS — the order IS the
# layout.
CAND_COLS = (
    "cand_cost_usd", "cand_carbon_g",      # candidate's projected step
    "cand_pend_c0", "cand_pend_c1",        # per-class pending
    "cand_slo_ok",                         # projected SLO gate
    "cand_div_max",                        # max|cand - chosen| action delta
)


def action_dim(cluster) -> int:
    """Flat length A of one packed action row (is_peak excluded),
    derived from a template Action so it tracks the NamedTuple."""
    t = Action.neutral(cluster.n_pools, cluster.n_zones, device="cpu")
    return int(sum(int(np.prod(leaf.shape)) for leaf in t))


def flat_action_names(cluster) -> list[str]:
    """Component names of the flat action vector, in pack order —
    what `ccka decisions explain` labels the divergence deltas with."""
    t = Action.neutral(cluster.n_pools, cluster.n_zones, device="cpu")
    names: list[str] = []
    for field, leaf in zip(Action._fields, t):
        shape = tuple(leaf.shape)
        for idx in np.ndindex(*(shape or (1,))):
            suffix = "".join(f"[{i}]" for i in idx) if shape else ""
            names.append(f"{field}{suffix}")
    return names


class DecisionRowLayout:
    """Column offsets of one widened per-cluster metric row
    ``[base metrics | decision cols | shadow flat action |
    tournament tail]`` — the single definition both compiled-tick
    builders and the host ledgers slice by, so they can never drift
    apart.

    ``candidates`` (round 20, `obs/tournament.py`) names the shadow-
    tournament roster riding the tick: with K candidates the row grows
    a per-region grid-carbon block (R = cluster.n_regions columns)
    followed by one ``CAND_COLS`` block + R region lean-share columns
    per candidate, in roster order. K=0 (the default everywhere the
    tournament is not configured) is EXACTLY the round-18 layout — the
    compiled programs of untouched configs cannot change."""

    def __init__(self, cluster, candidates: Sequence[str] = ()):
        self.a_dim = action_dim(cluster)
        self.base = slice(0, N_BASE_METRIC_COLS)
        self.cols = slice(N_BASE_METRIC_COLS,
                          N_BASE_METRIC_COLS + len(DECISION_COLS))
        self.shadow_action = slice(
            self.cols.stop, self.cols.stop + self.a_dim)
        self.candidates = tuple(candidates)
        self.n_regions = int(cluster.n_regions)
        off = self.shadow_action.stop
        self._cand_off: dict[str, int] = {}
        self.region_carbon = slice(off, off)  # empty without a roster
        if self.candidates:
            self.region_carbon = slice(off, off + self.n_regions)
            off = self.region_carbon.stop
            for name in self.candidates:
                self._cand_off[name] = off
                off += len(CAND_COLS) + self.n_regions
        self.width = off

    def col(self, name: str) -> int:
        return N_BASE_METRIC_COLS + DECISION_COLS.index(name)

    def cand_col(self, cand: str, name: str) -> int:
        """Column of one candidate's CAND_COLS entry."""
        return self._cand_off[cand] + CAND_COLS.index(name)

    def cand_lean(self, cand: str) -> slice:
        """One candidate's per-region zone-weight lean-share columns."""
        lo = self._cand_off[cand] + len(CAND_COLS)
        return slice(lo, lo + self.n_regions)


def decision_row_layout(cluster,
                        candidates: Sequence[str] = ()
                        ) -> DecisionRowLayout:
    return DecisionRowLayout(cluster, candidates)


def shadow_decision_columns(chosen_metrics, shadow_metrics, exo_n,
                            flat_chosen, flat_shadow) -> torch.Tensor:
    """The DEVICE half: [N, len(DECISION_COLS)] columns from one
    batched tick's chosen-vs-shadow step outputs (both StepMetrics with
    the cluster axis in front). Runs INSIDE the fleet tick — extra lanes
    of the same launch chain (and CUDA graph), never their own."""
    pend = torch.clamp(
        chosen_metrics.demand_pods - chosen_metrics.served_pods, min=0.0)
    spend = torch.clamp(
        shadow_metrics.demand_pods - shadow_metrics.served_pods, min=0.0)
    diff = flat_chosen - flat_shadow
    return torch.stack([
        chosen_metrics.nodes_by_ct[..., CT_SPOT],
        chosen_metrics.nodes_by_ct[..., CT_OD],
        pend[..., 0], pend[..., 1],
        exo_n.spot_price_hr.mean(dim=-1),
        exo_n.od_price_hr.mean(dim=-1),
        exo_n.carbon_g_kwh.mean(dim=-1),
        exo_n.demand_pods.sum(dim=-1),
        exo_n.is_peak.to(torch.float32),
        shadow_metrics.cost_usd,
        shadow_metrics.carbon_g,
        spend[..., 0], spend[..., 1],
        shadow_metrics.slo_ok.to(torch.float32),
        torch.amax(torch.abs(diff), dim=-1),
        torch.sqrt(torch.sum(diff * diff, dim=-1)),
    ], dim=-1)


# -- host-side objective decomposition ---------------------------------------


def objective_terms(tcfg: TrainConfig, *, cost_usd: float,
                    carbon_g: float, pend_c0: float, pend_c1: float,
                    slo_ok: float,
                    migration_cost_usd: float = 0.0) -> tuple[dict, dict]:
    """One tick's `step_cost` split into its priced terms (host
    floats), plus the per-workload-class split of the pending term —
    the family axis the aggregate number hides. Term sum equals
    `step_cost` by construction (same weights, same clamps).

    ``migration_cost_usd`` is the geo overlay's transfer-dollar tick
    total (`regions/geo.py`); it defaults to 0.0 so every pre-geo row
    decomposes identically while the "migration" key stays present
    (TERM_NAMES is the stable share contract)."""
    terms = {
        "cost": float(cost_usd),
        "carbon": float(tcfg.carbon_weight) * float(carbon_g),
        "slo_pending": float(tcfg.slo_weight)
        * (float(pend_c0) + float(pend_c1)),
        "slo_violation": float(tcfg.slo_violation_weight)
        * (1.0 - float(slo_ok)),
        "migration": float(tcfg.migration_weight)
        * float(migration_cost_usd),
    }
    by_class = {
        "class0": float(tcfg.slo_weight) * float(pend_c0),
        "class1": float(tcfg.slo_weight) * float(pend_c1),
    }
    return terms, by_class


def term_shares(terms: Mapping) -> dict:
    """Attribution shares (sum to 1 whenever the objective is
    positive, which it always is with a base nodegroup priced in —
    empty on a zero objective rather than fake uniform shares)."""
    total = float(sum(terms.values()))
    if total <= 0.0:
        return {}
    return {k: float(v) / total for k, v in terms.items()}


# -- the ledger --------------------------------------------------------------


class DecisionLedger:
    """Host-side per-tick decision rows + divergence drift gauges.

    Strictly-after-decisions recording in the flight-recorder idiom:
    every value is a native host scalar, JSONL appends are flushed per
    tick, and I/O failures degrade the RECORD (counted, stderr note
    once), never the control loop. The in-memory tail is retention-
    bounded like the service's latency deque; the JSONL is the full
    history `ccka decisions` reads.
    """

    def __init__(self, obs: ObsConfig, tcfg: TrainConfig, *,
                 policy: str = "", rows_retained: int = 4096):
        self.obs = obs
        self.tcfg = tcfg
        self.policy = policy
        self.rows: "collections.deque[dict]" = collections.deque(
            maxlen=rows_retained)
        self.rows_total = 0
        self.spikes_total = 0
        self.diverged_total = 0
        self.shadow_usd_delta_total = 0.0
        self.io_errors = 0
        # (diverged, decides) per tick over the trailing window.
        self._window: "collections.deque[tuple[int, int]]" = \
            collections.deque(maxlen=obs.decision_window)
        self._above = False  # edge-trigger arm for the spike
        self._fh = None
        self.path = obs.decision_log_path or ""
        if self.path:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    # -- one tick ------------------------------------------------------------

    def observe_tick(self, t: int, per_np: np.ndarray,
                     packed_np: np.ndarray, layout: DecisionRowLayout,
                     *, lanes: Sequence | None = None) -> dict:
        """Record one batched tick's rows from the widened per-cluster
        metric block (``per_np`` [N, layout.width]) and the packed
        action rows (``packed_np`` [N, A+1], is_peak last); returns the
        tick's report surfaces (divergence rate, fleet term shares,
        shadow deltas, and the spike record when one fired)."""
        n = per_np.shape[0]
        # Column offsets hoisted once — layout.col is a linear scan
        # over DECISION_COLS, and this loop runs N times per tick on
        # the host path the 5%-of-p50 budget prices.
        (c_pc0, c_pc1, c_sp, c_op, c_cb, c_dm, c_pk, c_sc, c_scb,
         c_spc0, c_spc1, c_sok, c_dmax, c_dl2, c_ns, c_no) = (
            layout.col(name) for name in (
                "pend_c0", "pend_c1", "exo_spot_price_hr",
                "exo_od_price_hr", "exo_carbon_g_kwh",
                "exo_demand_pods", "exo_is_peak", "shadow_cost_usd",
                "shadow_carbon_g", "shadow_pend_c0", "shadow_pend_c1",
                "shadow_slo_ok", "div_max_abs", "div_l2",
                "nodes_spot", "nodes_od"))
        fleet_terms = {k: 0.0 for k in TERM_NAMES}
        slo_delta = 0.0
        usd_delta = 0.0
        diverged = 0
        thr = self.obs.divergence_threshold
        # Python floats once for the block: each is the float32's exact
        # value, as float() of a numpy scalar gives it, at a fraction of
        # the per-element cost.
        rows = np.asarray(per_np).tolist()
        actions = np.asarray(packed_np)[:, :layout.a_dim].tolist()
        for i in range(n):
            row = rows[i]
            lane_i = int(lanes[i]) if lanes is not None else 0
            terms, by_class = objective_terms(
                self.tcfg,
                cost_usd=row[1], carbon_g=row[2],
                pend_c0=row[c_pc0], pend_c1=row[c_pc1],
                slo_ok=row[0])
            sh_terms, sh_by_class = objective_terms(
                self.tcfg,
                cost_usd=row[c_sc],
                carbon_g=row[c_scb],
                pend_c0=row[c_spc0],
                pend_c1=row[c_spc1],
                slo_ok=row[c_sok])
            div_max = float(row[c_dmax])
            row_diverged = div_max > thr
            diverged += int(row_diverged)
            d_usd = float(row[1]) - float(row[c_sc])
            d_slo = float(row[0]) - float(row[c_sok])
            usd_delta += d_usd
            slo_delta += d_slo
            for k in TERM_NAMES:
                fleet_terms[k] += terms[k]
            rec = {
                "t": int(t), "tenant": i, "lane": LANE_NAMES[lane_i],
                "policy": self.policy,
                "exo": {
                    "spot_price_hr": float(row[c_sp]),
                    "od_price_hr": float(row[c_op]),
                    "carbon_g_kwh": float(row[c_cb]),
                    "demand_pods": float(row[c_dm]),
                    "is_peak": bool(row[c_pk] > 0.5),
                },
                "state": {
                    "nodes_spot": float(row[c_ns]),
                    "nodes_od": float(row[c_no]),
                },
                "action": actions[i],
                "objective": {
                    "total": float(sum(terms.values())),
                    "terms": terms,
                    "shares": term_shares(terms),
                    "by_class": by_class,
                },
                "shadow": {
                    "policy": "rule",
                    "action": [float(v) for v in
                               row[layout.shadow_action]],
                    "objective": {
                        "total": float(sum(sh_terms.values())),
                        "terms": sh_terms,
                        "shares": term_shares(sh_terms),
                        "by_class": sh_by_class,
                    },
                    "usd_delta": d_usd,
                    "slo_delta": d_slo,
                    "div_max_abs": div_max,
                    "div_l2": float(row[c_dl2]),
                    "diverged": bool(row_diverged),
                },
            }
            self._append(rec)
        self.diverged_total += diverged
        self.shadow_usd_delta_total += usd_delta
        return self._tick_surfaces(t, diverged, n, fleet_terms,
                                   slo_delta, usd_delta)

    def observe_single(self, t: int, *, lane: str, action, exo: dict,
                       state: dict, chosen: dict,
                       shadow: dict, shadow_action,
                       migration_components: dict | None = None) -> dict:
        """The single-cluster (Controller) variant: one row from host
        scalars already pulled by the tick report. ``chosen``/
        ``shadow`` each carry cost_usd/carbon_g/pend_c0/pend_c1/slo_ok
        as floats (geo rows add migration_cost_usd, and may attach the
        per-region-pair ``migration_components`` split that `ccka
        decisions explain` renders component-by-component)."""
        terms, by_class = objective_terms(self.tcfg, **chosen)
        sh_terms, sh_by_class = objective_terms(self.tcfg, **shadow)
        flat_c = np.asarray(action, np.float64).reshape(-1)
        flat_s = np.asarray(shadow_action, np.float64).reshape(-1)
        div_max = float(np.max(np.abs(flat_c - flat_s)))
        d_usd = chosen["cost_usd"] - shadow["cost_usd"]
        d_slo = chosen["slo_ok"] - shadow["slo_ok"]
        row_diverged = div_max > self.obs.divergence_threshold
        rec = {
            "t": int(t), "tenant": None, "lane": lane,
            "policy": self.policy,
            "exo": dict(exo), "state": dict(state),
            "action": [float(v) for v in flat_c],
            "objective": {"total": float(sum(terms.values())),
                          "terms": terms,
                          "shares": term_shares(terms),
                          "by_class": by_class,
                          **({"migration_components": {
                              k: float(v) for k, v in
                              migration_components.items()}}
                             if migration_components else {})},
            "shadow": {
                "policy": "rule",
                "action": [float(v) for v in flat_s],
                "objective": {"total": float(sum(sh_terms.values())),
                              "terms": sh_terms,
                              "shares": term_shares(sh_terms),
                              "by_class": sh_by_class},
                "usd_delta": float(d_usd), "slo_delta": float(d_slo),
                "div_max_abs": div_max,
                "div_l2": float(np.linalg.norm(flat_c - flat_s)),
                "diverged": bool(row_diverged),
            },
        }
        self._append(rec)
        self.diverged_total += int(row_diverged)
        self.shadow_usd_delta_total += float(d_usd)
        return self._tick_surfaces(t, int(row_diverged), 1, terms,
                                   float(d_slo), float(d_usd))

    # -- internals -----------------------------------------------------------

    def _append(self, rec: dict) -> None:
        self.rows.append(rec)
        self.rows_total += 1
        if self._fh is not None:
            try:
                self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            except (OSError, ValueError) as e:
                self._note_io_error("decision append", e)

    def _tick_surfaces(self, t: int, diverged: int, n: int,
                       fleet_terms: dict, slo_delta: float,
                       usd_delta: float) -> dict:
        if self._fh is not None:
            try:
                self._fh.flush()
            except OSError as e:
                self._note_io_error("decision flush", e)
        self._window.append((diverged, n))
        num = sum(d for d, _ in self._window)
        den = max(sum(m for _, m in self._window), 1)
        rate = num / den
        spike = None
        thr = self.obs.divergence_spike_rate
        if rate >= thr and not self._above:
            self._above = True
            self.spikes_total += 1
            spike = {"rate": round(rate, 6), "threshold": thr,
                     "window_ticks": len(self._window),
                     "diverged": diverged, "decides": n}
        elif rate < thr:
            self._above = False
        return {
            "policy_divergence_rate": round(rate, 6),
            "objective_term_shares": {
                k: round(v, 6)
                for k, v in term_shares(fleet_terms).items()},
            "shadow_slo_delta": round(slo_delta, 6),
            "shadow_usd_delta": round(usd_delta, 9),
            "spike": spike,
        }

    def _note_io_error(self, what: str, e: Exception) -> None:
        self.io_errors += 1
        if self.io_errors == 1:  # once, not per row
            import sys
            print(f"# decision-ledger {what} failed ({e}); further I/O "
                  "errors counted in io_errors, rows stay in-memory",
                  file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# -- read / render side ------------------------------------------------------


def read_decisions(path: str) -> list[dict]:
    """Load a decision JSONL (the runlog reader: torn-tail tolerant —
    a live service's last row may be mid-write; interior corruption
    raises loudly)."""
    from ccka_tpu_torch.obs.runlog import read_runlog
    return read_runlog(path)


def _pct(x: float) -> str:
    return f"{100.0 * x:.1f}%"


def explain_row(row: Mapping, *, action_names: Sequence[str] = (),
                top_deltas: int = 4) -> str:
    """One decision row as the human-facing "why" (`ccka decisions
    explain`): term shares, the observed inputs, and what the rule
    shadow would have done instead."""
    obj = row.get("objective", {})
    shares = obj.get("shares", {})
    by_class = obj.get("by_class", {})
    sh = row.get("shadow", {})
    exo = row.get("exo", {})
    state = row.get("state", {})
    who = (f"tenant {row['tenant']}" if row.get("tenant") is not None
           else "cluster")
    lines = [
        f"tick {row.get('t')} {who} lane={row.get('lane')} "
        f"policy={row.get('policy') or '?'}",
        "objective ${:.6f}/tick: ".format(obj.get("total", 0.0))
        + " | ".join(f"{k} {_pct(shares.get(k, 0.0))}"
                     for k in TERM_NAMES)
        + (f"  (pending by class: "
           + ", ".join(f"{k} ${v:.6f}"
                       for k, v in sorted(by_class.items())) + ")"
           if by_class else ""),
    ]
    mig = obj.get("migration_components") or {}
    if mig:
        # Geo rows attach the migration term's per-component split
        # (region-pair / family transfer dollars, `regions/geo.py`) —
        # rendered one component per entry, largest first.
        parts = sorted(mig.items(), key=lambda kv: -abs(float(kv[1])))
        lines.append("migration components: "
                     + "; ".join(f"{k} ${float(v):.6f}/tick"
                                 for k, v in parts))
    if exo:
        lines.append(
            f"observed exo: spot ${exo.get('spot_price_hr', 0.0):.4f}/hr"
            f" od ${exo.get('od_price_hr', 0.0):.4f}/hr carbon "
            f"{exo.get('carbon_g_kwh', 0.0):.1f} g/kWh demand "
            f"{exo.get('demand_pods', 0.0):.1f} pods "
            f"peak={'yes' if exo.get('is_peak') else 'no'}")
    if state:
        lines.append(f"state estimate: {state.get('nodes_spot', 0.0):.2f}"
                     f" spot / {state.get('nodes_od', 0.0):.2f} od nodes")
    if sh:
        verdict = "DIVERGED" if sh.get("diverged") else "agrees"
        lines.append(
            f"rule shadow ({verdict}, max|dA|="
            f"{sh.get('div_max_abs', 0.0):.4g}): projected delta "
            f"${sh.get('usd_delta', 0.0):+.6f}/tick, "
            f"SLO-ok {sh.get('slo_delta', 0.0):+.0f}")
        a = row.get("action") or []
        b = sh.get("action") or []
        # Labels derive from the CALLER's cluster config; a recorded
        # vector of a different length means the log was taken under
        # another topology — fall back to bare indices with a note
        # rather than mislabel components.
        if action_names and a and len(action_names) != len(a):
            lines.append(
                f"(action labels omitted: current config lays out "
                f"{len(action_names)} action components, the recorded "
                f"vector has {len(a)} — explain with the config the "
                "log was recorded under)")
            action_names = ()
        if a and b and len(a) == len(b):
            deltas = sorted(
                ((abs(x - y), i, x, y)
                 for i, (x, y) in enumerate(zip(a, b))),
                reverse=True)[:max(top_deltas, 0)]
            named = []
            for mag, i, x, y in deltas:
                if mag <= 0.0:
                    continue
                name = (action_names[i] if i < len(action_names)
                        else f"a[{i}]")
                named.append(f"{name}: {x:.3f} vs rule {y:.3f}")
            if named:
                lines.append("largest action deltas: "
                             + "; ".join(named))
    return "\n".join(lines)
