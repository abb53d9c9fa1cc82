"""Online shadow tournament: K-policy counterfactual lanes, win
ledgers, gated promotion (round 20).

The PyTorch form of `ccka_tpu/obs/tournament.py`: the registry, the host
half and its JSONL rows, explain text and audit signatures are the JAX
package's; the device half works on tensors inside the fleet tick
(`harness/fleet.py`) and is captured into its CUDA graph on the card.
Candidate builders take ``(cfg, device)``: a backend lives on the device
the fleet runs on.

Round 18 taught the compiled batched ticks to carry ONE rule-shadow
counterfactual as extra output lanes of the live dispatch, priced at
~2% of tick p50. This module generalizes the shadow to a *population*:
a registered, named roster of K candidate policies (the rule profile,
carbon-intensity specializations, the distilled flagship student) is
evaluated on EVERY live tick through the same expectation dynamics on
the same pre-step states, observed exo and PRNG keys — turning
production traffic into a free A/B/n evaluation, which is what makes
the continual-learning flywheel safe: a challenger ships only after
beating the incumbent as its shadow on live traffic.

The non-interference construction is inherited unchanged from round
18: the candidate lanes are computed UNCONDITIONALLY by
`harness/fleet._compiled_fleet_tick` for any config whose
``obs.tournament_roster`` names a roster, whether or not a host-side
ledger reads them. The host toggle (``obs.tournament_enabled``) is
never read by the tick body, so flipping it can never select a
different graph — bitwise on/off identity holds by construction and is
re-proven by the tests and the chip smoke. The roster NAMES, by
contrast, are program-shaping (they add lanes), so they live on the
config the graph cache is keyed by, not on the host override.

Split of labor, mirroring `obs/decisions.py`:

- :func:`tournament_decision_columns` is the DEVICE half — [N, R +
  K*(len(CAND_COLS)+R)] columns appended to the widened per-cluster
  row inside the compiled ticks (region-mean grid carbon, then each
  candidate's projected step metrics, action divergence and per-region
  zone-weight lean shares).
- :class:`TournamentLedger` is the HOST half — per-tick scoring of
  every candidate against the chosen policy on the decision ledger's
  objective (`decisions.objective_terms` weights), win/comparison
  tallies over a sliding window split per workload class
  (inference/batch/background, mapped from tenant profiles) and per
  region, board JSONL rows in the flight-recorder I/O discipline, the
  edge-triggered ``challenger_sustained_win`` trigger, and the
  Prometheus surfaces (`ccka_policy_candidate_win_rate`,
  `ccka_tournament_leader`).
- :class:`PromotionGate` turns a sustained win into a SIGNED audit
  record — who beat whom, on which windows and classes, which bench
  gates were re-checked — and never auto-switches the primary:
  promotion stays an explicit operator action.
"""

from __future__ import annotations

import collections
import hashlib
import hmac
import json
import os
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ccka_tpu_torch.config import FrameworkConfig, ObsConfig, TrainConfig
from ccka_tpu_torch.obs.decisions import CAND_COLS, DecisionRowLayout

# Workload classes the per-class board splits by (BatchBench's point:
# one scalar win-rate hides which traffic a challenger actually wins
# on). Tenant profiles map onto them; unknown/bare-fleet rows score as
# inference, the latency-critical default.
WORKLOAD_CLASSES = ("inference", "batch", "background")

_PROFILE_CLASS = {
    "healthy": "inference", "jittery": "inference",
    "batch": "batch",
    "slow": "background", "flaky": "background",
}


def workload_class(profile_name: str) -> str:
    """Tenant profile -> workload class (inference when unknown)."""
    return _PROFILE_CLASS.get(profile_name, "inference")


# -- the candidate registry --------------------------------------------------
#
# Builders are (cfg, device) -> PolicyBackend closures registered by NAME; the
# roster resolves names with up-front unknown-name rejection (the
# tenant-profile convention) so a typo fails fast instead of producing
# an empty board. The carbon variants are intensity specializations of
# the same smooth zone-selection rule — a checkpoint-free population
# wide enough for the K=8 overhead point.

CANDIDATE_BUILDERS: "dict[str, tuple[Callable, str]]" = {}


def register_candidate(name: str, builder: Callable,
                       description: str = "") -> None:
    """Register a named candidate builder; duplicates are rejected —
    two builders under one name would make board rows ambiguous."""
    if name in CANDIDATE_BUILDERS:
        raise ValueError(f"candidate {name!r} is already registered")
    CANDIDATE_BUILDERS[name] = (builder, description)


def _rule(cfg: FrameworkConfig, device=None):
    from ccka_tpu_torch.policy.rule import RulePolicy
    return RulePolicy(cfg.cluster, device=device)


def _carbon(sharpness: float = 10.0, min_weight: float = 0.05,
            stickiness: float = 1.0) -> Callable:
    def build(cfg: FrameworkConfig, device=None):
        from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
        return CarbonAwarePolicy(cfg.cluster, sharpness=sharpness,
                                 min_weight=min_weight,
                                 stickiness=stickiness, device=device)
    return build


def _student(cfg: FrameworkConfig, device=None):
    from ccka_tpu_torch.train.flagship import load_flagship_backend
    backend, _meta = load_flagship_backend(cfg, device=device)
    if backend is None:
        raise ValueError(
            "candidate 'student': no flagship checkpoint committed for "
            "this config — distill one (ccka factory) or drop the "
            "student from the roster")
    return backend


register_candidate("rule", _rule,
                   "Peak/Off-Peak rule profile (the round-18 shadow)")
register_candidate("carbon", _carbon(),
                   "carbon-aware zone selection, default intensity")
register_candidate("carbon-sharp", _carbon(sharpness=25.0),
                   "carbon variant: aggressive clean-zone saturation")
register_candidate("carbon-smooth", _carbon(sharpness=4.0),
                   "carbon variant: gentle zone re-ranking")
register_candidate("carbon-sticky", _carbon(stickiness=3.0),
                   "carbon variant: strong placement hysteresis")
register_candidate("carbon-eager", _carbon(stickiness=0.25),
                   "carbon variant: near-zero hysteresis, chases the "
                   "duck curve")
register_candidate("carbon-floor", _carbon(min_weight=0.2),
                   "carbon variant: high per-zone weight floor")
register_candidate("carbon-greedy",
                   _carbon(sharpness=18.0, min_weight=0.01),
                   "carbon variant: sharp + near-zero floor")


def _flywheel_challenger(cfg: FrameworkConfig, device=None):
    from ccka_tpu_torch.train.flywheel import challenger_backend
    return challenger_backend(cfg, device)


register_candidate("student", _student,
                   "distilled flagship student (round-17 factory; "
                   "needs the committed checkpoint)")
register_candidate("flywheel-challenger", _flywheel_challenger,
                   "the continual-learning flywheel's slotted "
                   "challenger checkpoint (round 23; set via "
                   "train.flywheel.set_challenger_checkpoint — the "
                   "FlywheelRunner slots each generation before its "
                   "shadow run)")


class OverProvisionPolicy:
    """The seeded INCUMBENT of the challenger scenario
    (`tests/test_torch_tournament.py`, after the JAX package's): the
    reference's static hand-tuned peak profile taken to its wasteful
    limit — overscaled HPA and consolidation disabled. Against it the
    plain rule/carbon candidates win on the very first comparisons,
    because consolidating away the slack the incumbent refuses to
    reclaim is the one lever with ONE-STEP $/carbon effect (zone
    re-leans only steer the delayed provisioning pipeline —
    `sim/dynamics.py` step 5 vs step 7). Deliberately NOT a registered
    candidate: it exists to lose."""

    def __init__(self, cluster, *, hpa: float = 1.5, device=None):
        from ccka_tpu_torch.policy.rule import RulePolicy
        self.inner = RulePolicy(cluster, device=device)
        self.hpa = float(hpa)

    def decide(self, state, exo, t):
        a = self.inner.decide(state, exo, t)
        return a._replace(
            hpa_scale=torch.full_like(a.hpa_scale, self.hpa),
            consolidation_aggr=torch.zeros_like(a.consolidation_aggr),
            consolidate_after_s=torch.full_like(a.consolidate_after_s,
                                                1e6))

    def action_fn(self):
        return lambda state, exo, t: self.decide(state, exo, t)

    @property
    def name(self) -> str:
        return "overprovision"


def resolve_candidates(names: Sequence[str]) -> list:
    """Roster names -> [(name, builder)], rejecting unknown names up
    front (the `resolve_profiles` convention)."""
    out, bad = [], set()
    for name in names:
        if name in CANDIDATE_BUILDERS:
            out.append((name, CANDIDATE_BUILDERS[name][0]))
        else:
            bad.add(str(name))
    if bad:
        raise ValueError(
            f"unknown tournament candidates {sorted(bad)}; known: "
            f"{sorted(CANDIDATE_BUILDERS)}")
    return out


class TournamentRoster:
    """The resolved roster: name -> constructed PolicyBackend, in lane
    order, every backend on ``device``. Registration PROBES each
    backend's action_fn on a template (state, exo, t) of one cluster —
    a candidate whose policy errors (missing checkpoint, wrong
    topology) raises and leaves the roster unchanged, so a broken
    challenger can never corrupt the lanes of the ones already
    registered."""

    def __init__(self, cfg: FrameworkConfig, names: Sequence[str] = (),
                 *, device=None):
        from ccka_tpu_torch import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self._backends: "dict[str, object]" = {}
        for name, builder in resolve_candidates(names):
            self.register(name, builder(cfg, self.device))

    @property
    def names(self) -> tuple:
        return tuple(self._backends)

    def __len__(self) -> int:
        return len(self._backends)

    def backend(self, name: str):
        return self._backends[name]

    def register(self, name: str, backend) -> None:
        if name in self._backends:
            raise ValueError(
                f"duplicate tournament candidate {name!r} — board rows "
                "are keyed by name, one lane per name")
        from ccka_tpu_torch.sim.dynamics import ExoStep
        from ccka_tpu_torch.sim.rollout import initial_state
        from ccka_tpu_torch.sim.types import Action
        cluster = self.cfg.cluster
        dev = self.device
        state = initial_state(self.cfg, 1, device=dev)
        z = cluster.n_zones

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=dev)

        exo = ExoStep(spot_price_hr=ones(1, z), od_price_hr=ones(1, z),
                      carbon_g_kwh=ones(1, z), demand_pods=ones(1, 2),
                      is_peak=torch.zeros(1, device=dev))
        try:
            with torch.no_grad():
                out = backend.action_fn()(state, exo, 0)
        except Exception as e:
            raise ValueError(
                f"candidate {name!r} failed the registration probe "
                f"(roster unchanged): {e}") from e
        want = (cluster.n_pools, cluster.n_zones)
        if not isinstance(out, Action) or \
                tuple(out.zone_weight.shape[-2:]) != want:
            raise ValueError(
                f"candidate {name!r} failed the registration probe "
                f"(roster unchanged): action_fn must return an Action "
                f"with zone_weight {want}, got {type(out).__name__}")
        self._backends[name] = backend

    def action_fns(self) -> tuple:
        """[(name, action_fn)] in lane order — resolved fresh per call,
        the fleet tick builder's contract."""
        return tuple((name, b.action_fn())
                     for name, b in self._backends.items())


# -- the device half ---------------------------------------------------------


def region_onehot(zone_region_index, n_regions: int,
                  device) -> torch.Tensor:
    """The [Z, R] zone -> region one-hot on ``device``. A caller that
    captures the tournament columns into a CUDA graph makes it before the
    capture (a captured body may not copy from the host) and passes it
    in."""
    zri = torch.as_tensor(tuple(zone_region_index), dtype=torch.long,
                          device=device)
    return torch.nn.functional.one_hot(zri, n_regions).to(torch.float32)


def _region_sum(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """[..., Z] -> [..., R] per-region sums through the [Z, R] one-hot,
    as an elementwise product and one reduction (no matmul, so the same
    sums on every device and inside a graph)."""
    return (x[..., :, None] * onehot).sum(dim=-2)


def tournament_decision_columns(cand_metrics, flat_cands, flat_chosen,
                                cand_zone_w, exo_n, zone_region_index,
                                n_regions: int, *,
                                onehot: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """[N, R + K*(len(CAND_COLS)+R)] tournament columns from the
    stacked candidate step outputs ([K, N, ...] leading axes). Runs
    INSIDE the fleet tick — extra lanes of the same launch chain, never
    its own. Columns, in layout order: the per-region zone-mean grid
    carbon the whole roster shares, then per candidate its CAND_COLS
    block and its per-region zone-weight lean shares (pool-mean weight
    mass, normalized over zones, summed per region — the placement lean
    the per-region board scores). ``onehot`` is :func:`region_onehot`
    of the zone map, made here when not given."""
    if onehot is None:
        onehot = region_onehot(zone_region_index, n_regions,
                               flat_chosen.device)              # [Z, R]
    counts = torch.clamp(onehot.sum(dim=0), min=1.0)            # [R]
    region_carbon = _region_sum(exo_n.carbon_g_kwh, onehot) / counts
    pend = torch.clamp(
        cand_metrics.demand_pods - cand_metrics.served_pods, min=0.0)
    div = torch.amax(torch.abs(flat_cands - flat_chosen[None]), dim=-1)
    wz = cand_zone_w.mean(dim=2)                                # [K, N, Z]
    lean = wz / torch.clamp(wz.sum(dim=-1, keepdim=True), min=1e-9)
    lean_r = _region_sum(lean, onehot)                          # [K, N, R]
    blocks = [region_carbon]
    for k in range(flat_cands.shape[0]):
        blocks.append(torch.stack([
            cand_metrics.cost_usd[k],
            cand_metrics.carbon_g[k],
            pend[k, :, 0], pend[k, :, 1],
            cand_metrics.slo_ok[k].to(torch.float32),
            div[k],
        ], dim=-1))
        blocks.append(lean_r[k])
    return torch.cat(blocks, dim=-1)


def add_candidate_lanes(states, exo_n, t, flat_chosen, cand_fns,
                        sim_step_n, n: int, zone_region_index,
                        n_regions: int, *,
                        onehot: torch.Tensor | None = None):
    """The fleet tick's tournament tail: run every roster candidate
    through the SAME expectation dynamics on the SAME pre-step states
    and observed exo (candidate next-states are discarded; the real
    estimate chain must not fork), and return the tournament column
    block. ``sim_step_n`` is the caller's batched deterministic step;
    ``cand_fns`` the roster's (name, action_fn) lanes, one step each
    (the JAX package vmaps the step over the stacked K axis: the same
    per-candidate arithmetic). ``onehot`` as in
    :func:`tournament_decision_columns`."""
    from ccka_tpu_torch.harness.fleet import batched_action, flatten_actions
    from ccka_tpu_torch.sim.types import StepMetrics

    cand_actions = [batched_action(fn(states, exo_n, t), n)
                    for _name, fn in cand_fns]
    metrics = [sim_step_n(states, a, exo_n)[1] for a in cand_actions]
    cand_metrics = StepMetrics(*(torch.stack(xs) for xs in zip(*metrics)))
    flat_cands = torch.stack([flatten_actions(a, n) for a in cand_actions])
    zone_w = torch.stack([a.zone_weight for a in cand_actions])
    return tournament_decision_columns(
        cand_metrics, flat_cands, flat_chosen, zone_w, exo_n,
        zone_region_index, n_regions, onehot=onehot)


# -- the host half -----------------------------------------------------------


def _objective_totals(tcfg: TrainConfig, cost, carbon, p0, p1,
                      slo) -> np.ndarray:
    """Vectorized `decisions.objective_terms` total (migration 0 — the
    candidate lanes project no geo overlay), on host float64 columns."""
    return (np.asarray(cost, np.float64)
            + float(tcfg.carbon_weight) * np.asarray(carbon, np.float64)
            + float(tcfg.slo_weight) * (np.asarray(p0, np.float64)
                                        + np.asarray(p1, np.float64))
            + float(tcfg.slo_violation_weight)
            * (1.0 - np.asarray(slo, np.float64)))


def sign_audit(record: Mapping, key: str) -> str:
    """HMAC-SHA256 over the canonical JSON of the record WITHOUT its
    signature field — the promotion audit's tamper seal."""
    body = {k: v for k, v in record.items() if k != "signature"}
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return hmac.new(key.encode("utf-8"), blob,
                    hashlib.sha256).hexdigest()


def verify_audit(record: Mapping, key: str) -> bool:
    sig = record.get("signature", "")
    return bool(sig) and hmac.compare_digest(sig,
                                             sign_audit(record, key))


class PromotionGate:
    """Sustained win -> SIGNED audit record; never a switch.

    The gate's whole job is evidence: who beat whom (challenger vs the
    incumbent policy the service actually ran), on which sliding
    windows and workload classes, and which bench-diff tournament
    gates were re-checked against a BENCH record when one was offered.
    ``decision`` is ``"eligible"`` only when every re-checked gate
    held; with no bench record it is ``"needs-bench-recheck"`` — and
    either way ``auto_switch`` is False by construction: promotion
    stays an explicit operator action (`ccka tournament explain`
    renders the audit for that operator)."""

    def __init__(self, obs: ObsConfig, incumbent: str):
        self.obs = obs
        self.incumbent = incumbent
        self.audits_total = 0

    def review(self, challenger: str, board: Mapping, *,
               sustained_ticks: int, window_ticks: int, t: int,
               bench_record: "Mapping | None" = None) -> dict:
        entry = board.get(challenger, {})
        gates: dict = {}
        if bench_record is not None:
            gates = {
                "bitwise_identical":
                    bool(bench_record.get("bitwise_identical")),
                "overhead_gate_ok":
                    bool(bench_record.get("overhead_gate_ok")),
                "board_gate_ok":
                    bool(bench_record.get("board_gate_ok", True)),
            }
        decision = ("eligible" if gates and all(gates.values())
                    else "needs-bench-recheck" if not gates
                    else "blocked")
        rec = {
            "kind": "promotion_audit",
            "t": int(t),
            "challenger": challenger,
            "incumbent": self.incumbent,
            "win_rate": entry.get("win_rate"),
            "classes": entry.get("classes", {}),
            "sustained_ticks": int(sustained_ticks),
            "window_ticks": int(window_ticks),
            "gates": gates,
            "decision": decision,
            "auto_switch": False,
        }
        rec["signature"] = sign_audit(rec, self.obs.tournament_audit_key)
        self.audits_total += 1
        return rec


class TournamentLedger:
    """Host-side per-tick scoring of the roster's candidate lanes.

    Flight-recorder discipline throughout: native host floats, I/O
    failures degrade the record (counted, one stderr note) never the
    loop, and the in-memory window is retention-bounded by
    ``obs.tournament_window``. The hot per-tick path stays inside the
    5%-of-p50 budget by construction: gauges/leader/streaks reduce
    straight off the dense window sums, while the full per-class board
    row is materialized and logged only on the window cadence (one row
    per ``tournament_window`` ticks), on challenger events (the audit
    needs it), and at :meth:`close` (the end-of-run row `ccka
    tournament board` reads).
    A candidate WINS a row when its projected objective total beats
    the chosen policy's by more than ``obs.tournament_win_margin``
    (relative); win rates are windowed wins/comparisons, split per
    workload class and — through the lean-share columns — per region.
    A candidate holding its overall windowed win rate at or above
    ``obs.tournament_win_rate`` for ``obs.tournament_sustain_ticks``
    consecutive ticks raises ONE edge-triggered
    ``challenger_sustained_win`` (re-armed only after the rate drops
    below the bar) and a signed :class:`PromotionGate` audit row."""

    def __init__(self, obs: ObsConfig, tcfg: TrainConfig,
                 names: Sequence[str], *,
                 classes: Sequence[str] = (), policy: str = ""):
        if not names:
            raise ValueError("tournament ledger needs a non-empty roster")
        self.obs = obs
        self.tcfg = tcfg
        self.names = tuple(names)
        self.policy = policy or "primary"
        self.classes = tuple(classes)
        self.ticks_total = 0
        self.comparisons_total = 0
        self.challengers_total = 0
        self.io_errors = 0
        # Per-tick [K, n_classes, 5] stat blocks (wins, n, d_usd,
        # d_carbon, d_slo) plus per-candidate lean/exposure arrays,
        # over the sliding window. Dense arrays, not dicts: the ledger
        # scores on the hot tick path under the 5%-of-p50 budget, so
        # the per-class split is a masks@columns matmul and the board
        # reduce is a stacked-window sum — no per-row Python loop.
        self._window: "collections.deque[tuple]" = collections.deque(
            maxlen=obs.tournament_window)
        # Running window sums (add the new tick, subtract the evicted
        # one): the per-tick gauge reduce is O(1) in the window length.
        # Exact-recomputed from the retained window on every board
        # cadence, so float drift is bounded by one window span.
        self._stat_sum: "np.ndarray | None" = None
        self._lean_sum: "np.ndarray | None" = None
        self._exp_sum: "np.ndarray | None" = None
        self._lean_ticks = 0
        self._masks: "np.ndarray | None" = None
        self._cidx: "np.ndarray | None" = None
        self._lidx: "np.ndarray | None" = None
        self._streak = {n: 0 for n in self.names}
        self._armed = {n: True for n in self.names}
        self._last_t = -1
        self.gate = PromotionGate(obs, self.policy)
        self._fh = None
        self.path = obs.tournament_log_path or ""
        if self.path:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    # -- one tick ------------------------------------------------------------

    def observe_tick(self, t: int, per_np: np.ndarray,
                     layout: DecisionRowLayout, *,
                     lanes: Sequence | None = None) -> dict:
        """Score every candidate against the chosen policy on one
        batched tick's widened rows; returns the tick surfaces
        (candidate_win_rate, tournament_leader, board, challengers)."""
        n = per_np.shape[0]
        k = len(self.names)
        if self._masks is None or self._masks.shape[1] != n:
            classes = (list(self.classes) if len(self.classes) == n
                       else ["inference"] * n)
            self._masks = np.stack([
                np.asarray([c == wc for c in classes], np.float64)
                for wc in WORKLOAD_CLASSES])            # [n_cls, N]
            # Cache the candidate-column gather indices alongside the
            # masks: one fancy-index per tick replaces 5*K column
            # lookups (budget: the whole ledger is bounded by 5% of
            # p50 tick latency, so the hot path is a handful of
            # vectorized numpy ops, never a per-candidate loop).
            self._cidx = np.asarray(
                [[layout.cand_col(nm, c) for nm in self.names]
                 for c in ("cand_cost_usd", "cand_carbon_g",
                           "cand_pend_c0", "cand_pend_c1",
                           "cand_slo_ok")], np.intp)       # [5, K]
            self._lidx = np.concatenate(
                [np.arange(layout.cand_lean(nm).start,
                           layout.cand_lean(nm).stop)
                 for nm in self.names]) if layout.n_regions else None
        masks = self._masks
        c_p0 = layout.col("pend_c0")
        c_p1 = layout.col("pend_c1")
        chosen_cost = per_np[:, 1].astype(np.float64)
        chosen_carbon = per_np[:, 2].astype(np.float64)
        chosen_slo = per_np[:, 0].astype(np.float64)
        chosen_total = _objective_totals(
            self.tcfg, chosen_cost, chosen_carbon,
            per_np[:, c_p0], per_np[:, c_p1], chosen_slo)
        rc = per_np[:, layout.region_carbon].astype(np.float64)
        margin = float(self.obs.tournament_win_margin)
        bar = chosen_total - margin * np.maximum(
            np.abs(chosen_total), 1e-12)
        r = rc.shape[1]
        # All K candidates at once: [5, K, N] gather, broadcast totals.
        block = per_np[:, self._cidx.ravel()].astype(
            np.float64).reshape(n, 5, k).transpose(1, 2, 0)
        cost, carbon, p0, p1, slo = block
        cand_total = _objective_totals(self.tcfg, cost, carbon, p0,
                                       p1, slo)          # [K, N]
        wins = (cand_total < bar[None, :]).astype(np.float64)
        stats = np.empty((k, len(WORKLOAD_CLASSES), 5), np.float64)
        stats[:, :, 0] = wins @ masks.T
        stats[:, :, 1] = masks.sum(axis=1)[None, :]
        stats[:, :, 2] = (chosen_cost[None, :] - cost) @ masks.T
        stats[:, :, 3] = (chosen_carbon[None, :] - carbon) @ masks.T
        stats[:, :, 4] = (slo - chosen_slo[None, :]) @ masks.T
        leans = np.zeros((k, r), np.float64)
        exposures = np.zeros(k, np.float64)
        if r:
            lean = per_np[:, self._lidx].astype(
                np.float64).reshape(n, k, r)
            leans = lean.mean(axis=0)
            # Exposure delta vs a uniform region lean: negative means
            # the candidate leans cleaner than indifference.
            exposures = ((lean * rc[:, None, :]).sum(axis=2)
                         - rc.mean(axis=1)[:, None]).sum(axis=0)
        self.comparisons_total += n * k
        if self._stat_sum is None:
            self._stat_sum = np.zeros_like(stats)
            self._lean_sum = np.zeros_like(leans)
            self._exp_sum = np.zeros_like(exposures)
        if len(self._window) == self._window.maxlen:
            old = self._window[0]
            self._stat_sum -= old[0]
            self._lean_sum -= old[1]
            self._exp_sum -= old[2]
            self._lean_ticks -= int(old[3])
        self._stat_sum += stats
        self._lean_sum += leans
        self._exp_sum += exposures
        self._lean_ticks += int(r > 0)
        self._window.append((stats, leans, exposures, bool(r)))
        self.ticks_total += 1
        return self._tick_surfaces(t)

    # -- internals -----------------------------------------------------------

    def _board(self) -> dict:
        """Reduce the sliding window into the per-candidate board."""
        board: dict = {}
        if not self._window:
            return board
        # One stacked sum over the whole window — the per-tick blocks
        # are dense [K, n_cls, 5] arrays, so the reduce is O(window)
        # numpy, not nested dict walks. Board builds also REFRESH the
        # running per-tick sums, bounding their float drift to one
        # logging cadence.
        stat_sum = np.sum([w[0] for w in self._window], axis=0)
        lean_n = sum(1 for w in self._window if w[3])
        lean_sum = np.sum([w[1] for w in self._window], axis=0)
        exp_sum = np.sum([w[2] for w in self._window], axis=0)
        self._stat_sum = stat_sum.copy()
        self._lean_sum = lean_sum.copy()
        self._exp_sum = exp_sum.copy()
        self._lean_ticks = lean_n
        for idx, name in enumerate(self.names):
            st = stat_sum[idx]                        # [n_cls, 5]
            wins = int(st[:, 0].sum())
            comps = int(st[:, 1].sum())
            board[name] = {
                "win_rate": (round(wins / comps, 6) if comps else 0.0),
                "wins": wins,
                "comparisons": comps,
                "classes": {
                    c: {"win_rate": (round(st[j, 0] / st[j, 1], 6)
                                     if st[j, 1] else None),
                        "wins": int(st[j, 0]),
                        "comparisons": int(st[j, 1]),
                        "usd_delta": round(float(st[j, 2]), 9),
                        "carbon_delta": round(float(st[j, 3]), 6),
                        "slo_delta": round(float(st[j, 4]), 6)}
                    for j, c in enumerate(WORKLOAD_CLASSES)},
                "region_lean": ([round(float(v), 6) for v in
                                 (lean_sum[idx] / lean_n)]
                                if lean_n else []),
                "carbon_exposure_delta": round(float(exp_sum[idx]), 6),
            }
        return board

    def _tick_surfaces(self, t: int) -> dict:
        # Gauges, leader, and streaks come straight from the running
        # window sums — the full board dict (nested per-class rounds +
        # a JSON log row) is only materialized on the window cadence,
        # on challenger events, and at close(), keeping the per-tick
        # path inside the 5%-of-p50 ledger budget.
        wins_k = self._stat_sum[:, :, 0].sum(axis=1)
        comps_k = np.maximum(self._stat_sum[:, :, 1].sum(axis=1), 0.0)
        rates = {name: (round(float(wins_k[i] / comps_k[i]), 6)
                        if comps_k[i] else 0.0)
                 for i, name in enumerate(self.names)}
        leader = None
        if comps_k.any():
            leader = int(max(range(len(self.names)),
                             key=lambda i: rates[self.names[i]]))
        challengers: list[dict] = []
        thr = float(self.obs.tournament_win_rate)
        need = int(self.obs.tournament_sustain_ticks)
        for i, name in enumerate(self.names):
            if comps_k[i] and rates[name] >= thr:
                self._streak[name] += 1
                if self._streak[name] >= need and self._armed[name]:
                    self._armed[name] = False
                    self.challengers_total += 1
                    challengers.append({
                        "candidate": name,
                        "incumbent": self.policy,
                        "win_rate": rates[name],
                        "sustained_ticks": self._streak[name],
                        "window_ticks": len(self._window),
                    })
            else:
                self._streak[name] = 0
                self._armed[name] = True
        board = None
        on_cadence = (self.ticks_total
                      % int(self.obs.tournament_window) == 0)
        if challengers or on_cadence:
            board = self._board()
            self._append_board(t, board, leader)
        audits = []
        for ch in challengers:
            audit = self.gate.review(
                ch["candidate"], board,
                sustained_ticks=ch["sustained_ticks"],
                window_ticks=ch["window_ticks"], t=t)
            self._append(audit)
            audits.append(audit)
        if (challengers or audits) and self._fh is not None:
            try:
                self._fh.flush()
            except OSError as e:
                self._note_io_error("tournament flush", e)
        self._last_t = int(t)
        return {
            "candidate_win_rate": rates,
            "tournament_leader": leader,
            "board": board,
            "challengers": challengers,
            "audits": audits,
        }

    def _append_board(self, t: int, board: dict,
                      leader: "int | None") -> None:
        self._append({"kind": "board", "t": int(t),
                      "policy": self.policy,
                      "window_ticks": len(self._window),
                      "leader": (self.names[leader]
                                 if leader is not None else None),
                      "board": board})

    def _append(self, rec: dict) -> None:
        if self._fh is not None:
            try:
                self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            except (OSError, ValueError) as e:
                self._note_io_error("tournament append", e)

    def _note_io_error(self, what: str, e: Exception) -> None:
        self.io_errors += 1
        if self.io_errors == 1:  # once, not per row
            import sys
            print(f"# tournament-ledger {what} failed ({e}); further "
                  "I/O errors counted in io_errors",
                  file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            # Final board row so `ccka tournament board` always sees
            # the end-of-run state even when the run was shorter than
            # the logging cadence (one full row per window).
            if self._window:
                stat_sum = np.sum([w[0] for w in self._window], axis=0)
                wins_k = stat_sum[:, :, 0].sum(axis=1)
                comps_k = stat_sum[:, :, 1].sum(axis=1)
                leader = None
                if comps_k.any():
                    rate = np.where(comps_k > 0, wins_k
                                    / np.maximum(comps_k, 1.0), 0.0)
                    leader = int(rate.argmax())
                self._append_board(self._last_t, self._board(), leader)
            try:
                self._fh.flush()
            except OSError as e:
                self._note_io_error("tournament flush", e)
            self._fh.close()
            self._fh = None


# -- read / render side ------------------------------------------------------


def read_tournament(path: str) -> list:
    """Load a tournament JSONL (board + promotion_audit rows; torn-tail
    tolerant like every runlog)."""
    from ccka_tpu_torch.obs.runlog import read_runlog
    return read_runlog(path)


def explain_board(row: Mapping) -> str:
    """One board row as the human-facing scoreboard (`ccka tournament
    board`): per-candidate overall + per-class win rates, deltas, and
    the region lean."""
    board = row.get("board", {})
    lines = [f"tick {row.get('t')} window={row.get('window_ticks')} "
             f"incumbent={row.get('policy')} "
             f"leader={row.get('leader') or '-'}"]
    for name in sorted(board,
                       key=lambda n: -(board[n].get("win_rate") or 0)):
        e = board[name]
        lines.append(
            f"  {name}: win {100.0 * (e.get('win_rate') or 0.0):.1f}% "
            f"({e.get('wins')}/{e.get('comparisons')})"
            + (f", carbon exposure {e.get('carbon_exposure_delta'):+.3f}"
               if e.get("region_lean") else ""))
        for c in WORKLOAD_CLASSES:
            ce = e.get("classes", {}).get(c) or {}
            if not ce.get("comparisons"):
                continue
            lines.append(
                f"    {c}: win {100.0 * (ce.get('win_rate') or 0.0):.1f}%"
                f" ({ce['wins']}/{ce['comparisons']}), "
                f"${ce.get('usd_delta', 0.0):+.6f}, "
                f"{ce.get('carbon_delta', 0.0):+.3f} gCO2, "
                f"SLO {ce.get('slo_delta', 0.0):+.1f}")
    return "\n".join(lines)


def explain_audit(rec: Mapping, key: str) -> str:
    """One promotion audit, signature-checked, for `ccka tournament
    explain`."""
    ok = verify_audit(rec, key)
    shares = rec.get("classes", {})
    lines = [
        f"promotion audit @ tick {rec.get('t')}: "
        f"{rec.get('challenger')} vs incumbent {rec.get('incumbent')}",
        f"  windowed win rate {100.0 * (rec.get('win_rate') or 0):.1f}% "
        f"sustained {rec.get('sustained_ticks')} ticks over "
        f"{rec.get('window_ticks')}-tick windows",
    ]
    for c, ce in sorted(shares.items()):
        if not (ce or {}).get("comparisons"):
            continue
        lines.append(f"  {c}: win "
                     f"{100.0 * (ce.get('win_rate') or 0.0):.1f}% "
                     f"({ce['wins']}/{ce['comparisons']})")
    gates = rec.get("gates") or {}
    lines.append("  gates re-checked: "
                 + (", ".join(f"{k}={'ok' if v else 'FAIL'}"
                              for k, v in sorted(gates.items()))
                    or "none"))
    lines.append(f"  decision: {rec.get('decision')} "
                 f"(auto_switch={rec.get('auto_switch')}) "
                 f"signature={'valid' if ok else 'INVALID'}")
    return "\n".join(lines)
