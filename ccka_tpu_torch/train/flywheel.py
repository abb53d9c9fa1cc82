"""The continual-learning flywheel: production record -> better policy.

The PyTorch form of `ccka_tpu/train/flywheel.py`. It composes the
decision ledger, the shadow tournament, the incident log, the minted
scenarios, the factory and the distiller into one deterministic, seeded
orchestrator:

1. **Mine** (`train/mining.py`): rank (scenario x intensity x
   workload-class x tenant-regime) weakness cells from the ledger's
   per-term attribution, the tournament's per-class win ledgers and
   declared incidents; minted adversarial scenarios join the candidate
   set through the digest-verified minted-dir loader.
2. **Label**: the ranked cells become a weakness-weighted factory
   curriculum: heavier cells get more MPC-teacher pairs
   (`curriculum_from_cells`).
3. **Distill**: a versioned challenger checkpoint, warm-started from its
   parent (`imitate(init_params=...)`), whose provenance record (parent
   digest, curriculum digest, ledger window, seeds) is checksummed and
   REFUSED on tamper.
4. **Promote**: the challenger must beat the incumbent on paired
   per-workload-class $/SLO deltas over its mined weakness cells AND
   pass the gate battery (`promotion_gates`); then the live checkpoint
   swaps ATOMICALLY (write-temp-fsync-rename; the parent's digest is
   recorded first so rollback has an anchor).
5. **Roll back** (`rollback`): an edge-triggered post-promotion
   ``policy_divergence`` incident demotes the challenger and restores the
   parent checkpoint BITWISE (digest-verified on both ends).

The fleet-service loop that runs generations end to end lives in
`harness/flywheel.py`; this module owns the artifacts and the gates and
never opens a service loop. Distillation and the paired evaluation run on
``device`` (the card unless the caller asks for the CPU): on the card
each factory cell's labels are the plan and rule CARRY kernels and each
evaluated cell is one launch of the MLP rollout kernel (two when the
incumbent is a checkpoint). Everything else is host arithmetic shared,
digit for digit, with the JAX package, so a flywheel root written by
either package is read, promoted and rolled back by the other.

Disk layout under ``root``::

    generations/gen-001/challenger.npz   versioned checkpoints
    generations/gen-001/provenance.json  checksummed lineage records
    live.npz                             the promoted incumbent
    live.json                            pointer: generation, digest,
                                         parent anchor, swap history

Everything is deterministic for fixed seeds: the factory's per-cell
worlds and Philox draws come from the cell seed, distillation from one
seed, and the paired evaluation regenerates each cell's exact streams.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Sequence

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.train.checkpoint import (PARAMS_DIGEST_KEY,
                                             load_params_npz, params_digest,
                                             save_params_npz)
from ccka_tpu_torch.train.mining import (WeaknessCell, curriculum_digest,
                                         curriculum_from_cells,
                                         mine_weakness_cells)

# The incumbent name before any promotion: the paper's hand-coded rule
# profile, exactly the policy the flywheel exists to outgrow.
RULE_INCUMBENT = "rule"

# Per-workload-class regression metrics on the cell summaries (all
# lower-is-better): the promotion gate refuses a challenger that
# regresses ANY class beyond tolerance, no matter how good its headline.
CLASS_METRICS = {
    "inference": "inf_slo_violations",
    "batch": "batch_deadline_misses",
    "background": "cost_usd",
}

# Relative per-class regression tolerance + absolute slack floor: tiny
# denominators (a calm cell with ~0 violations) must not turn float
# noise into a gate veto.
CLASS_TOLERANCE = 0.05
_CLASS_ABS_SLACK = 1e-3


# The current-challenger slot the "flywheel-challenger" tournament
# candidate reads (`obs/tournament.py`): a roster candidate is made by
# (cfg, device) -> PolicyBackend with no other inputs, so WHICH
# generation's checkpoint rides the shadow lane has to come from module
# state the runner sets before constructing the service. Checkpoint loads
# are digest-verified: a tampered challenger cannot enter the roster.
_CHALLENGER_CKPT = {"path": ""}


def set_challenger_checkpoint(path: str) -> None:
    if path and not os.path.exists(path):
        raise ValueError(f"challenger checkpoint {path!r} does not "
                         "exist — distill a generation first")
    _CHALLENGER_CKPT["path"] = path


def challenger_checkpoint() -> str:
    return _CHALLENGER_CKPT["path"]


def challenger_backend(cfg: FrameworkConfig, device=None):
    """The ``flywheel-challenger`` tournament candidate:
    the slotted checkpoint, digest-verified, wrapped as a deterministic
    PPOBackend on ``device``."""
    path = _CHALLENGER_CKPT["path"]
    if not path:
        raise ValueError(
            "candidate 'flywheel-challenger': no challenger checkpoint "
            "slotted — call train.flywheel.set_challenger_checkpoint "
            "(the FlywheelRunner does this before its shadow run) or "
            "drop the candidate from the roster")
    from ccka_tpu_torch.train.ppo import PPOBackend

    params, _meta = load_params_npz(path)
    return PPOBackend(cfg, params, device=device)


def _canonical_digest(record: dict, *, drop: str = "record_digest") -> str:
    doc = {k: v for k, v in record.items() if k != drop}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def _write_json_atomic(path: str, doc: dict) -> None:
    """temp + fsync + rename: a crash mid-write leaves the old file."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def write_provenance(path: str, record: dict) -> dict:
    """Stamp ``record_digest`` (sha256 of the canonical JSON minus the
    digest field) and write atomically: a torn or edited provenance file
    must be detectable, never silently trusted. The record's values must
    be JSON-native (no tensor, no numpy scalar)."""
    rec = dict(record)
    rec["record_digest"] = _canonical_digest(rec)
    _write_json_atomic(path, rec)
    return rec


def load_provenance(path: str) -> dict:
    """Load + verify a provenance record; REFUSES tamper (lineage that
    cannot prove itself is not evidence)."""
    with open(path, encoding="utf-8") as fh:
        rec = json.load(fh)
    stored = rec.get("record_digest", "")
    got = _canonical_digest(rec)
    if not stored or stored != got:
        raise ValueError(
            f"provenance {path!r}: record digest mismatch — stored "
            f"{stored[:12] or '<absent>'}…, the record hashes to "
            f"{got[:12]}…. The lineage was modified after writing; "
            "refusing a tampered provenance record.")
    for field in ("generation", "parent", "curriculum",
                  "curriculum_digest", "ledger_window", "seeds",
                  "checkpoint_digest"):
        if field not in rec:
            raise ValueError(f"provenance {path!r}: missing required "
                             f"field {field!r} — a partial lineage "
                             "record cannot gate a promotion")
    if curriculum_digest(rec["curriculum"]) != rec["curriculum_digest"]:
        raise ValueError(
            f"provenance {path!r}: curriculum digest mismatch — the "
            "recorded curriculum is not the one the digest pins")
    return rec


def promotion_gates(eval_rows: Sequence[dict], *,
                    shadow_board: dict | None = None,
                    provenance: dict | None = None,
                    history_regressions: Sequence[dict] | None = None,
                    tolerance: float = CLASS_TOLERANCE,
                    win_rate: float = 0.5,
                    shadow_usd_tol: float = 1e-3,
                    shadow_slo_tol: float = 1e-6) -> dict:
    """The gate battery one promotion must pass; returns the signed-off
    decision dict (``eligible`` True only when EVERY gate holds):

    - ``cells_improved``: the pair-weighted mean challenger/incumbent
      $/SLO-hr ratio over the mined weakness cells is STRICTLY < 1;
    - ``class_regression_ok``: no workload class's metric regresses
      beyond ``tolerance`` on any cell (abs slack for ~0 denominators);
    - ``shadow_ok``: when a shadow-tournament board is supplied, the
      challenger lane's sliding-window paired per-workload-class $/SLO
      deltas against the incumbent must show NO material harm in any
      class with comparisons (``usd_delta >= -shadow_usd_tol``,
      ``slo_delta >= -shadow_slo_tol``; positive = the challenger
      saves/serves better). When the window shows material separation
      at all, the overall win rate must additionally clear
      ``win_rate``; a window that is a statistical tie passes as
      NON-INFERIOR, and superiority rides ``cells_improved``;
    - ``provenance_ok``: the lineage record verified (digest + required
      fields; `load_provenance` raising marks this False upstream);
    - ``history_ok``: the bench history rows a caller passes show no
      robustness/overload/decision regressions.
    """
    rows = list(eval_rows)
    gates: dict = {}
    if rows:
        w = np.asarray([max(r.get("pairs", 1), 1) for r in rows],
                       np.float64)
        ratios = np.asarray([r["challenger_vs_incumbent_usd_per_slo_hour"]
                             for r in rows], np.float64)
        mean_ratio = float((ratios * w).sum() / w.sum())
        gates["cells_improved"] = bool(mean_ratio < 1.0)
        gates["mean_ratio"] = round(mean_ratio, 6)
        worst = {}
        reg_ok = True
        for r in rows:
            for cls, d in r.get("class_deltas", {}).items():
                rel = d.get("rel_delta", 0.0)
                worst[cls] = max(worst.get(cls, 0.0), rel)
                if rel > tolerance:
                    reg_ok = False
        gates["class_regression_ok"] = bool(reg_ok)
        gates["worst_class_rel_delta"] = {
            c: round(v, 6) for c, v in sorted(worst.items())}
    else:
        gates["cells_improved"] = False
        gates["mean_ratio"] = None
        gates["class_regression_ok"] = False
    if shadow_board is not None:
        ch = shadow_board or {}
        rate = ch.get("win_rate", 0.0)
        comps = ch.get("comparisons", 0)
        harm, material = False, False
        for cls, cell in (ch.get("classes") or {}).items():
            if not cell.get("comparisons"):
                continue
            usd = cell.get("usd_delta", 0.0)
            slo = cell.get("slo_delta", 0.0)
            if usd < -shadow_usd_tol or slo < -shadow_slo_tol:
                harm = True
            if abs(usd) > shadow_usd_tol or abs(slo) > shadow_slo_tol:
                material = True
        if comps <= 0:
            outcome = "no_comparisons"
        elif harm:
            outcome = "class_harm"
        elif not material:
            outcome = "non_inferior"
        elif rate >= win_rate:
            outcome = "win"
        else:
            outcome = "material_loss"
        gates["shadow_ok"] = outcome in ("win", "non_inferior")
        gates["shadow_outcome"] = outcome
        gates["shadow_win_rate"] = rate
        gates["shadow_comparisons"] = comps
    gates["provenance_ok"] = bool(provenance is not None
                                  and provenance.get("record_digest"))
    if history_regressions is None:
        gates["history_ok"] = True
        gates["history_regressions"] = None
    else:
        bad = [r for r in history_regressions
               if r.get("kind") in ("overload_invariant",
                                    "decisions_invariant",
                                    "recovery_invariant")]
        gates["history_ok"] = not bad
        gates["history_regressions"] = len(bad)
    gate_keys = [k for k in ("cells_improved", "class_regression_ok",
                             "shadow_ok", "provenance_ok",
                             "history_ok") if k in gates]
    return {"gates": gates, "tolerance": tolerance,
            "eligible": all(gates[k] for k in gate_keys)}


def _mean64(x: torch.Tensor) -> float:
    """The float64 mean of a summary field, as the JAX package takes it."""
    return float(np.asarray(x.detach().cpu().numpy(), np.float64).mean())


class Flywheel:
    """The artifact-owning orchestrator (see module docstring). One
    instance per flywheel ``root``; every method is re-runnable and
    leaves the live checkpoint untouched unless its gates pass.
    ``device`` is where `distill` and `evaluate` run (resolved when they
    run: the card unless it names the CPU); the other methods are host
    work."""

    def __init__(self, cfg: FrameworkConfig, root: str, *,
                 teacher: str = "mpc", steps: int = 48,
                 block_T: int = 48, t_chunk: int = 48,
                 pairs_base: int = 8, pairs_max: int = 32,
                 iterations: int = 240, seed: int = 0,
                 minted_dir: str = "", runlog=None, device=None):
        from ccka_tpu_torch.train.factory import FACTORY_TEACHERS

        if teacher not in FACTORY_TEACHERS:
            raise ValueError(f"unknown teacher {teacher!r}; teachers: "
                             f"{sorted(FACTORY_TEACHERS)}")
        self.cfg = cfg
        self.root = os.path.abspath(root)
        self.teacher = teacher
        self.steps, self.block_T, self.t_chunk = steps, block_T, t_chunk
        self.pairs_base, self.pairs_max = pairs_base, pairs_max
        self.iterations = int(iterations)
        self.seed = int(seed)
        self.minted_dir = minted_dir
        self.runlog = runlog
        self.device = device
        os.makedirs(os.path.join(self.root, "generations"), exist_ok=True)

    # -- paths ---------------------------------------------------------------

    @property
    def live_npz(self) -> str:
        return os.path.join(self.root, "live.npz")

    @property
    def live_json(self) -> str:
        return os.path.join(self.root, "live.json")

    def gen_dir(self, generation: int) -> str:
        return os.path.join(self.root, "generations",
                            f"gen-{generation:03d}")

    def _event(self, name: str, **fields) -> None:
        if self.runlog is not None:
            self.runlog.event(name, **fields)

    # -- status / incumbent --------------------------------------------------

    def status(self) -> dict:
        """The operator surface (`ccka flywheel status`): live pointer,
        generation inventory, provenance verification per generation."""
        live = None
        if os.path.exists(self.live_json):
            with open(self.live_json, encoding="utf-8") as fh:
                live = json.load(fh)
        gens = []
        gen_root = os.path.join(self.root, "generations")
        for name in sorted(os.listdir(gen_root)):
            prov_path = os.path.join(gen_root, name, "provenance.json")
            row = {"generation": name, "provenance": None}
            if os.path.exists(prov_path):
                try:
                    rec = load_provenance(prov_path)
                    row["provenance"] = "verified"
                    row["checkpoint_digest"] = rec["checkpoint_digest"][:12]
                    row["parent"] = rec["parent"].get("name")
                except ValueError as e:
                    row["provenance"] = f"REFUSED: {e}"
            gens.append(row)
        return {"root": self.root, "live": live,
                "incumbent": (live or {}).get("name", RULE_INCUMBENT),
                "generations": gens}

    def incumbent(self) -> tuple[str, "dict | None"]:
        """(name, params) of the live policy: (``"rule"``, None) until a
        promotion lands. The live checkpoint loads digest-VERIFIED and
        the live.json pointer must agree with the file's content digest:
        a swapped-in stray file is a refusal, not an incumbent."""
        if not os.path.exists(self.live_npz):
            return RULE_INCUMBENT, None
        params, meta = load_params_npz(self.live_npz)
        with open(self.live_json, encoding="utf-8") as fh:
            live = json.load(fh)
        if live.get("digest") != meta.get(PARAMS_DIGEST_KEY):
            raise ValueError(
                f"live checkpoint {self.live_npz!r} content digest "
                f"{str(meta.get(PARAMS_DIGEST_KEY))[:12]}… does not "
                f"match the live.json pointer "
                f"{str(live.get('digest'))[:12]}… — the live policy "
                "was swapped outside the flywheel; refusing it.")
        return live.get("name", "gen-?"), params

    # -- 1. mine -------------------------------------------------------------

    def mine(self, *, decisions_path: str = "",
             tournament_path: str = "", incidents_path: str = "",
             intensities: tuple = ("off", "moderate"),
             top_k: int = 4) -> list[WeaknessCell]:
        cells = mine_weakness_cells(
            decisions_path=decisions_path,
            tournament_path=tournament_path,
            incidents_path=incidents_path,
            minted_dir=self.minted_dir,
            intensities=intensities, top_k=top_k)
        self._event("flywheel_mine",
                    cells=[{"scenario": c.scenario,
                            "intensity": c.intensity,
                            "class": c.workload_class,
                            "regime": c.tenant_regime,
                            "score": c.score} for c in cells],
                    decisions=decisions_path,
                    tournament=tournament_path,
                    incidents=incidents_path)
        return cells

    # -- 2+3. label + distill ------------------------------------------------

    def _resolve_scenario(self, name: str):
        from ccka_tpu_torch.workloads.scenarios import (
            WORKLOAD_SCENARIOS, load_minted_scenarios)

        if name in WORKLOAD_SCENARIOS:
            return WORKLOAD_SCENARIOS[name]
        if self.minted_dir:
            minted = load_minted_scenarios(self.minted_dir)
            if name in minted:
                return minted[name]
        raise ValueError(f"unknown scenario {name!r} in curriculum; "
                         f"library: {sorted(WORKLOAD_SCENARIOS)}"
                         + (f" + minted dir {self.minted_dir!r}"
                            if self.minted_dir else ""))

    def distill(self, cells: Sequence[WeaknessCell], *,
                generation: int,
                ledger_window: dict | None = None) -> dict:
        """Weakness-weighted curriculum -> challenger checkpoint +
        checksummed provenance. Returns the distill report (paths,
        curriculum, the produced factory cells for evaluation)."""
        from ccka_tpu_torch.train.factory import produce_cell
        from ccka_tpu_torch.train.imitate import ImitationBatch, imitate

        dev = resolve_device(self.device)
        curriculum = curriculum_from_cells(
            list(cells), pairs_base=self.pairs_base,
            pairs_max=self.pairs_max)
        cur_digest = curriculum_digest(curriculum)
        parent_name, parent_params = self.incumbent()
        parent_digest = (params_digest(parent_params)
                         if parent_params is not None else "")

        produced = []
        for ci, row in enumerate(curriculum):
            sc = self._resolve_scenario(row["scenario"])
            produced.append(produce_cell(
                self.cfg, sc, row["intensity"], teacher=self.teacher,
                pairs=row["pairs"], steps=self.steps,
                block_T=self.block_T, t_chunk=self.t_chunk,
                seed=self.seed + 1000 * generation + 10 * ci, device=dev))
        dataset = ImitationBatch(*(torch.cat(parts, dim=0) for parts in
                                   zip(*(c.dataset for c in produced))))
        # Warm-start from the parent: a later generation trains FURTHER
        # on the weakness-weighted data instead of relearning the easy
        # cells from scratch, which makes beating your own parent a fair
        # gate.
        challenger_params, history = imitate(
            self.cfg, None, None, dataset=dataset,
            iterations=self.iterations, seed=self.seed + generation,
            init_params=parent_params,
            learning_rate=(1e-3 if parent_params is None else 3e-4),
            device=dev)

        gdir = self.gen_dir(generation)
        os.makedirs(gdir, exist_ok=True)
        ckpt_path = os.path.join(gdir, "challenger.npz")
        save_params_npz(ckpt_path, challenger_params, meta={
            "generation": generation, "teacher": self.teacher,
            "parent": parent_name, "parent_digest": parent_digest,
            "curriculum_digest": cur_digest})
        _tree, meta = load_params_npz(ckpt_path)  # verify the round trip
        ckpt_digest = meta[PARAMS_DIGEST_KEY]
        prov = write_provenance(os.path.join(gdir, "provenance.json"), {
            "generation": int(generation),
            "teacher": self.teacher,
            "parent": {"name": parent_name, "digest": parent_digest,
                       "path": (self.live_npz if parent_params is not None
                                else "")},
            "curriculum": curriculum,
            "curriculum_digest": cur_digest,
            "ledger_window": dict(ledger_window or {}),
            "seeds": {"base": self.seed, "generation": int(generation),
                      "distill": self.seed + int(generation)},
            "checkpoint": os.path.basename(ckpt_path),
            "checkpoint_digest": ckpt_digest,
            "minted": [c.scenario for c in cells
                       if c.evidence.get("params_digest")],
        })
        self._event("flywheel_distill", generation=generation,
                    pairs_total=int(dataset.obs.shape[0]),
                    curriculum_digest=cur_digest,
                    checkpoint_digest=ckpt_digest,
                    final_actor_mse=float(history[-1]["actor_mse"]))
        return {"generation": generation, "curriculum": curriculum,
                "curriculum_digest": cur_digest,
                "checkpoint": ckpt_path,
                "checkpoint_digest": ckpt_digest,
                "provenance": prov, "produced": produced,
                "history": history,
                "parent": {"name": parent_name,
                           "digest": parent_digest}}

    # -- 4a. paired evaluation ----------------------------------------------

    def evaluate(self, challenger_params, produced: Sequence, *,
                 streams: Sequence | None = None) -> list[dict]:
        """Paired challenger-vs-incumbent scoring on each produced cell's
        EXACT worlds: the MLP rollout kernel replays the challenger (and
        the incumbent, when it is a checkpoint) on the stream regenerated
        from the cell's recorded seed, bitwise the worlds the curriculum
        labeled, under the cell's recorded dynamics (``stochastic``) and
        Philox seed. The rule incumbent's column is the factory's own
        paired rule summary from those same streams. ``streams`` (one
        packed stream per cell) replaces the regeneration: the seam
        through which a caller supplies its own worlds."""
        from ccka_tpu_torch.sim.megakernel import packed_mode_summary_fn
        from ccka_tpu_torch.sim.types import SimParams
        from ccka_tpu_torch.train import factory as factory_mod

        dev = resolve_device(self.device)
        params = SimParams.from_config(self.cfg, device=dev)
        _name, inc_params = self.incumbent()
        rows = []
        for i, cell in enumerate(produced):
            rep = cell.report
            if streams is not None:
                stream = torch.as_tensor(streams[i]).to(dev)
            else:
                sc = self._resolve_scenario(cell.scenario)
                stream = factory_mod._cell_stream(
                    factory_mod._cell_source(self.cfg, sc, cell.intensity),
                    steps=rep["steps"], block_T=rep["block_T"],
                    t_chunk=rep["t_chunk"], pairs=rep["pairs"],
                    key=rep["seed"], device=dev)
            kw = dict(T=rep["steps"], stochastic=rep["stochastic"])
            ch_fn = packed_mode_summary_fn(
                params, self.cfg.cluster, "neural",
                net_params=challenger_params, **kw)
            s_ch = ch_fn(stream, rep["seed"])
            if inc_params is None:
                s_inc = cell.rule_summary
            else:
                inc_fn = packed_mode_summary_fn(
                    params, self.cfg.cluster, "neural",
                    net_params=inc_params, **kw)
                s_inc = inc_fn(stream, rep["seed"])
            deltas = {}
            for cls, metric in CLASS_METRICS.items():
                a = _mean64(getattr(s_ch, metric))
                b = _mean64(getattr(s_inc, metric))
                deltas[cls] = {
                    "metric": metric,
                    "challenger": round(a, 6), "incumbent": round(b, 6),
                    "rel_delta": round((a - b)
                                       / max(abs(b), _CLASS_ABS_SLACK),
                                       6),
                }
            rows.append({
                "scenario": cell.scenario, "intensity": cell.intensity,
                "pairs": rep["pairs"],
                "challenger_vs_incumbent_usd_per_slo_hour": round(
                    factory_mod._paired_usd_ratio(s_ch, s_inc), 6),
                "challenger_vs_rule_usd_per_slo_hour": round(
                    factory_mod._paired_usd_ratio(s_ch,
                                                  cell.rule_summary), 6),
                "class_deltas": deltas,
            })
        return rows

    # -- 4b. promote ---------------------------------------------------------

    def promote(self, generation: int, decision: dict) -> dict:
        """Apply an ELIGIBLE promotion decision: verify the challenger's
        provenance + checkpoint digests, then atomically swap the live
        checkpoint (temp + fsync + rename: a crash mid-swap leaves the old
        incumbent intact). Refuses (ValueError, live untouched) when the
        decision's gates did not pass or the lineage does not verify."""
        if not decision.get("eligible"):
            failed = [k for k, v in decision.get("gates", {}).items()
                      if v is False]
            raise ValueError(
                f"promotion refused for gen-{generation:03d}: gates "
                f"failed {failed or '<no evidence>'} — the incumbent "
                "stays live")
        gdir = self.gen_dir(generation)
        prov = load_provenance(os.path.join(gdir, "provenance.json"))
        ckpt = os.path.join(gdir, prov["checkpoint"])
        tree, meta = load_params_npz(ckpt)   # digest-verified load
        if meta.get(PARAMS_DIGEST_KEY) != prov["checkpoint_digest"]:
            raise ValueError(
                f"promotion refused: checkpoint digest "
                f"{str(meta.get(PARAMS_DIGEST_KEY))[:12]}… does not "
                f"match the provenance record's "
                f"{prov['checkpoint_digest'][:12]}…")
        prev = None
        if os.path.exists(self.live_json):
            with open(self.live_json, encoding="utf-8") as fh:
                prev = json.load(fh)
        self._swap_live_npz(tree, meta)
        live = {
            "name": f"gen-{generation:03d}",
            "generation": generation,
            "digest": prov["checkpoint_digest"],
            "checkpoint": ckpt,
            "parent": prov["parent"],
            "decision": decision,
            "previous": ({"name": prev["name"],
                          "digest": prev["digest"]} if prev else None),
        }
        _write_json_atomic(self.live_json, live)
        self._event("flywheel_promote", generation=generation,
                    digest=prov["checkpoint_digest"],
                    parent=prov["parent"]["name"],
                    gates={k: v for k, v in decision["gates"].items()
                           if isinstance(v, bool)})
        return live

    def _swap_live_npz(self, tree: dict, meta: dict) -> None:
        """Atomic swap of live.npz: the temp copy is re-saved (not copied)
        so the written file re-derives its own digest; rename is the
        commit. np.savez appends ".npz" to extension-less paths, so the
        temp name already ends in it."""
        tmp = self.live_npz[:-len(".npz")] + ".tmp.npz"
        save_params_npz(tmp, tree, meta={
            k: v for k, v in meta.items() if k != PARAMS_DIGEST_KEY})
        os.replace(tmp, self.live_npz)

    # -- 5. rollback ---------------------------------------------------------

    def rollback(self, *, trigger: str = "policy_divergence",
                 incident: dict | None = None) -> dict:
        """Demote the live challenger and restore its recorded parent
        BITWISE: the parent generation's checkpoint reloads digest-
        verified and must hash to exactly the digest the promotion
        recorded (`parent.digest`); a rule parent simply clears the live
        checkpoint. Refuses when nothing is promoted."""
        if not os.path.exists(self.live_json):
            raise ValueError("rollback refused: nothing is promoted — "
                             "the rule incumbent is already live")
        with open(self.live_json, encoding="utf-8") as fh:
            live = json.load(fh)
        parent = live.get("parent") or {}
        demoted = {"name": live.get("name"), "digest": live.get("digest")}
        if parent.get("digest"):
            src = parent.get("path") or ""
            # The parent checkpoint survives in its generation dir even
            # after the live file was overwritten by a later promotion.
            if not os.path.exists(src) or src == self.live_npz:
                prev_gen = live.get("generation", 1) - 1
                src = os.path.join(self.gen_dir(prev_gen),
                                   "challenger.npz")
            tree, meta = load_params_npz(src)  # digest-verified
            restored = params_digest(tree)
            if restored != parent["digest"]:
                raise ValueError(
                    f"rollback refused: parent checkpoint {src!r} "
                    f"hashes to {restored[:12]}…, the promotion "
                    f"recorded {parent['digest'][:12]}… — the parent "
                    "lineage is gone; refusing a non-bitwise restore")
            self._swap_live_npz(tree, meta)
            new_live = {"name": parent.get("name", "gen-?"),
                        "generation": live.get("generation", 1) - 1,
                        "digest": parent["digest"],
                        "checkpoint": src,
                        "parent": {}, "rolled_back_from": demoted,
                        "trigger": trigger}
            _write_json_atomic(self.live_json, new_live)
        else:
            # Parent is the rule profile: demotion = no live checkpoint.
            for path in (self.live_npz, self.live_json):
                if os.path.exists(path):
                    os.remove(path)
            new_live = {"name": RULE_INCUMBENT, "digest": "",
                        "rolled_back_from": demoted, "trigger": trigger}
        self._event("flywheel_rollback", trigger=trigger,
                    demoted=demoted.get("name"),
                    restored=new_live.get("name"),
                    incident=(incident or {}).get("id"))
        return new_live
