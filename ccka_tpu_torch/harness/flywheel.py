"""FlywheelRunner: generations of the continual-learning loop on the fleet
service.

The PyTorch form of `ccka_tpu/harness/flywheel.py`. `train/flywheel.py`
owns the artifacts (mined cells, curricula, checksummed challenger
checkpoints, the atomic live swap); this module owns the PRODUCTION half
of each generation: the VirtualClock-driven fleet-service runs that (a)
record the ledgers the mine stage consumes and (b) ride the distilled
challenger as a tournament shadow lane on the incumbent's own dispatch
before any promotion. On the card each service tick is one CUDA graph
(`harness/service.py`).

1. **record**: serve ``record_ticks`` with the CURRENT incumbent,
   decision ledger + incident log + a carbon shadow lane enabled: the
   production evidence window (all JSONL, all under one scratch dir).
2. **mine -> label -> distill**: `Flywheel.mine` over the recorded
   window, `Flywheel.distill` into generation N's challenger.
3. **shadow**: slot the challenger checkpoint
   (`set_challenger_checkpoint`) and re-serve with the
   ``flywheel-challenger`` roster lane riding the incumbent's ticks: the
   challenger's per-workload-class win ledger against the live policy on
   live traffic.
4. **gate -> promote**: `promotion_gates` over the paired cell
   evaluation + the shadow board + the verified provenance (+ any bench
   history rows the caller passes); an eligible decision swaps the live
   checkpoint atomically, anything else leaves the incumbent untouched.
5. **watch -> roll back** (`divergence_rollback`): a post-promotion
   watch window with the divergence trigger armed; an edge-triggered
   ``policy_divergence`` incident demotes the challenger and restores the
   parent digest bitwise.

Determinism: every service run uses a fresh deterministic VirtualClock
and the one seed the runner was built with; reruns with the same seed
reproduce the same mined cells, the same challenger digests and the same
board counts.

A note on the tick cache: `_compiled_service_tick` is keyed on (cfg,
backend, n, horizon, device) with BACKENDS HASHED BY IDENTITY, and the
roster lanes are built inside it from ``cfg.obs.tournament_roster`` (on
the card they are captured into the tick's graph with the challenger's
weight tensors). So the runner constructs a FRESH incumbent backend
object per service run: a reused object could hit a cache entry whose
challenger lane was built from a PREVIOUS generation's slotted
checkpoint.
"""

from __future__ import annotations

import os

import numpy as np

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import SERVICE_PRESETS, FrameworkConfig, ObsConfig
from ccka_tpu_torch.train.checkpoint import load_params_npz
from ccka_tpu_torch.train.flywheel import (Flywheel, load_provenance,
                                           promotion_gates,
                                           set_challenger_checkpoint)

# The roster lane name the shadow stage rides (registered in
# obs/tournament.py; it reads the runner-slotted checkpoint).
CHALLENGER_LANE = "flywheel-challenger"


class FlywheelRunner:
    """Drive ``Flywheel`` generations on the fleet service loop, on the
    flywheel's device (the card unless it names the CPU)."""

    def __init__(self, cfg: FrameworkConfig, flywheel: Flywheel, *,
                 scratch: str, n_tenants: int = 6,
                 record_ticks: int = 20, shadow_ticks: int = 24,
                 watch_ticks: int = 12, top_k: int = 3,
                 seed: int = 211, shadow_win_rate: float = 0.5,
                 history_regressions=None, runlog=None):
        self.cfg = cfg
        self.fw = flywheel
        self.device = resolve_device(flywheel.device)
        self.scratch = os.path.abspath(scratch)
        self.n_tenants = int(n_tenants)
        self.record_ticks = int(record_ticks)
        self.shadow_ticks = int(shadow_ticks)
        self.watch_ticks = int(watch_ticks)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.shadow_win_rate = float(shadow_win_rate)
        self.history_regressions = history_regressions
        self.runlog = runlog
        self._run_idx = 0
        os.makedirs(self.scratch, exist_ok=True)
        # The tenant mix keeps every workload class on the board with
        # real comparisons: batch tenants map to the batch class, slow
        # ones to background.
        n_b = max(1, self.n_tenants // 3)
        self.profiles = (["healthy"] * (self.n_tenants - 2 * n_b)
                         + ["batch"] * n_b
                         + ["slow"] * n_b)[:self.n_tenants]

    # -- service plumbing ----------------------------------------------------

    def _clock(self):
        from ccka_tpu_torch.harness.service import VirtualClock

        state = {"s": 0.0}

        def base():
            state["s"] += 1e-4
            return state["s"]
        return VirtualClock(base=base)

    def _incumbent_backend(self):
        """A FRESH backend object for the live policy (see the module
        docstring's cache note): the rule profile until a promotion
        lands, the promoted checkpoint's PPOBackend after."""
        from ccka_tpu_torch.policy.rule import RulePolicy
        from ccka_tpu_torch.train.ppo import PPOBackend

        name, params = self.fw.incumbent()
        if params is None:
            return name, RulePolicy(self.cfg.cluster, device=self.device)
        return name, PPOBackend(self.cfg, params, device=self.device)

    def _serve(self, roster: tuple, ticks: int, *, backend=None,
               decisions: bool = False, **obs_kw) -> dict:
        from ccka_tpu_torch.harness.service import fleet_service_from_config

        self._run_idx += 1
        tag = f"run-{self._run_idx:02d}"
        paths = {
            "decisions": (os.path.join(self.scratch,
                                       f"{tag}-decisions.jsonl")
                          if decisions else ""),
            "tournament": (os.path.join(self.scratch,
                                        f"{tag}-tournament.jsonl")
                           if roster else ""),
            "incidents": os.path.join(self.scratch,
                                      f"{tag}-incidents.jsonl"),
        }
        run_cfg = self.cfg.with_overrides(**{
            "sim.horizon_steps": max(ticks + 8, 16),
            "obs.tournament_roster": roster,
        })
        obs = ObsConfig(
            enabled=True,
            decisions_enabled=decisions,
            decision_log_path=paths["decisions"],
            tournament_enabled=bool(roster),
            tournament_log_path=paths["tournament"],
            incident_log_path=paths["incidents"], **obs_kw)
        inc_name, inc_backend = (("custom", backend) if backend is not None
                                 else self._incumbent_backend())
        svc = fleet_service_from_config(
            run_cfg, inc_backend, self.n_tenants,
            profiles=self.profiles,
            service=SERVICE_PRESETS["default"], obs=obs,
            horizon_ticks=ticks + 4, seed=self.seed,
            clock=self._clock(), device=self.device)
        svc.warmup()
        svc.run(ticks)
        led = svc.tournament
        dl = svc.decisions
        out = {
            "paths": paths, "ticks": ticks, "incumbent": inc_name,
            "board": led._board() if led is not None else {},
            "decision_rows": dl.rows_total if dl is not None else 0,
            "diverged_total": (dl.diverged_total
                               if dl is not None else 0),
            "incidents": svc.incidents.counts(),
            "incident_records": list(svc.incidents.incidents),
            "usd_per_slo_hr": [round(float(v), 6)
                               for v in np.asarray(
                                   svc.tenant_usd_per_slo_hr())],
        }
        svc.close()
        return out

    # -- the generation ------------------------------------------------------

    def record(self) -> dict:
        """Stage 1: the production evidence window: the incumbent serving
        with the decision ledger, incident log and one carbon shadow lane
        (the board needs a candidate to ledger per-class wins against the
        live policy; carbon is checkpoint-free)."""
        return self._serve(("carbon",), self.record_ticks,
                           decisions=True)

    def shadow(self, checkpoint: str) -> dict:
        """Stage 3: the challenger rides the incumbent's dispatch as the
        ``flywheel-challenger`` lane, tight sliding window."""
        set_challenger_checkpoint(checkpoint)
        return self._serve((CHALLENGER_LANE,), self.shadow_ticks,
                           tournament_window=8,
                           tournament_sustain_ticks=4,
                           tournament_win_rate=0.6)

    def generation(self, gen: int) -> dict:
        """One full mine -> distill -> shadow -> gate -> maybe-promote
        turn. Returns the JSON-serializable generation record; the live
        checkpoint changes ONLY if every gate passed."""
        rec = self.record()
        cells = self.fw.mine(
            decisions_path=rec["paths"]["decisions"],
            tournament_path=rec["paths"]["tournament"],
            incidents_path=rec["paths"]["incidents"],
            top_k=self.top_k)
        # Paths out of the ledger window: the provenance digest must be
        # reproducible across reruns in fresh scratch dirs.
        window = {"ticks": rec["ticks"], "rows": rec["decision_rows"],
                  "diverged": rec["diverged_total"],
                  "incidents": rec["incidents"], "seed": self.seed}
        rep = self.fw.distill(cells, generation=gen,
                              ledger_window=window)
        ch_params, _meta = load_params_npz(rep["checkpoint"])
        eval_rows = self.fw.evaluate(ch_params, rep["produced"])
        sh = self.shadow(rep["checkpoint"])
        prov = load_provenance(
            os.path.join(self.fw.gen_dir(gen), "provenance.json"))
        decision = promotion_gates(
            eval_rows, shadow_board=sh["board"].get(CHALLENGER_LANE),
            provenance=prov,
            history_regressions=self.history_regressions,
            win_rate=self.shadow_win_rate)
        if self.runlog is not None:
            self.runlog.event("flywheel_gate", generation=gen,
                              eligible=decision["eligible"],
                              gates={k: v for k, v in
                                     decision["gates"].items()
                                     if isinstance(v, bool)})
        out = {
            "generation": gen,
            "incumbent": rec["incumbent"],
            "mined_cells": [{"scenario": c.scenario,
                             "intensity": c.intensity,
                             "class": c.workload_class,
                             "regime": c.tenant_regime,
                             "score": c.score} for c in cells],
            "curriculum": rep["curriculum"],
            "curriculum_digest": rep["curriculum_digest"],
            "checkpoint_digest": rep["checkpoint_digest"],
            "parent": rep["parent"],
            "ledger_window": window,
            "eval": eval_rows,
            "shadow_board": sh["board"].get(CHALLENGER_LANE),
            "shadow_incidents": sh["incidents"],
            "decision": decision,
            "promoted": False,
        }
        if decision["eligible"]:
            live = self.fw.promote(gen, decision)
            out["promoted"] = True
            out["live"] = {"name": live["name"],
                           "digest": live["digest"]}
        return out

    # -- the rollback demo ---------------------------------------------------

    def divergence_rollback(self) -> dict:
        """Stage 5: serve a post-promotion watch window with the
        divergence trigger armed (the promoted challenger against its
        rule shadow: a learned policy disagrees with the hand rule nearly
        every tick, so the windowed rate crosses the spike bar and stamps
        ONE edge-triggered ``policy_divergence`` incident), then demote
        and restore the parent digest bitwise."""
        name, backend = self._incumbent_backend()
        watch = self._serve((), self.watch_ticks, backend=backend,
                            decisions=True, decision_window=4,
                            divergence_spike_rate=0.5)
        watch["incumbent"] = name
        summary = {k: watch[k] for k in ("incidents", "decision_rows",
                                         "diverged_total", "incumbent")}
        div = [r for r in watch["incident_records"]
               if r.trigger == "policy_divergence"]
        if not div:
            return {"watch": summary, "rolled_back": False,
                    "reason": "no policy_divergence incident in the "
                              "watch window — nothing to demote"}
        new_live = self.fw.rollback(
            trigger="policy_divergence",
            incident={"id": div[0].id, "t": div[0].t})
        return {"watch": summary,
                "incident": {"id": div[0].id, "t": div[0].t},
                "rolled_back": True,
                "demoted": name,
                "restored": {"name": new_live.get("name"),
                             "digest": new_live.get("digest", "")}}

    def run(self, generations: int = 2, *,
            rollback_demo: bool = True) -> dict:
        """The full arc: N generations, then (optionally) the forced
        post-promotion divergence -> rollback demonstration."""
        gens = [self.generation(g) for g in
                range(1, int(generations) + 1)]
        out = {"generations": gens,
               "promotions": sum(g["promoted"] for g in gens),
               "status": self.fw.status()}
        if rollback_demo and any(g["promoted"] for g in gens):
            out["rollback"] = self.divergence_rollback()
            out["status_after_rollback"] = self.fw.status()
        return out

