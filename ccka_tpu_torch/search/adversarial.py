"""Adversarial scenario search: CEM over the scenario-parameter axis.

The PyTorch form of `ccka_tpu/search/adversarial.py`. Every CEM
iteration scores its whole population with one stream
(`search/axis.py::ScenarioAxisSource`, S candidates x B paired clusters)
and one launch of the policy's rollout kernel. The search maximizes a
per-policy degradation objective read off the kernel summaries (the
workload scoreboard's row fields, so searched and hand-named cells speak
one vocabulary), and the worst cell it finds is minted as a named,
reproducible `workloads/scenarios.py::Scenario`: explicit config
sections, the canonical params JSON and its sha256 digest (a tampered
record is refused) and the evaluation geometry that replays the recorded
objective.

Pairing: one stream seed drives every candidate (common random numbers:
the axis shares each family's draws across cells), so CEM compares
candidates on the same storms and flash crowds. The kernel's spot draws
are addressed by the global cluster, which is the stream's column, so in
stochastic mode cell s of a population draws other spot numbers than the
same parameters at S = 1. The minted objective is therefore an S = 1
re-score, which :func:`replay_minted` reproduces exactly on the same
device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import (FAULT_PRESETS, FaultsConfig, GeoConfig,
                                   WorkloadsConfig)
from ccka_tpu_torch.obs.trace import SpanTracer
from ccka_tpu_torch.search.axis import ScenarioAxisSource, summary_cells
from ccka_tpu_torch.search.params import (PARAM_NAMES, SEARCH_BOUNDS,
                                          ScenarioParams, params_digest,
                                          validate_bounds)

# The packed policy modes the search scores without artifacts (a learned
# policy or a plan needs its checkpoint or planner; pass a prebuilt
# scorer for those).
SEARCH_POLICIES = ("rule", "carbon")

# Degradation objectives: the scoreboard's row vocabulary. The search
# maximizes sign * value ("worse for the policy" is up).
_OBJECTIVE_SIGN = {"usd_per_slo_hour": 1.0, "slo_attainment": -1.0,
                   "inf_slo_violations": 1.0, "inf_queue_mean": 1.0,
                   "inf_dropped": 1.0, "batch_deadline_misses": 1.0,
                   "batch_backlog_mean": 1.0}

# Intensity presets: the share of the full box the search may explore
# (upper bounds scaled toward the lower; "severe" is the full box).
_INTENSITY_FRACTION = {"mild": 0.25, "moderate": 0.5, "severe": 1.0}


def intensity_bounds(level: str | None) -> dict:
    """Bounds scaling every knob's upper bound to the intensity preset's
    share of the full box (None: the full box). Unknown levels are
    refused up front."""
    if level is None:
        return {}
    if level not in _INTENSITY_FRACTION:
        raise ValueError(f"unknown intensity {level!r}; levels: "
                         f"{sorted(_INTENSITY_FRACTION)}")
    f = _INTENSITY_FRACTION[level]
    return {n: (lo, lo + f * (hi - lo))
            for n, (lo, hi) in SEARCH_BOUNDS.items()}


def resolve_objective(name: str) -> float:
    """The objective's maximization sign; unknown names are refused up
    front with the vocabulary."""
    if name not in _OBJECTIVE_SIGN:
        raise ValueError(f"unknown objective {name!r}; objectives: "
                         f"{sorted(_OBJECTIVE_SIGN)}")
    return _OBJECTIVE_SIGN[name]


class ScenarioScorer:
    """One policy's evaluation harness over the scenario-parameter axis:
    a `ScenarioAxisSource` with all three searchable families and the
    mode's whole-stream entry (`sim/megakernel.py::packed_mode_summary_fn`).
    :meth:`score` scores any S-batch of params with one stream and one
    launch; hand-named scenarios go through the same harness
    (`ScenarioParams.from_config`).

    The geometry defaults to the JAX package's: on the card T = 2880,
    ``inner_batch`` 64, ``t_chunk`` 64, stochastic; on the CPU 96 ticks,
    inner 4, ``t_chunk`` 32, deterministic. The kernel-side workload knobs
    (queue depth, SLO, deadlines) stay those of ``base_workloads`` for
    every cell: the search perturbs the world, never the meter.

    ``stages``: one record per score, ``{"S", "synthesis_s", "kernel_s",
    "host_s", "stream_bytes"}``, each stage a span fenced on its result.
    The population stream is written into one buffer, kept while S stays
    the same and freed before a stream of another width is made."""

    def __init__(self, cfg, *, policy: str = "rule",
                 steps: int | None = None, inner_batch: int | None = None,
                 t_chunk: int | None = None, b_block: int | None = None,
                 seed: int = 0,
                 base_faults: FaultsConfig | None = None,
                 base_workloads: WorkloadsConfig | None = None,
                 base_geo: GeoConfig | None = None, device=None):
        from ccka_tpu_torch.sim.megakernel import packed_mode_summary_fn
        from ccka_tpu_torch.sim.types import SimParams

        if policy not in SEARCH_POLICIES:
            raise ValueError(
                f"unknown search policy {policy!r}; artifact-free "
                f"policies: {list(SEARCH_POLICIES)}")
        self.device = resolve_device(device)
        self.on_card = self.device.type == "cuda"
        self.policy = policy
        self.steps = int(steps if steps is not None
                         else (2880 if self.on_card else 96))
        self.inner = int(inner_batch if inner_batch is not None
                         else (64 if self.on_card else 4))
        self.t_chunk = int(t_chunk if t_chunk is not None
                           else (64 if self.on_card else 32))
        # Recorded in a minted document's eval block (the JAX package's
        # kernel grid); the port's kernel takes the whole stream.
        self.b_block = int(b_block if b_block is not None else self.inner)
        self.t_pad = math.ceil(self.steps / self.t_chunk) * self.t_chunk
        self.seed = int(seed)
        self.cfg = cfg
        self.base_faults = base_faults or FaultsConfig(enabled=True)
        self.base_workloads = base_workloads or WorkloadsConfig(
            enabled=True)
        self.base_geo = base_geo or GeoConfig(enabled=True)
        sim_cfg = dataclasses.replace(
            cfg, faults=self.base_faults, workloads=self.base_workloads,
            geo=self.base_geo)
        self.sim_params = SimParams.from_config(sim_cfg, device=self.device)
        self.source = ScenarioAxisSource(
            cfg.cluster, cfg.workload, cfg.sim, cfg.signals,
            ScenarioParams.from_config(
                faults=self.base_faults, workloads=self.base_workloads,
                geo=self.base_geo),
            faults=self.base_faults, workloads=self.base_workloads,
            geo=self.base_geo)
        self.mode_fn = packed_mode_summary_fn(
            self.sim_params, cfg.cluster, policy, T=self.steps,
            stochastic=self.on_card)
        self.evals = 0
        self.stages: list = []
        self._tracer = SpanTracer(max_spans=64)
        self._buf = None

    def _stream(self, S: int) -> torch.Tensor:
        """The stream buffer of an S-cell batch (another width frees the
        old buffer first)."""
        shape = (self.t_pad, self.source.packed_rows(), S * self.inner)
        if self._buf is None or tuple(self._buf.shape) != shape:
            self._buf = None
            self._buf = torch.empty(shape, dtype=torch.float32,
                                    device=self.device)
        return self._buf

    def release(self) -> None:
        """Free the stream buffer."""
        self._buf = None

    def score(self, params: ScenarioParams) -> dict:
        """{field: float64 [S]} per-cell objectives of one params batch:
        one stream, one kernel launch."""
        tr = self._tracer
        self.source.set_params(params)
        with tr.span("search.synthesis") as sp:
            stream = self.source.packed_trace_device(
                self.steps, self.seed, params.S * self.inner,
                t_pad=self.t_pad, out=self._stream(params.S))
            sp.fence(stream)
        with tr.span("search.kernel") as sk:
            summary = self.mode_fn(stream, self.seed)
            sk.fence(summary)
        with tr.span("search.host") as sh:
            cells = summary_cells(summary, params.S)
        self.evals += params.S
        self.stages.append({"S": params.S, "synthesis_s": sp.dur_s,
                            "kernel_s": sk.dur_s, "host_s": sh.dur_s,
                            "stream_bytes": stream.numel() * 4})
        return cells

    def score_scenario(self, scenario) -> dict:
        """A hand-named (or minted) `Scenario` through the same harness:
        its config sections -> S = 1 params -> one cell. {field: float}."""
        faults = scenario.faults
        if faults is None and scenario.fault_preset:
            faults = FAULT_PRESETS[scenario.fault_preset]
        p = ScenarioParams.from_config(faults=faults,
                                       workloads=scenario.workloads,
                                       geo=scenario.geo)
        return {k: float(v[0]) for k, v in self.score(p).items()}


@dataclasses.dataclass
class SearchResult:
    """A finished adversarial search: the minted worst case and its
    evidence (per-iteration history, the hand-named cells on the same
    harness, the evaluation geometry for replay)."""

    policy: str
    objective: str
    best_value: float          # raw objective field value, S = 1 re-score
    best_cells: dict           # every row field at the worst cell (S = 1)
    best_params: ScenarioParams
    scenario: object           # minted workloads/scenarios.Scenario
    hand_named: dict           # scenario name -> objective field value
    dominates: bool            # strictly worse than every hand-named cell
    history: list
    evals: int
    settings: dict

    def to_doc(self) -> dict:
        """The ``--mint-out`` document (:func:`replay_minted` reads it)."""
        return {
            "scenario": self.scenario.to_doc(),
            "objective": {"field": self.objective,
                          "value": self.best_value,
                          "cells": self.best_cells,
                          "hand_named": self.hand_named,
                          "dominates": self.dominates},
            "eval": dict(self.settings),
            "history": self.history,
            "evals": self.evals,
        }


def search_scenarios(cfg, *, policy: str = "rule",
                     objective: str = "usd_per_slo_hour",
                     iters: int = 5, pop: int = 12,
                     elite_frac: float = 0.25, seed: int = 0,
                     bounds: dict | None = None,
                     intensity: str | None = None,
                     scorer: ScenarioScorer | None = None,
                     mint_name: str | None = None,
                     runlog=None, device=None) -> SearchResult:
    """CEM worst-case search over `ScenarioParams` within the validated
    box: ``pop`` candidates an iteration in one stream and one launch,
    elites refit a diagonal Gaussian in normalized box coordinates, and
    the worst cell found is minted as a named reproducible `Scenario`.
    Deterministic under a fixed ``seed`` (host numpy proposals, a fixed
    stream seed) on one device.

    ``bounds`` ({name: (lo, hi)}) overrides the box per knob;
    ``intensity`` scales the whole box ("mild", "moderate", "severe");
    both are checked up front, before any stream is made. ``runlog`` (an
    `obs/runlog.py::RunLog`) records a ``search_iter`` event per
    iteration and a final ``search_mint``. ``device`` is the scorer's
    when none is given (the card unless the caller names another)."""
    sign = resolve_objective(objective)
    box = dict(SEARCH_BOUNDS)
    box.update(intensity_bounds(intensity))
    if bounds:
        validate_bounds(bounds)
        box.update(bounds)
    validate_bounds(box)
    if iters < 1 or pop < 2:
        raise ValueError(f"need iters >= 1 and pop >= 2; got "
                         f"iters={iters}, pop={pop}")
    scorer = scorer or ScenarioScorer(cfg, policy=policy, seed=seed,
                                      device=device)

    rng = np.random.default_rng(seed)
    lo = np.asarray([box[n][0] for n in PARAM_NAMES], np.float64)
    hi = np.asarray([box[n][1] for n in PARAM_NAMES], np.float64)
    span = hi - lo
    span_safe = np.where(span > 0, span, 1.0)
    k_elite = max(1, int(round(pop * elite_frac)))
    mu = np.full(len(PARAM_NAMES), 0.5)
    sd = np.full(len(PARAM_NAMES), 0.25)
    best_signed, best_params, history = -np.inf, None, []

    for it in range(iters):
        xn = np.clip(mu + sd * rng.standard_normal((pop, len(PARAM_NAMES))),
                     0.0, 1.0)
        cand = ScenarioParams.from_array(lo + xn * span).clip_to_bounds(box)
        vals = sign * scorer.score(cand)[objective]        # [pop]
        order = np.argsort(-vals)
        elite_nat = cand.to_array()[order[:k_elite]]
        elite_n = (elite_nat - lo) / span_safe
        mu = elite_n.mean(axis=0)
        sd = np.maximum(elite_n.std(axis=0), 0.05)
        if float(vals[order[0]]) > best_signed:
            best_signed = float(vals[order[0]])
            best_params = cand.row(int(order[0]))
        row = {"iter": it, "pop": pop,
               "best": round(float(vals[order[0]]) * sign, 6),
               "mean": round(float(vals.mean()) * sign, 6),
               "elite_mean": round(float(vals[order[:k_elite]].mean())
                                   * sign, 6)}
        history.append(row)
        if runlog is not None:
            runlog.event("search_iter", policy=policy,
                         objective=objective, **row)

    # The authoritative S = 1 re-score: the minted record is what a
    # replay of the minted cell computes (module docstring).
    cells1 = {k: float(v[0]) for k, v in scorer.score(best_params).items()}
    best_value = cells1[objective]

    # The hand-named library through the same harness: the dominance
    # claim is same-vocabulary, same-world, same-geometry.
    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    Scenario)

    hand = {name: scorer.score_scenario(sc)[objective]
            for name, sc in WORKLOAD_SCENARIOS.items()}
    hand_worst_signed = max(sign * v for v in hand.values())
    dominates = sign * best_value > hand_worst_signed

    pj = best_params.to_json()
    dig = params_digest(pj)
    fa, wl, geo = best_params.to_config(
        0, base_faults=scorer.base_faults,
        base_workloads=scorer.base_workloads, base_geo=scorer.base_geo)
    name = mint_name or f"minted-{policy}-{dig[:8]}"
    scenario = Scenario(
        name=name,
        description=(f"adversarial worst case for policy {policy!r} on "
                     f"{objective} (CEM, seed {seed}, "
                     f"{scorer.evals} cells evaluated)"),
        workloads=wl, faults=fa, geo=geo, params_json=pj,
        params_digest=dig,
        minted_by=(f"search/adversarial.search_scenarios iters={iters} "
                   f"pop={pop} elite_frac={elite_frac} seed={seed}"
                   + (f" intensity={intensity}" if intensity else "")))
    scenario.validate()

    settings = {"policy": policy, "objective": objective,
                "steps": scorer.steps, "inner_batch": scorer.inner,
                "t_chunk": scorer.t_chunk, "b_block": scorer.b_block,
                "seed": scorer.seed,
                "backend": "cuda" if scorer.on_card else "cpu",
                "iters": iters, "pop": pop, "elite_frac": elite_frac,
                "bounds": {n: list(box[n]) for n in PARAM_NAMES}}
    result = SearchResult(
        policy=policy, objective=objective, best_value=best_value,
        best_cells=cells1, best_params=best_params, scenario=scenario,
        hand_named=hand, dominates=dominates, history=history,
        evals=scorer.evals, settings=settings)
    if runlog is not None:
        runlog.event("search_mint", name=name, digest=dig,
                     policy=policy, objective=objective,
                     value=round(best_value, 6),
                     dominates=bool(dominates))
    return result


def replay_minted(cfg, doc: dict, *, device=None) -> dict:
    """Score a minted scenario document again in its recorded geometry:
    the scenario is digest-checked, the S = 1 params and a scorer are
    rebuilt from ``doc["eval"]``, and {field: value} comes back. On the
    device it was minted on this reproduces ``doc["objective"]["value"]``
    exactly (same stream seed, kernel seed and geometry)."""
    from ccka_tpu_torch.workloads.scenarios import scenario_from_doc

    sc = scenario_from_doc(doc["scenario"])
    if not sc.minted:
        raise ValueError(f"scenario {sc.name!r} carries no mint "
                         "provenance — nothing to replay")
    params = ScenarioParams.from_json(sc.params_json)
    ev = doc["eval"]
    scorer = ScenarioScorer(
        cfg, policy=ev["policy"], steps=ev["steps"],
        inner_batch=ev["inner_batch"], t_chunk=ev["t_chunk"],
        b_block=ev.get("b_block"), seed=ev["seed"], device=device)
    return {k: float(v[0]) for k, v in scorer.score(params).items()}
