"""Paired robustness scoreboard: policies x fault intensities.

The PyTorch form of `ccka_tpu/faults/scoreboard.py`. Scores the rule,
the carbon teacher, the shipped learned flagship and diff-MPC plan
playback on the same ``n_traces`` paired worlds at each named fault
intensity (`config.FAULT_PRESETS`) through the rollout kernels, and
reports $/SLO-hour degradation curves with interruption, denial and stale
counts. The pairings:

- across policies, every row of one intensity shares one stream and seed:
  the same worlds and the same fault realization;
- across intensities, every stream comes from one seed: the exo rows are
  bitwise shared and the fault latents are the same storms at rising
  severity (nested windows), a dose-response;
- MPC plans once on the calm world (the shared exo rows: storms are not
  forecastable) with the boards' quick planner, and the plan kernel plays
  that plan back on every intensity.

On the card it scores a full day (2880 ticks) in stochastic mode; with
``device="cpu"`` the plain rollout, deterministic, over 96 ticks.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import FAULT_PRESETS, FrameworkConfig

_CURVE_FIELDS = ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment",
                 "interruptions", "denials", "stale_ticks")
KNOWN_POLICIES = ("rule", "carbon", "flagship", "mpc")
# The boards' quick planner (the JAX boards' own settings).
QUICK_PLANNER = dict(horizon=8, replan_every=8, iters=2)


def check_policies(policies) -> None:
    """Reject unknown policy names up front."""
    bad = [p for p in policies if p not in KNOWN_POLICIES]
    if bad:
        raise ValueError(f"unknown policies {bad}; known: "
                         f"{list(KNOWN_POLICIES)}")


def summary_mean(x: torch.Tensor) -> float:
    return round(float(x.double().mean()), 4)


def _row(summary) -> dict:
    out = {k: summary_mean(getattr(summary, k)) for k in _CURVE_FIELDS}
    out["per_trace_usd_per_slo_hour"] = (
        summary.usd_per_slo_hour.detach().double().cpu().numpy())
    return out


def _vs_calm(row: dict, calm_per_trace: np.ndarray) -> None:
    """Paired per-trace degradation against the same policy's calm ('off')
    row: mean ratio and its standard error."""
    r = (row.pop("per_trace_usd_per_slo_hour")
         / np.maximum(calm_per_trace, 1e-9))
    row["vs_calm_usd_per_slo_hour"] = round(float(r.mean()), 4)
    if r.size >= 2:
        row["vs_calm_usd_per_slo_hour_se"] = round(
            float(r.std(ddof=1) / np.sqrt(r.size)), 5)


def plan_mpc(cfg: FrameworkConfig, stream: torch.Tensor, steps: int,
             what: str) -> tuple[torch.Tensor, dict]:
    """The mpc row's plan: the quick receding-horizon planner on the
    stream's exo rows (the clean world) from fresh clusters at the zero
    latent, one plan per cluster, packed for the plan kernel. Returns
    ``(plan_packed, the board's mpc_planner record)``."""
    from ccka_tpu_torch.models.nets import latent_to_action
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train.mpc import (receding_horizon_plan_batch,
                                          zero_latent)

    dev = stream.device
    n = stream.shape[2]
    H = QUICK_PLANNER["horizon"]
    t0 = time.perf_counter()
    lat0 = zero_latent(cfg.cluster, dev)
    plans = receding_horizon_plan_batch(
        SimParams.from_config(cfg, device=dev), cfg.cluster, cfg.train,
        initial_state(cfg, n, dev),
        mk.unpack_exo(stream, steps, cfg.cluster.n_zones),
        lat0.expand(n, H, *lat0.shape), **QUICK_PLANNER)
    plan_packed = mk.pack_plan(latent_to_action(plans, cfg.cluster),
                               stream.shape[0])
    del plans
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return plan_packed, dict(QUICK_PLANNER, n_traces=n, mode=what,
                             seconds=time.perf_counter() - t0)


def score_rows(params, cfg: FrameworkConfig, stream: torch.Tensor,
               steps: int, policies, flagship, *, seed: int,
               stochastic: bool, plan_packed=None) -> dict:
    """Each policy's EpisodeSummary on one packed stream and seed (the
    rows of both boards), in the order rule, carbon, flagship, mpc (the
    plan kernel on ``plan_packed``)."""
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
    from ccka_tpu_torch.sim import megakernel as mk

    dev = stream.device
    off, peak = offpeak_action(cfg.cluster, dev), peak_action(cfg.cluster,
                                                              dev)
    cp = CarbonAwarePolicy(cfg.cluster, device=dev)
    kw = dict(seed=seed, stochastic=stochastic)
    out = {}
    for p in ("rule", "carbon", "flagship"):
        if p not in policies:
            continue
        if p == "rule":
            out[p] = mk.megakernel_summary_from_packed(
                params, off, peak, stream, steps, **kw)
        elif p == "carbon":
            out[p] = mk.carbon_megakernel_summary_from_packed(
                params, off, peak, stream, steps, sharpness=cp.sharpness,
                min_weight=cp.min_weight, stickiness=cp.stickiness, **kw)
        elif p == "flagship" and flagship is not None:
            out[p] = mk.neural_megakernel_summary_from_packed(
                params, cfg.cluster, flagship.params, stream, steps, **kw)
    if "mpc" in policies:
        out["mpc"] = mk.plan_megakernel_summary_from_packed(
            params, cfg.cluster, plan_packed, stream, steps, **kw)
    return out


def load_flagship(cfg: FrameworkConfig, policies, out: dict, device):
    """The shipped flagship when ``policies`` asks for it (else None),
    with its provenance on the board."""
    if "flagship" not in policies:
        return None
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    flagship, meta = load_flagship_backend(cfg, device=device)
    if flagship is None:
        out["flagship_source"] = ("omitted: no flagship checkpoint for "
                                  "this topology (no stand-ins)")
    else:
        out["flagship_source"] = {
            "checkpoint": "topology-keyed flagship",
            "selected_iteration": meta.get("selected_iteration")}
    return flagship


def fault_scoreboard(cfg: FrameworkConfig, *,
                     intensities=("off", "mild", "moderate", "severe"),
                     policies=("rule", "flagship", "mpc"),
                     n_traces: int = 256, eval_steps: int | None = None,
                     seed: int = 31, trace_seed: int = 97,
                     device=None, plan_out: dict | None = None) -> dict:
    """The robustness board (module docstring). ``intensities`` must
    include "off" (the calm denominator) and name `FAULT_PRESETS`
    entries; ``policies`` name rule, carbon, flagship and mpc. One
    stream is resident at a time. A ``plan_out`` dict receives the mpc
    row's packed plan under "plan_packed"."""
    from ccka_tpu_torch.faults.process import unpack_fault_lanes
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim.types import SimParams

    bad = [i for i in intensities if i not in FAULT_PRESETS]
    if bad:
        raise ValueError(f"unknown fault intensities {bad}; presets: "
                         f"{sorted(FAULT_PRESETS)}")
    if "off" not in intensities:
        raise ValueError('intensities must include "off" (the calm '
                         "denominator of every degradation curve)")
    check_policies(policies)
    if n_traces < 1:
        raise ValueError(f"n_traces={n_traces} must be positive")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    steps = eval_steps or (2880 if on_card else 96)
    params = SimParams.from_config(cfg, device=dev)
    Z = cfg.cluster.n_zones
    out: dict = {
        "engine": "rollout kernels (fault lanes)" if on_card
                  else "plain rollout (fault lanes)",
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "n_traces": n_traces, "eval_steps": steps, "stochastic": on_card,
        "seed": seed, "trace_seed": trace_seed, "policies": list(policies),
        "intensities": {},
    }
    flagship = load_flagship(cfg, policies, out, dev)

    boards: dict[str, dict] = {}
    plan_packed = None
    for name in intensities:
        stream = SyntheticSignalSource(
            cfg.cluster, cfg.workload, cfg.sim, cfg.signals,
            faults=FAULT_PRESETS[name]).packed_trace_device(
                steps, trace_seed, n_traces, device=dev)
        if "mpc" in policies and plan_packed is None:
            # Every intensity's exo rows are the calm world's, bitwise.
            plan_packed, out["mpc_planner"] = plan_mpc(
                cfg, stream, steps,
                "quick plan (clean world) -> plan kernel (faulted)")
            if plan_out is not None:
                plan_out["plan_packed"] = plan_packed
        rows = {p: _row(s) for p, s in score_rows(
            params, cfg, stream, steps, policies, flagship, seed=seed,
            stochastic=on_card, plan_packed=plan_packed).items()}
        # Stream-level exposure, the same for every row: the pairing.
        fs = unpack_fault_lanes(stream, steps, Z)
        exposure = {
            "stale_tick_frac": summary_mean(fs.signal_stale),
            "ice_tick_frac": summary_mean((fs.deny_frac > 0).float()),
            "mean_hazard": round(float(fs.preempt_hazard.double().mean()),
                                 3),
        }
        del stream, fs
        boards[name] = {"faults": dataclasses.asdict(FAULT_PRESETS[name]),
                        "exposure": exposure, "rows": rows}
        print(f"# faults[{name}]: " + " ".join(
            f"{p}={r['usd_per_slo_hour']:.3f}$/slo-hr"
            f"@{r['slo_attainment']:.3f}" for p, r in rows.items()),
            file=sys.stderr)

    # Degradation curves, paired per trace against the calm intensity.
    calm = {p: row["per_trace_usd_per_slo_hour"]
            for p, row in boards["off"]["rows"].items()}
    for name in intensities:
        for p, row in boards[name]["rows"].items():
            _vs_calm(row, calm[p])
    curves = {}
    for p in boards["off"]["rows"]:
        curves[p] = {
            "intensities": list(intensities),
            **{k: [boards[i]["rows"][p][k] for i in intensities]
               for k in ("usd_per_slo_hour", "vs_calm_usd_per_slo_hour",
                         "slo_attainment", "interruptions")},
        }
    out["intensities"] = boards
    out["degradation_curves"] = curves
    return out
