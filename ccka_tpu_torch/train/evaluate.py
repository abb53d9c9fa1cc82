"""Head-to-head backend evaluation on held-out traces.

The PyTorch form of `ccka_tpu/train/evaluate.py`: every backend runs over
the same held-out stochastic worlds (the same traces and the same
interruption draws) and reports its mean EpisodeSummary KPIs and the
scalar objective. Batch first: the N held-out traces are one batch, and
the world randomness of trace i is the Philox stream of ``eval_seed`` at
cluster i, the same for every backend, so comparisons are paired.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.policy.base import PolicyBackend
from ccka_tpu_torch.signals.base import ExogenousTrace, SignalSource
from ccka_tpu_torch.sim.metrics import summarize
from ccka_tpu_torch.sim.rollout import initial_state, rollout
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train.objective import episode_objective


def heldout_traces(source: SignalSource, *, steps: int, n: int,
                   seed0: int = 10_000, device=None) -> ExogenousTrace:
    """[n, T, ...] evaluation traces from seeds disjoint from the training
    seeds (training uses seed + 1000 + i; evaluation starts at 10k)."""
    return source.batch_trace(steps, [seed0 + i for i in range(n)],
                              device=device)


def evaluate_backend(cfg: FrameworkConfig, backend: PolicyBackend,
                     traces: ExogenousTrace, *, stochastic: bool = True,
                     eval_seed: int = 0) -> dict:
    """Mean KPIs of one backend over the held-out batch, on the traces'
    device. Backends that replan (``requires_receding_horizon``) run
    their own closed loop (`train/mpc.py::MPCBackend.evaluate`)."""
    dev = traces.is_peak.device
    params = SimParams.from_config(cfg, device=dev)
    states0 = initial_state(cfg, traces.is_peak.shape[0], dev)
    if getattr(backend, "requires_receding_horizon", False):
        _, metrics = backend.evaluate(states0, traces, eval_seed,
                                      stochastic=stochastic)
    else:
        _, metrics = rollout(params, states0, backend.action_fn(), traces,
                             eval_seed, stochastic=stochastic)
    summary = summarize(params, metrics)
    out = {k: float(v.double().mean()) for k, v in summary._asdict().items()}
    out["objective_usd"] = float(
        episode_objective(metrics, cfg.train).double().mean())
    # Per-trace headline values, so a scoreboard can report the spread.
    out["per_trace"] = {
        k: np.asarray(getattr(summary, k).detach().cpu(),
                      np.float64).tolist()
        for k in ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment")}
    out["backend"] = backend.name
    return out


def compare_backends(cfg: FrameworkConfig,
                     backends: Mapping[str, PolicyBackend],
                     traces: ExogenousTrace, *,
                     stochastic: bool = True) -> dict[str, dict]:
    """Scoreboard ``{name: KPI dict}``, with the ratios to the 'rule'
    entry on the headline metrics and the objective when it is there."""
    results = {name: evaluate_backend(cfg, b, traces, stochastic=stochastic)
               for name, b in backends.items()}
    rule = results.get("rule")
    if rule:
        for name, r in results.items():
            if name == "rule":
                continue
            for k, key in (("usd_per_slo_hour", "vs_rule_usd_per_slo_hour"),
                           ("g_co2_per_kreq", "vs_rule_g_co2_per_kreq"),
                           ("objective_usd", "vs_rule_objective")):
                r[key] = r[k] / max(rule[k], 1e-9)
    return results
