"""Per-family scenario scoreboard: policies x named workload scenarios.

The PyTorch form of `ccka_tpu/workloads/scoreboard.py`. Scores the rule,
the carbon teacher and the shipped learned flagship on the same
``n_traces`` paired worlds for each named scenario
(`workloads/scenarios.WORKLOAD_SCENARIOS`) through the rollout kernels,
and reports the aggregate $/SLO-hour next to the per-family columns that
separate policies the aggregate hides: inference SLO-violation ticks,
queue depth and load shed, batch deadline misses and backlog. Every row
of one scenario shares one stream and seed; every scenario's stream comes
from one seed, so their exo rows are bitwise shared and they differ only
by the family mix (and, for ``mixed``, its mild fault lanes). Each
scenario is scored under its own WorkloadsConfig (queue cap, SLO,
deadline), and one stream is resident at a time.

On the card it scores a full day (2880 ticks) in stochastic mode; with
``device="cpu"`` the plain rollout, deterministic, over 96 ticks. The
MPC-playback row waits for the plan kernel (ROADMAP queue B row 7, queue A
item 9): asking for it raises.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.faults.scoreboard import (check_policies, load_flagship,
                                              score_rows, summary_mean)
from ccka_tpu_torch.workloads.scenarios import (resolve_scenarios,
                                                scenario_source)

# The aggregate headline and the per-family columns of a row.
_ROW_FIELDS = ("usd_per_slo_hour", "slo_attainment",
               "inf_slo_violations", "inf_queue_mean", "inf_dropped",
               "batch_deadline_misses", "batch_backlog_mean")


def _row(summary) -> dict:
    return {k: summary_mean(getattr(summary, k)) for k in _ROW_FIELDS}


def workload_scoreboard(cfg: FrameworkConfig, *,
                        scenarios=("diurnal-inference", "flash-crowd",
                                   "batch-backfill", "mixed"),
                        policies=("rule", "carbon", "flagship"),
                        n_traces: int = 256, eval_steps: int | None = None,
                        seed: int = 31, trace_seed: int = 97,
                        device=None) -> dict:
    """The scenario board (module docstring). ``scenarios`` name
    `WORKLOAD_SCENARIOS` entries and ``policies`` rule, carbon and
    flagship, both checked before any stream is made."""
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.workloads.process import unpack_workload_lanes

    library = resolve_scenarios(scenarios)
    check_policies(policies)
    if n_traces < 1:
        raise ValueError(f"n_traces={n_traces} must be positive")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    steps = eval_steps or (2880 if on_card else 96)
    Z = cfg.cluster.n_zones
    out: dict = {
        "engine": "rollout kernels (workload lanes)" if on_card
                  else "plain rollout (workload lanes)",
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "n_traces": n_traces, "eval_steps": steps, "stochastic": on_card,
        "seed": seed, "trace_seed": trace_seed, "policies": list(policies),
        "row_fields": list(_ROW_FIELDS), "scenarios": {},
    }
    flagship = load_flagship(cfg, policies, out, dev)

    for name, sc in library.items():
        params = SimParams.from_config(
            dataclasses.replace(cfg, workloads=sc.workloads), device=dev)
        stream = scenario_source(cfg, sc).packed_trace_device(
            steps, trace_seed, n_traces, device=dev)
        rows = {p: _row(s) for p, s in score_rows(
            params, cfg, stream, steps, policies, flagship, seed=seed,
            stochastic=on_card).items()}
        wl = unpack_workload_lanes(stream, steps, Z)
        exposure = {
            "inference_arrivals_mean": summary_mean(wl.inf_arrivals),
            "batch_arrivals_mean": summary_mean(wl.batch_arrivals),
            "background_arrivals_mean": summary_mean(wl.bg_arrivals),
        }
        out["scenarios"][name] = {
            "description": sc.description,
            "family_mix": sc.family_mix(),
            "fault_preset": sc.fault_preset or None,
            "stream_rows": int(stream.shape[1]),
            "stream_bytes_per_cluster_tick": 4 * int(stream.shape[1]),
            "exposure": exposure,
            "rows": rows,
        }
        del stream, wl
        print(f"# workloads[{name}]: " + " ".join(
            f"{p}={r['inf_slo_violations']:.1f}viol/"
            f"{r['batch_deadline_misses']:.1f}miss"
            f"@{r['slo_attainment']:.3f}" for p, r in rows.items()),
            file=sys.stderr)

    # One line per policy across scenarios: the per-family comparison.
    boards = out["scenarios"]
    out["per_family_curves"] = {
        p: {"scenarios": list(boards),
            **{k: [boards[s]["rows"][p][k] for s in boards]
               for k in ("inf_slo_violations", "batch_deadline_misses",
                         "usd_per_slo_hour")}}
        for p in next(iter(boards.values()))["rows"]}
    return out
