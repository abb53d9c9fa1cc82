"""Fixed-action zone probes with the PyTorch port: is single-region zone carbon monetizable?

The port's twin of `scripts/zone_spread_probe.py` (no JAX). On the
single-region demo topology the zone-to-zone carbon spread (~6 %, one
grid) is too small for any zone-selection policy to cut gCO2/kreq without
paying cost or attainment; this script re-derives that evidence
(`data/zone_spread_probe.json`) on the port.

Method: paired evaluation (the same traces, the same world randomness) of
fixed zone-pinning actions against the rule baseline, on full-day
held-out stochastic traces from the bench's scoring family:

- ``neutral``      -- all zones open (the reset profile);
- ``pin:<zone>``   -- all provisioning forced into one zone, for each zone
  (a policy can only mix these; if no pure pin monetizes carbon, no
  mixture monetizes more than the best pin's margin);
- ``carbon``       -- the per-tick lowest-carbon zone follower with
  hysteresis (the multiregion flagship's teacher), the adaptive
  upper-envelope probe.

A probe "monetizes" the spread if it wins carbon beyond eval noise
(co2 ratio < 1 - 2 sigma of the per-trace ratio spread) while holding cost
(usd <= 1) and attainment (>= rule - 1e-3).

The held-out traces are one [n, T, ...] batch, scored by the port's
batch-first `evaluate_backend`; the world draws are the port's Philox
stream (the JAX script's are threefry), so a rerun matches the committed
artifact in its verdict and structure, not number for number.

Run from the repo root (``--device cpu`` on a host without CUDA):
    python scripts/torch_zone_spread_probe.py --out runs/zone_spread_probe.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ccka_tpu_torch import resolve_device  # noqa: E402
from ccka_tpu_torch.config import default_config  # noqa: E402
from ccka_tpu_torch.policy.base import PolicyBackend  # noqa: E402
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy  # noqa: E402
from ccka_tpu_torch.policy.rule import RulePolicy  # noqa: E402
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource  # noqa: E402
from ccka_tpu_torch.sim.types import Action  # noqa: E402
from ccka_tpu_torch.train.evaluate import evaluate_backend, heldout_traces  # noqa: E402

_ATTAIN_EPS = 1e-3


class FixedActionPolicy(PolicyBackend):
    """decide() returns one constant action: the pure-probe backend."""

    def __init__(self, action: Action, name: str):
        self._action = action
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def decide(self, state, exo, t):
        return self._action


def zone_pin_action(cluster, zone_index: int, device=None) -> Action:
    """Neutral profile with provisioning forced into one zone."""
    neutral = Action.neutral(cluster.n_pools, cluster.n_zones, device=device)
    w = torch.zeros_like(neutral.zone_weight)
    w[:, zone_index] = 1.0
    return neutral._replace(zone_weight=w)


def run_probe(steps: int, n_traces: int, seed0: int, *, device=None,
              traces=None, digits: int | None = 4) -> dict:
    """The probe record. ``traces`` ([n, T, ...], moved to ``device``)
    replaces the held-out draw; ``digits=None`` leaves every number
    unrounded (the record's keys stay)."""
    dev = resolve_device(device)
    cfg = default_config()
    cluster = cfg.cluster
    if traces is None:
        src = SyntheticSignalSource(cluster, cfg.workload, cfg.sim,
                                    cfg.signals)
        traces = heldout_traces(src, steps=steps, n=n_traces, seed0=seed0,
                                device=dev)
    traces = traces.to(dev)

    def rnd(v, nd=None):
        return v if digits is None else round(v, digits if nd is None
                                              else nd)

    # Measured zone carbon spread over the evaluation window.
    carbon = traces.carbon_g_kwh.detach().cpu().numpy()   # [n, T, Z]
    zone_mean = carbon.mean(axis=(0, 1))                  # [Z]
    spread = float(zone_mean.max() / zone_mean.min() - 1.0)

    backends: dict[str, PolicyBackend] = {
        "neutral": FixedActionPolicy(
            Action.neutral(cluster.n_pools, cluster.n_zones, device=dev),
            "neutral"),
        "carbon": CarbonAwarePolicy(cluster, device=dev),
    }
    for zi, zone in enumerate(cluster.zones):
        backends[f"pin:{zone}"] = FixedActionPolicy(
            zone_pin_action(cluster, zi, device=dev), f"pin:{zone}")

    rule = evaluate_backend(cfg, RulePolicy(cluster, device=dev), traces)
    probes = {}
    for name, backend in backends.items():
        res = evaluate_backend(cfg, backend, traces)
        usd = res["usd_per_slo_hour"] / max(rule["usd_per_slo_hour"], 1e-9)
        co2 = res["g_co2_per_kreq"] / max(rule["g_co2_per_kreq"], 1e-9)
        ratios = [a / max(b, 1e-9) for a, b in zip(
            res["per_trace"]["g_co2_per_kreq"],
            rule["per_trace"]["g_co2_per_kreq"])]
        noise = 2.0 * float(np.std(ratios)) if len(ratios) > 1 else 0.01
        monetizes = (co2 < 1.0 - noise
                     and usd <= 1.0
                     and res["slo_attainment"]
                     >= rule["slo_attainment"] - _ATTAIN_EPS)
        probes[name] = {
            "usd_ratio": rnd(usd),
            "co2_ratio": rnd(co2),
            "co2_ratio_per_trace": [rnd(r) for r in ratios],
            "co2_noise_2sigma": rnd(noise),
            "slo_attainment": rnd(res["slo_attainment"]),
            "monetizes_carbon": bool(monetizes),
        }
        print(f"# {name:>16}: usd x{usd:.4f} co2 x{co2:.4f} "
              f"attain {res['slo_attainment']:.4f}"
              f"{'  MONETIZES' if monetizes else ''}", file=sys.stderr)

    return {
        "config": "default (single-region)",
        "eval_steps": steps,
        "n_traces": n_traces,
        "seed0": seed0,
        "zone_carbon_mean_g_kwh": [rnd(float(v), 2) for v in zone_mean],
        "zone_carbon_spread": rnd(spread),
        "rule": {
            "usd_per_slo_hour": rnd(rule["usd_per_slo_hour"]),
            "g_co2_per_kreq": rnd(rule["g_co2_per_kreq"]),
            "slo_attainment": rnd(rule["slo_attainment"]),
        },
        "probes": probes,
        "any_probe_monetizes_carbon": bool(
            any(p["monetizes_carbon"] for p in probes.values())),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2880,
                    help="ticks per trace (2880 = one full day; shorter "
                         "windows never reach peak hours)")
    ap.add_argument("--traces", type=int, default=5)
    ap.add_argument("--seed0", type=int, default=10_000,
                    help="held-out seed block (bench scoring family)")
    ap.add_argument("--out", default="",
                    help="write the JSON artifact here (e.g. "
                         "runs/zone_spread_probe.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain rollout on the "
                         "host")
    args = ap.parse_args(argv)

    result = run_probe(args.steps, args.traces, args.seed0,
                       device=args.device)
    text = json.dumps(result, indent=2)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"# wrote {args.out}", file=sys.stderr)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
