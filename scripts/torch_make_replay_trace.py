"""Generate the committed replay traces with the PyTorch port (no JAX).

The port's twin of `scripts/make_replay_trace.py`: the same generative
family, the same `np.random.Generator(PCG64(seed))` calls in the same
order, so each variant's arrays are bitwise the committed store's, saved
through `ccka_tpu_torch.signals.replay.save_trace`:

- demand: weekday double-peak (09:30 / 19:30 local) with a lunch dip,
  heavy-tailed flash-crowd bursts, and quieter alternate days;
- spot $/hr: per-zone mean-reverting walk around the m6i.large historical
  band (~$0.03) with capacity-crunch spikes during demand peaks;
- carbon gCO2/kWh: CAISO-shaped duck curve (midday solar dip, steep
  evening ramp) with cloudy alternate days that halve the dip;
- on-demand $/hr: flat per zone.

The arrays are what is reproduced, not the files' bytes: the committed
`data/replay_2day.npz` carries an older description ("... cloudy day 2")
than the script's meta ("... cloudy alt days").

Host numpy only: it runs on no device. Run from the repo root:

    python scripts/torch_make_replay_trace.py --variant train9
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ccka_tpu_torch.config import default_config  # noqa: E402
from ccka_tpu_torch.signals.base import (ExogenousTrace, TraceMeta,  # noqa: E402
                                         as_f32)
from ccka_tpu_torch.signals.replay import save_trace  # noqa: E402

SEED = 20260730
DAYS = 2
_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data")
OUT = os.path.join(_DATA, "replay_2day.npz")
# Train variant: the same family, another realization, 6 days: the
# replay-family fine-tuning data.
TRAIN_SEED = 20260731
TRAIN_DAYS = 6
OUT_TRAIN = os.path.join(_DATA, "replay_train_6day.npz")
# The long variants: a 5-day eval trace (>= 5 day-scale windows for the
# replay scoreboard) and a 9-day training realization (6 train + 3
# holdout days -> 5 half-day-staggered selection windows).
EVAL5_SEED = 20260801
EVAL5_DAYS = 5
OUT_EVAL5 = os.path.join(_DATA, "replay_5day.npz")
TRAIN9_SEED = 20260802
TRAIN9_DAYS = 9
OUT_TRAIN9 = os.path.join(_DATA, "replay_train_9day.npz")

VARIANTS = {
    "eval": (SEED, DAYS, OUT),
    "train": (TRAIN_SEED, TRAIN_DAYS, OUT_TRAIN),
    "eval5": (EVAL5_SEED, EVAL5_DAYS, OUT_EVAL5),
    "train9": (TRAIN9_SEED, TRAIN9_DAYS, OUT_TRAIN9),
}


def build_trace(cfg, *, seed: int = SEED,
                days: int = DAYS) -> tuple[ExogenousTrace, TraceMeta]:
    """The [T, ...] trace (float32 CPU tensors) and its provenance."""
    rng = np.random.Generator(np.random.PCG64(seed))
    dt_s = cfg.sim.dt_s
    steps = int(days * 86400 / dt_s)
    z = cfg.cluster.n_zones
    t_hr = (np.arange(steps) * dt_s / 3600.0) % 24.0       # local hour
    day = (np.arange(steps) * dt_s // 86400).astype(int)

    # -- demand: double peak + lunch dip + flash crowds -------------------
    total = cfg.workload.total_pods
    peak1 = np.exp(-0.5 * ((t_hr - 9.5) / 2.0) ** 2)
    peak2 = np.exp(-0.5 * ((t_hr - 19.5) / 2.5) ** 2)
    lunch_dip = 1.0 - 0.25 * np.exp(-0.5 * ((t_hr - 13.0) / 1.0) ** 2)
    base_level = 0.35 + 0.85 * np.maximum(peak1, peak2)
    base_level *= lunch_dip
    base_level *= np.where(day % 2 == 1, 0.8, 1.0)           # quieter alt days
    # Flash crowds: ~6 events/day, 10-30 min, 1.3-2x multiplier.
    burst = np.ones(steps)
    n_events = rng.poisson(6 * days)
    for _ in range(n_events):
        start = rng.integers(0, steps)
        dur = int(rng.integers(20, 60))
        burst[start:start + dur] *= rng.uniform(1.3, 2.0)
    noise = np.exp(rng.normal(0.0, 0.06, size=steps))        # log-normal
    demand_total = total * base_level * burst * noise
    split = 0.55 + 0.05 * np.sin(2 * np.pi * t_hr / 24.0)    # class drift
    demand = np.stack([demand_total * split,
                       demand_total * (1.0 - split)], axis=-1)

    # -- spot prices: mean-reverting walk + crunch spikes -----------------
    nt = cfg.cluster.node_type
    mean_z = nt.spot_price_hr_mean * (1.0 + 0.08 * np.arange(z) / max(z - 1, 1)
                                      - 0.04)                # per-zone band
    spot = np.empty((steps, z))
    x = np.zeros(z)
    for i in range(steps):
        # OU step toward 0 (log-deviation), tick-scale vol.
        x += -0.02 * x + rng.normal(0.0, 0.015, size=z)
        crunch = 1.0 + 0.6 * max(base_level[i] - 1.0, 0.0)   # peak crunch
        spot[i] = mean_z * np.exp(x) * crunch
    # Occasional zone-local spot spikes (capacity reclaim events).
    for _ in range(rng.poisson(3 * days)):
        zi = rng.integers(0, z)
        start = rng.integers(0, steps)
        dur = int(rng.integers(10, 40))
        spot[start:start + dur, zi] *= rng.uniform(1.5, 2.4)
    spot = np.clip(spot, 0.2 * nt.od_price_hr, 0.95 * nt.od_price_hr)

    # -- on-demand: flat per zone -----------------------------------------
    od = np.tile(nt.od_price_hr * (1.0 + 0.01 * np.arange(z)), (steps, 1))

    # -- carbon: duck curve + cloudy alternate days -----------------------
    base_c = 420.0
    solar = np.exp(-0.5 * ((t_hr - 12.5) / 2.8) ** 2)        # midday sun
    dip_depth = np.where(day % 2 == 1, 0.22, 0.45)
    evening_ramp = 0.18 * np.exp(-0.5 * ((t_hr - 19.0) / 1.5) ** 2)
    carbon_t = base_c * (1.0 - dip_depth * solar + evening_ramp)
    zone_off = 1.0 + 0.06 * (np.arange(z) / max(z - 1, 1) - 0.5)
    carbon = carbon_t[:, None] * zone_off[None, :]
    carbon += rng.normal(0.0, 6.0, size=(steps, z))          # metering noise
    carbon = np.clip(carbon, 80.0, None)

    is_peak = ((t_hr >= 9.0) & (t_hr < 21.0)).astype(np.float32)

    trace = ExogenousTrace(
        spot_price_hr=as_f32(spot), od_price_hr=as_f32(od),
        carbon_g_kwh=as_f32(carbon), demand_pods=as_f32(demand),
        is_peak=as_f32(is_peak))
    meta = TraceMeta(
        source="generated-replay",
        start_unix_s=0.0, dt_s=dt_s, zones=cfg.cluster.zones,
        description=(f"deterministic {days}-day replay trace, seed {seed} "
                     "(scripts/make_replay_trace.py): double-peak weekday "
                     "demand + flash crowds, OU spot walk + crunch "
                     "spikes, duck-curve carbon with cloudy alt days"))
    return trace, meta


def main(argv=None, *, cfg=None, out: str | None = None) -> int:
    """``cfg`` (default: the default preset) and ``out`` (default: the
    variant's path under data/) let a caller build elsewhere."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="eval",
                    choices=("eval", "train", "eval5", "train9"),
                    help="eval: the scoring trace (seed "
                         f"{SEED}, {DAYS}d); train: the fine-tuning "
                         f"realization (seed {TRAIN_SEED}, "
                         f"{TRAIN_DAYS}d); eval5/train9: the long "
                         "variants (distinct seeds: a different day "
                         "count reshuffles the whole event stream, so "
                         "these are new realizations, not extensions)")
    args = ap.parse_args(argv)
    cfg = cfg or default_config()
    seed, days, path = VARIANTS[args.variant]
    out = out or path
    trace, meta = build_trace(cfg, seed=seed, days=days)
    save_trace(out, trace, meta)
    print(f"wrote {out}: {trace.steps} steps x {cfg.cluster.n_zones} zones "
          f"({os.path.getsize(out) / 1024:.0f} KiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
