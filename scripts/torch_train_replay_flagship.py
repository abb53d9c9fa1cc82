"""Train + select the replay-family flagship checkpoint with the PyTorch port.

The port's twin of `scripts/train_replay_flagship.py` (no JAX):

- fine-tuning data: the FIRST 6 days of `data/replay_train_9day.npz`,
  the same generative process as the scoring traces and other
  realizations (`scripts/torch_make_replay_trace.py`), so nothing trains
  on the scoring trace's windows, only on its family;
- init: behavior-clone the carbon-aware teacher on the training days;
- refinement: (1+lambda)-ES on the population kernel
  (`cem_refine(engine="mega")`: one rule, one carbon and one MLP launch a
  generation over 128 sampled training windows), teacher-paired bars,
  damped-hpa trust region; several ES seeds from the same init, best-of
  by selection;
- selection: every eval-chunk candidate scores on 5 half-day-staggered
  day-long windows of the LAST 3 days (a holdout enforced by slicing the
  stored trace), stacked into one batch. The win requires EVERY window's
  cost and carbon ratio < 1 at rule-level attainment; the best candidate
  ships as `ccka_tpu_torch/checkpoints/ppo_flagship_replay.npz`.

Run from the repo root (``--device cpu --engine lax`` on a host without
CUDA):
    python scripts/torch_make_replay_trace.py --variant train9
    python scripts/torch_train_replay_flagship.py --generations 300
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from ccka_tpu_torch import resolve_device  # noqa: E402
from ccka_tpu_torch.config import default_config  # noqa: E402
from ccka_tpu_torch.obs.runlog import RunLog  # noqa: E402
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy  # noqa: E402
from ccka_tpu_torch.policy.rule import RulePolicy  # noqa: E402
from ccka_tpu_torch.signals.base import ExogenousTrace  # noqa: E402
from ccka_tpu_torch.signals.replay import ReplaySignalSource  # noqa: E402
from ccka_tpu_torch.train.cem import CEMConfig, cem_refine  # noqa: E402
from ccka_tpu_torch.train.checkpoint import save_params_npz  # noqa: E402
from ccka_tpu_torch.train.evaluate import evaluate_backend  # noqa: E402
from ccka_tpu_torch.train.flagship import _ATTAIN_EPS, score_vs_rule  # noqa: E402
from ccka_tpu_torch.train.imitate import imitate  # noqa: E402
from ccka_tpu_torch.train.ppo import PPOBackend  # noqa: E402

TRAIN_TRACE = os.path.join(_ROOT, "data", "replay_train_9day.npz")
TRAIN_TRACE_FALLBACK = os.path.join(_ROOT, "data",
                                    "replay_train_6day.npz")
OUT = os.path.join(_ROOT, "ccka_tpu_torch", "checkpoints",
                   "ppo_flagship_replay.npz")
_HOLDOUT_DAYS = 3
_SEL_WINDOWS = 5


def split_sources(path: str, steps_per_day: int, *, device=None):
    """(train_source, selection_traces): the ES samples windows ONLY
    from the first N-3 days; selection scores on ``_SEL_WINDOWS``
    half-day-staggered day-long windows of the last 3 days, a holdout
    enforced by slicing the stored trace. The windows are one
    [_SEL_WINDOWS, steps_per_day, ...] batch on ``device``."""
    dev = resolve_device(device)
    full = ReplaySignalSource.from_file(path)
    stored = full._trace.steps
    holdout = _HOLDOUT_DAYS * steps_per_day
    if stored <= holdout + steps_per_day:
        raise SystemExit(f"{path}: {stored} steps cannot hold "
                         f"{_HOLDOUT_DAYS} holdout days + training data")
    train_src = ReplaySignalSource(
        full._trace.slice_steps(0, stored - holdout), full._meta)
    # 5 day-long windows over 3 holdout days: starts every half day.
    stride = (holdout - steps_per_day) // (_SEL_WINDOWS - 1)
    sel = [full._trace.slice_steps(stored - holdout + i * stride,
                                   steps_per_day)
           for i in range(_SEL_WINDOWS)]
    return train_src, ExogenousTrace(*(torch.stack(xs).to(dev)
                                       for xs in zip(*sel)))


def consider(cfg, sel, rule_res: dict, rl: RunLog, name: str, params,
             gen: int, *, device=None) -> dict:
    """Score ``params`` on the holdout; the win requires EVERY window's
    cost AND carbon ratio < 1 at rule-level attainment (the bench
    scoreboard's per-window standard). Records an "eval" event."""
    res = evaluate_backend(cfg, PPOBackend(cfg, params, device=device), sel)
    wins_mean, score = score_vs_rule(res, rule_res)
    pw_usd = [a / max(b, 1e-9) for a, b in zip(
        res["per_trace"]["usd_per_slo_hour"],
        rule_res["per_trace"]["usd_per_slo_hour"])]
    pw_co2 = [a / max(b, 1e-9) for a, b in zip(
        res["per_trace"]["g_co2_per_kreq"],
        rule_res["per_trace"]["g_co2_per_kreq"])]
    all_windows = (max(pw_usd) < 1.0 and max(pw_co2) < 1.0
                   and res["slo_attainment"]
                   >= rule_res["slo_attainment"] - _ATTAIN_EPS)
    rl.event("eval", _echo=(
        f"{name:>14}: usd x{res['usd_per_slo_hour'] / rule_res['usd_per_slo_hour']:.4f} "
        f"co2 x{res['g_co2_per_kreq'] / rule_res['g_co2_per_kreq']:.4f} "
        f"attain {res['slo_attainment']:.4f} "
        f"worst-window usd x{max(pw_usd):.4f} co2 x{max(pw_co2):.4f} "
        f"{'ALL-WINDOWS-WIN' if all_windows else ('WIN' if wins_mean else '')}"),
        name=name, gen=gen,
        usd_ratio=res["usd_per_slo_hour"] / rule_res["usd_per_slo_hour"],
        co2_ratio=res["g_co2_per_kreq"] / rule_res["g_co2_per_kreq"],
        slo_attainment=res["slo_attainment"], wins_mean=wins_mean,
        all_windows_win=all_windows, score=score,
        worst_window_usd=max(pw_usd), worst_window_co2=max(pw_co2))
    return {"name": name, "params": params,
            "gen": gen, "res": res, "wins": wins_mean,
            "all_windows_win": all_windows, "score": score,
            "worst_window_usd": max(pw_usd),
            "worst_window_co2": max(pw_co2)}


def better(a: dict, b: dict) -> bool:
    """Tier: all-windows win > mean win > neither; then score."""
    ka = (a["all_windows_win"], a["wins"], -a["score"])
    kb = (b["all_windows_win"], b["wins"], -b["score"])
    return ka > kb


def refine_chunk(cfg, params, train_src, teacher, *, generations: int,
                 sigma: float, seed: int, steps_per_day: int,
                 engine: str = "mega", popsize: int = 64,
                 traces: int = 128, attain_margin: float = 0.0,
                 usd_bar: str = "min", co2_bar: str = "min",
                 log=None, rl: RunLog | None = None, draws=None,
                 device=None) -> tuple[dict, float]:
    """One eval chunk of the ES: ``generations`` generations from
    ``params`` at step size ``sigma``; returns the incumbent (a numpy
    tree) and the annealed sigma the next chunk starts from. ``draws``
    is `cem_refine`'s: a caller that keeps a generation's randomness
    (to hold its launches against their plain versions) supplies it."""
    extra = {"sigma_min": 1e-3} if engine == "mega" else {}
    params, _h, info = cem_refine(
        cfg, params, train_src,
        cem=CEMConfig(generations=generations, sigma0=sigma,
                      popsize=popsize, traces_per_gen=traces,
                      eval_steps=steps_per_day,
                      attain_margin=attain_margin,
                      usd_bar=usd_bar, co2_bar=co2_bar, **extra),
        engine=engine,
        teacher_policy=teacher if engine == "mega" else None,
        teacher_fn=None if engine == "mega" else teacher.action_fn(),
        seed=seed, draws=draws, log=log, runlog=rl, device=device)
    return params, info["final_sigma"]


def main(argv=None, *, cfg=None, train_path: str | None = None) -> int:
    """``cfg`` (default: the default preset) and ``train_path`` (default:
    the 9-day store, else the 6-day one) let a caller train elsewhere."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--generations", type=int, default=300,
                    help="ES generations PER SEED")
    ap.add_argument("--es-seeds", type=int, default=2,
                    help="independent ES runs from the same distilled "
                         "init (best-of by holdout selection)")
    ap.add_argument("--eval-every", type=int, default=40)
    ap.add_argument("--popsize", type=int, default=64)
    ap.add_argument("--distill-iterations", type=int, default=2000)
    ap.add_argument("--traces", type=int, default=128,
                    help="training windows per ES generation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="mega", choices=("mega", "lax"))
    ap.add_argument("--attain-margin", type=float, default=0.0,
                    help="CEMConfig.attain_margin: keep the ES operating "
                         "point this far ABOVE the attainment bar so "
                         "holdout realizations don't land below it")
    ap.add_argument("--usd-bar", default="min",
                    choices=("min", "rule", "teacher"))
    ap.add_argument("--co2-bar", default="min",
                    choices=("min", "rule", "teacher"))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--runlog", default="runs/replay_flagship.jsonl",
                    help="structured JSONL run log (obs/runlog; inspect "
                         "with `ccka obs tail|summarize`); '' disables")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions on "
                         "the host (pair it with --engine lax)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if train_path is None:
        train_path = (TRAIN_TRACE if os.path.exists(TRAIN_TRACE)
                      else TRAIN_TRACE_FALLBACK)
    if not os.path.exists(train_path):
        raise SystemExit(f"{train_path} missing: run "
                         "scripts/torch_make_replay_trace.py --variant "
                         "train9")
    cfg = cfg or default_config()
    steps_per_day = int(86400 / cfg.sim.dt_s)
    train_src, sel = split_sources(train_path, steps_per_day, device=dev)

    # Structured run log (obs/runlog): every candidate evaluation and ES
    # generation is a JSONL event; `log` is the human echo.
    rl = RunLog(args.runlog or None, kind="replay-flagship",
                meta={"generations": args.generations,
                      "es_seeds": args.es_seeds, "engine": args.engine,
                      "popsize": args.popsize, "seed": args.seed})
    log = rl
    rule_res = evaluate_backend(cfg, RulePolicy(cfg.cluster, device=dev),
                                sel)
    teacher = CarbonAwarePolicy(cfg.cluster, device=dev)
    teacher_res = evaluate_backend(cfg, teacher, sel)
    log(f"holdout windows: {sel.is_peak.shape[0]} x 1 day of {train_path}")
    log(f"rule:    usd {rule_res['usd_per_slo_hour']:.4f} "
        f"co2 {rule_res['g_co2_per_kreq']:.4f} "
        f"attain {rule_res['slo_attainment']:.4f}")
    log(f"teacher: usd x{teacher_res['usd_per_slo_hour'] / rule_res['usd_per_slo_hour']:.4f} "
        f"co2 x{teacher_res['g_co2_per_kreq'] / rule_res['g_co2_per_kreq']:.4f} "
        f"attain {teacher_res['slo_attainment']:.4f}")

    log("distilling carbon teacher on replay-train windows...")
    params0, hist = imitate(cfg, teacher, train_src, seed=args.seed,
                            iterations=args.distill_iterations, device=dev)
    log(f"distilled: actor_mse {hist[-1]['actor_mse']:.4f}")

    best = consider(cfg, sel, rule_res, rl, "init", params0, 0, device=dev)
    for es_seed in range(args.es_seeds):
        params_cur = params0
        sigma = CEMConfig().sigma0
        done = 0
        while done < args.generations:
            n = min(args.eval_every, args.generations - done)
            params_cur, sigma = refine_chunk(
                cfg, params_cur, train_src, teacher, generations=n,
                sigma=sigma, seed=args.seed + 1000 * es_seed + 17 * done,
                steps_per_day=steps_per_day, engine=args.engine,
                popsize=args.popsize, traces=args.traces,
                attain_margin=args.attain_margin, usd_bar=args.usd_bar,
                co2_bar=args.co2_bar,
                # Echo-only here: the structured record comes from the
                # per-generation "gen" event.
                log=lambda s, es_seed=es_seed: print(
                    f"  cem[s{es_seed}] " + s, file=sys.stderr, flush=True),
                rl=rl, device=dev)
            done += n
            cand = consider(cfg, sel, rule_res, rl,
                            f"seed{es_seed}@gen{done}", params_cur, done,
                            device=dev)
            if better(cand, best):
                best = cand
                log("  ^ new best")

    meta = {
        "family": "replay",
        "train_trace": os.path.basename(train_path),
        "init_from": "distill:carbon(replay-train)",
        "refine": "cem",
        "cem_engine": args.engine,
        "traces_per_gen": args.traces,
        "es_seeds": args.es_seeds,
        "selection_windows": sel.is_peak.shape[0],
        "selected": best["name"],
        "selected_iteration": int(best["gen"]),
        "wins_both": bool(best["wins"]),
        "all_windows_win": bool(best["all_windows_win"]),
        "worst_window_usd_ratio": round(float(best["worst_window_usd"]),
                                        4),
        "worst_window_co2_ratio": round(float(best["worst_window_co2"]),
                                        4),
        "generations": args.generations,
        "seed": args.seed,
        "selection_scoreboard": {
            "rule": {k: float(rule_res[k]) for k in
                     ("usd_per_slo_hour", "g_co2_per_kreq",
                      "slo_attainment")},
            "teacher": {k: float(teacher_res[k]) for k in
                        ("usd_per_slo_hour", "g_co2_per_kreq",
                         "slo_attainment")},
            "ppo": {k: float(best["res"][k]) for k in
                    ("usd_per_slo_hour", "g_co2_per_kreq",
                     "slo_attainment")},
        },
    }
    path = save_params_npz(args.out, best["params"], meta=meta)
    rl.close(selected=best["name"], checkpoint=path)
    print(json.dumps({"checkpoint": path, **meta}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
