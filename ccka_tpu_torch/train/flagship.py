"""The flagship run: train, select by the scoreboard, ship an npz.

The PyTorch form of `ccka_tpu/train/flagship.py`. The north star is not
"PPO improves its own reward" but "beats the rule baseline on $/SLO-hour
and gCO2/kreq on held-out traces". :func:`train_flagship` trains (PPO, or
CEM from a distilled init), evaluates the deterministic policy against
the rule on *selection* traces at every checkpoint, and keeps the one
that wins both headline metrics at rule-level attainment.

Selection traces use a seed block (20k+) disjoint from training (1k+)
and from the held-out scoring traces (10k+,
`train/evaluate.heldout_traces`).

The winning params are saved as one npz (`train/checkpoint.
save_params_npz`) with provenance metadata, in the layout both packages'
``load_params_npz`` read. The checkpoints under
``ccka_tpu_torch/checkpoints/`` are byte copies of the JAX package's, so
the port stands without that package on disk.

Run: ``python -m ccka_tpu_torch.train.flagship --preset multiregion
--init-from distill:carbon --refine cem --iterations 300`` (on the card;
``--device cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable

from ccka_tpu_torch import bridge, resolve_device
from ccka_tpu_torch.config import FrameworkConfig, default_config
from ccka_tpu_torch.train.checkpoint import load_params_npz, save_params_npz
from ccka_tpu_torch.train.ppo import PPOBackend, PPOTrainer

_CHECKPOINTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")

_SELECTION_SEED0 = 20_000

# Attainment slack: the learned policy must match the rule baseline's SLO
# attainment to within one tick in a thousand.
_ATTAIN_EPS = 1e-3

# The result fields a selection scoreboard records.
_HEADLINE = ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment")


def score_vs_rule(res: dict, rule: dict) -> tuple[bool, float]:
    """(wins_both, scalar score: lower is better).

    Wins = both headline ratios <= 1 at attainment >= rule's (within
    _ATTAIN_EPS). The scalar orders checkpoints: the worse of the two
    ratios, plus a heavy penalty for any attainment shortfall so a
    cost-dumping policy can never look good."""
    usd = res["usd_per_slo_hour"] / max(rule["usd_per_slo_hour"], 1e-9)
    co2 = res["g_co2_per_kreq"] / max(rule["g_co2_per_kreq"], 1e-9)
    shortfall = max(0.0, rule["slo_attainment"] - res["slo_attainment"])
    wins = usd <= 1.0 and co2 <= 1.0 and shortfall <= _ATTAIN_EPS
    return wins, max(usd, co2) + 25.0 * shortfall


def beats_teacher(res: dict, teacher: dict) -> bool:
    """Training earned its keep: strictly better than the teacher on at
    least one headline, no worse on the other (within stochastic-eval
    noise), at the teacher's attainment or better."""
    usd = res["usd_per_slo_hour"] / max(teacher["usd_per_slo_hour"], 1e-9)
    co2 = res["g_co2_per_kreq"] / max(teacher["g_co2_per_kreq"], 1e-9)
    attain_ok = (res["slo_attainment"]
                 >= teacher["slo_attainment"] - _ATTAIN_EPS)
    both_leq = usd <= 1.0 + 1e-4 and co2 <= 1.0 + 1e-4
    one_strict = usd < 0.999 or co2 < 0.999
    return both_leq and one_strict and attain_ok


def candidate_tier(res: dict, wins: bool, teacher_res: dict | None) -> int:
    """2 = wins against the rule AND improves on the teacher; 1 = wins
    against the rule; 0 = neither. Selection prefers the highest tier,
    then the lowest score."""
    if wins and teacher_res is not None and beats_teacher(res, teacher_res):
        return 2
    return 1 if wins else 0


def train_flagship(cfg: FrameworkConfig | None = None, *,
                   iterations: int = 1200, eval_every: int = 100,
                   # One full simulated day: a shorter window anchored at
                   # midnight never reaches peak hours.
                   eval_steps: int = 2880, n_eval_traces: int = 5,
                   seed: int = 0, init_from: str = "scratch",
                   distill_iterations: int = 2000, refine: str = "ppo",
                   cem_engine: str = "auto",
                   log: Callable[[str], None] | None = None, runlog=None,
                   device=None) -> dict:
    """Train and select. Returns ``{params, meta, history}``: the params a
    flax-layout tree of numpy arrays, ``meta`` the selection-trace
    scoreboard of the returned checkpoint and its provenance.

    ``runlog``: an `obs.runlog.RunLog`, a JSONL path, or None; every
    progress line and selection evaluation is a structured event, and a
    crashed run leaves its log without an "end" event. ``log`` is the
    human echo sink.

    ``init_from``: "scratch" (flax's initialisation), "distill:<teacher>"
    (behavior-clone the carbon or rule teacher first, `train/imitate.py`)
    or "distill:mpc-factory" (the MPC-distillation data factory,
    `train/factory.py`). ``refine``: "ppo" (`train/ppo.py`) or "cem"
    (`train/cem.py`, which needs a distilled teacher init; ``iterations``
    then counts generations). ``cem_engine``: "auto" (the rollout kernels'
    population launch when the device is CUDA and the teacher is the rule
    or the carbon policy, else "lax"), "mega" or "lax"."""
    from ccka_tpu_torch.obs.runlog import RunLog
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.train.evaluate import evaluate_backend, heldout_traces

    dev = resolve_device(device)
    log = log or (lambda s: print(s, file=sys.stderr))
    own_runlog = not isinstance(runlog, RunLog)
    rl = runlog if isinstance(runlog, RunLog) else RunLog(
        runlog or None, kind="flagship", echo=log,
        meta={"iterations": iterations, "refine": refine,
              "init_from": init_from, "cem_engine": cem_engine,
              "seed": seed, "eval_steps": eval_steps})
    cfg = cfg or default_config()
    trainer = PPOTrainer(cfg, device=dev)
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)

    sel_traces = heldout_traces(src, steps=eval_steps, n=n_eval_traces,
                                seed0=_SELECTION_SEED0, device=dev)

    def evaluate(backend) -> dict:
        return evaluate_backend(cfg, backend, sel_traces)

    rule_res = evaluate(RulePolicy(cfg.cluster, device=dev))
    rl.note(f"rule baseline: $/slo-hr={rule_res['usd_per_slo_hour']:.4f} "
            f"gCO2/kreq={rule_res['g_co2_per_kreq']:.4f} "
            f"attain={rule_res['slo_attainment']:.4f}")

    teacher_res = teacher_backend = None
    if init_from == "distill:mpc-factory":
        # No PolicyBackend teacher exists to evaluate (the teacher is the
        # batch planner), so candidates compete on the rule bar alone.
        from ccka_tpu_torch.train.factory import distill_from_factory
        rl.note("distilling the MPC factory dataset into the policy "
                "net...")
        params0, hist, fac_report = distill_from_factory(
            cfg, seed=seed, iterations=distill_iterations, device=dev)
        rl.event("distill", _echo=(
            f"factory-distilled: actor_mse {hist[-1]['actor_mse']:.4f} "
            f"critic_mse {hist[-1]['critic_mse']:.4f} "
            f"({fac_report['pairs_total']} pairs, "
            f"{fac_report['dataset_rows']} rows)"),
            teacher="mpc-factory", iterations=distill_iterations,
            pairs=fac_report["pairs_total"],
            actor_mse=float(hist[-1]["actor_mse"]),
            critic_mse=float(hist[-1]["critic_mse"]))
    elif init_from.startswith("distill:"):
        from ccka_tpu_torch.train.imitate import build_teacher, distill_teacher
        teacher = init_from.split(":", 1)[1]
        # Resolve the teacher before the distillation, so an unknown name
        # fails fast.
        teacher_backend = build_teacher(cfg, teacher, device=dev)
        rl.note(f"distilling teacher {teacher!r} into the policy net...")
        params0, hist = distill_teacher(cfg, teacher, seed=seed,
                                        iterations=distill_iterations,
                                        device=dev)
        rl.event("distill", _echo=(
            f"distilled: actor_mse {hist[-1]['actor_mse']:.4f} "
            f"critic_mse {hist[-1]['critic_mse']:.4f}"),
            teacher=teacher, iterations=distill_iterations,
            actor_mse=float(hist[-1]["actor_mse"]),
            critic_mse=float(hist[-1]["critic_mse"]))
        # The teacher itself on the selection traces: the bar a refined
        # candidate must clear for training to have earned its keep.
        teacher_res = evaluate(teacher_backend)
        usd_t = (teacher_res["usd_per_slo_hour"]
                 / rule_res["usd_per_slo_hour"])
        co2_t = teacher_res["g_co2_per_kreq"] / rule_res["g_co2_per_kreq"]
        rl.note(f"teacher {teacher!r}: usd x{usd_t:.3f} co2 x{co2_t:.3f} "
                f"attain {teacher_res['slo_attainment']:.4f}")
    elif init_from != "scratch":
        raise ValueError(f"unknown init_from {init_from!r}")
    if init_from == "scratch":
        ts = trainer.init_state(seed)
    else:
        if cfg.train.anchor_coef > 0:
            # The distilled init is the anchor: refinement explores
            # around the teacher, not away from it.
            trainer = PPOTrainer(cfg, anchor_params=params0, device=dev)
        ts = trainer.fresh_state(params0, seed)

    def flax_params(params: dict) -> dict:
        return bridge.actor_critic_to_flax(params)

    def ratios(res: dict) -> tuple[float, float]:
        return (res["usd_per_slo_hour"] / rule_res["usd_per_slo_hour"],
                res["g_co2_per_kreq"] / rule_res["g_co2_per_kreq"])

    # The init policy (the codec zero point, or the distilled teacher) is a
    # real candidate: early training can wander worse.
    p0 = flax_params(ts.params)
    res0 = evaluate(PPOBackend(cfg, p0, device=dev))
    wins0, score0 = score_vs_rule(res0, rule_res)
    usd0, co20 = ratios(res0)
    rl.event("eval", _echo=(
        f"it     0: usd x{usd0:.3f} co2 x{co20:.3f} "
        f"attain {res0['slo_attainment']:.4f} "
        f"{'WIN' if wins0 else '   '} score {score0:.3f}"),
        iteration=0, usd_ratio=usd0, co2_ratio=co20,
        slo_attainment=res0["slo_attainment"], wins_both=wins0,
        score=score0)
    best = {"score": score0, "wins": wins0,
            "tier": candidate_tier(res0, wins0, teacher_res), "params": p0,
            "iteration": 0, "res": res0}
    history = []

    def consider(params: dict, it_total: int, extra=None):
        """Evaluate a candidate (a flax-layout tree) on the selection
        traces; record it, and adopt it as best when better (higher tier,
        then lower score)."""
        nonlocal best
        res = evaluate(PPOBackend(cfg, params, device=dev))
        wins, score = score_vs_rule(res, rule_res)
        tier = candidate_tier(res, wins, teacher_res)
        usd, co2 = ratios(res)
        rec = {"iteration": it_total, "usd_ratio": usd, "co2_ratio": co2,
               "slo_attainment": res["slo_attainment"], "wins_both": wins,
               "score": score}
        if extra:
            rec.update(extra)
        if teacher_res is not None:
            rec["usd_vs_teacher"] = (res["usd_per_slo_hour"]
                                     / teacher_res["usd_per_slo_hour"])
            rec["co2_vs_teacher"] = (res["g_co2_per_kreq"]
                                     / teacher_res["g_co2_per_kreq"])
            rec["beats_teacher"] = beats_teacher(res, teacher_res)
        history.append(rec)
        ev = rl.event("eval", **rec)
        log(f"it {it_total:5d}: usd x{usd:.3f} co2 x{co2:.3f} attain "
            f"{rec['slo_attainment']:.4f} {'WIN' if wins else '   '}"
            f"{' >TEACHER' if rec.get('beats_teacher') else ''} "
            f"score {score:.3f} ({ev['elapsed_s']:.0f}s)")
        if tier > best["tier"] or (tier == best["tier"]
                                   and score < best["score"]):
            best = {"score": score, "wins": wins, "tier": tier,
                    "params": params, "iteration": it_total, "res": res}

    use_mega = False
    if refine == "cem":
        if teacher_res is None:
            raise ValueError("refine='cem' requires init_from=distill:<t>")
        from ccka_tpu_torch.train.cem import CEMConfig, cem_refine
        if cem_engine not in ("auto", "mega", "lax"):
            raise ValueError(f"unknown cem_engine {cem_engine!r}")
        use_mega = (cem_engine != "lax" and dev.type == "cuda"
                    and hasattr(src, "packed_trace_device")
                    and isinstance(teacher_backend,
                                   (CarbonAwarePolicy, RulePolicy)))
        if cem_engine == "mega" and not use_mega:
            raise ValueError("cem_engine='mega' needs a CUDA device, a "
                             "packed-stream source and a rule/carbon "
                             "teacher")
        traces_per_gen = 256 if use_mega else CEMConfig().traces_per_gen
        rl.note(f"cem engine: {'mega' if use_mega else 'lax'} "
                f"({traces_per_gen} traces/gen)")
        gens_per_eval = max(5, eval_every // 5)
        done = 0
        params_cur = p0
        sigma = CEMConfig().sigma0
        while done < iterations:
            n = min(gens_per_eval, iterations - done)
            # sigma0 continues the previous chunk's annealed scale. The
            # mega engine affords a 2x population and a higher sigma
            # floor: with 256-trace fitness the 1/5 rule otherwise anneals
            # into a frozen search.
            extra = ({"popsize": 64, "sigma_min": 1e-3} if use_mega
                     else {})
            params_cur, _, info = cem_refine(
                cfg, params_cur, src,
                cem=CEMConfig(**{"generations": n, "sigma0": sigma,
                                 "traces_per_gen": traces_per_gen,
                                 **extra}),
                engine="mega" if use_mega else "lax",
                teacher_policy=teacher_backend if use_mega else None,
                teacher_fn=(None if use_mega
                            else teacher_backend.action_fn()),
                seed=seed + 31 * done,
                log=lambda s: log("  cem " + s), runlog=rl, device=dev)
            sigma = info["final_sigma"]
            done += n
            consider(params_cur, done,
                     extra={"cem_best_gen": done - n + info["gen"],
                            "cem_best_fitness": info["fitness"]})
    elif refine == "ppo":
        # Ceil-chunking with an exact final remainder: precisely
        # ``iterations`` iterations however eval_every divides them.
        n_chunks = max(1, -(-iterations // eval_every))
        it_total = 0
        t_len = cfg.train.unroll_steps
        for chunk in range(n_chunks):
            chunk_iters = min(eval_every, iterations - it_total)
            if chunk_iters <= 0:
                break
            # A fresh trace block per chunk.
            windows = trainer.make_windows(src, chunk_iters,
                                           seed=seed + 1000 + 7919 * chunk)
            for it in range(chunk_iters):
                ts, diag = trainer.iteration(
                    ts, windows.slice_steps(it * t_len, t_len + 1))
            it_total += chunk_iters
            consider(flax_params(ts.params), it_total,
                     extra={"mean_reward": float(diag.mean_reward)})
    else:
        raise ValueError(f"unknown refine {refine!r}")

    meta = {
        "iterations_total": iterations,
        "refine": refine,
        "cem_engine": (("mega" if use_mega else "lax")
                       if refine == "cem" else None),
        "init_from": init_from,
        "selected_iteration": best["iteration"],
        "wins_both": bool(best["wins"]),
        "beats_teacher": bool(teacher_res is not None
                              and beats_teacher(best["res"], teacher_res)),
        "selection_seed0": _SELECTION_SEED0,
        "eval_steps": eval_steps,
        "n_eval_traces": n_eval_traces,
        "seed": seed,
        "train_config": {k: getattr(cfg.train, k) for k in (
            "slo_weight", "slo_violation_weight", "carbon_weight",
            "batch_clusters", "unroll_steps", "learning_rate",
            "critic_warmup_iters", "anchor_coef", "adv_clip",
            "actor_lr_scale", "init_log_std", "lr_decay_iters")},
        "selection_scoreboard": {
            "rule": {k: float(rule_res[k]) for k in _HEADLINE},
            "teacher": ({k: float(teacher_res[k]) for k in _HEADLINE}
                        if teacher_res is not None else None),
            "ppo": {k: float(best["res"][k]) for k in _HEADLINE},
        },
    }
    # Close only on success, and only a RunLog this call created: a
    # crashed run keeps its log unterminated.
    if own_runlog:
        rl.close(selected_iteration=int(best["iteration"]),
                 wins_both=bool(best["wins"]))
    return {"params": best["params"], "meta": meta, "history": history}


def flagship_checkpoint_path(cfg: FrameworkConfig | None = None, *,
                             variant: str = "") -> str:
    """Absolute path of the shipped checkpoint (inside the package).

    Keyed by topology: a multi-region config loads the multi-region
    checkpoint, since the nets' observation and action widths differ with
    the zone count. ``variant="replay"`` names the replay-family
    checkpoint (default topology)."""
    if variant:
        name = f"ppo_flagship_{variant}.npz"
    elif cfg is not None and cfg.cluster.regions:
        name = "ppo_flagship_multiregion.npz"
    else:
        name = "ppo_flagship.npz"
    return os.path.join(_CHECKPOINTS, name)


def load_flagship_backend(cfg: FrameworkConfig, *, variant: str = "",
                          device=None):
    """(PPOBackend, meta) from the shipped checkpoint, or (None, None) if
    none is shipped for this config. Published quality numbers come from
    these selected params, not from a fresh training run."""
    path = flagship_checkpoint_path(cfg, variant=variant)
    if not os.path.exists(path):
        return None, None
    params, meta = load_params_npz(path)
    # Provenance at load time: whether the params were a trained winner or
    # a fallback init.
    print(f"# flagship checkpoint {os.path.basename(path)}: "
          f"selected_iteration={meta.get('selected_iteration')} "
          f"init_from={meta.get('init_from')} "
          f"wins_both={meta.get('wins_both')}", file=sys.stderr)
    return PPOBackend(cfg, params, device=device), meta


def main(argv=None) -> int:
    from ccka_tpu_torch.config import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=1200)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--eval-steps", type=int, default=2880)
    ap.add_argument("--traces", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="default", choices=sorted(PRESETS))
    ap.add_argument("--init-from", default="scratch",
                    help='"scratch" or "distill:<teacher>" (carbon | rule | '
                         "mpc-factory, the last runs the train/factory.py "
                         "data factory and distills its pairs)")
    ap.add_argument("--distill-iterations", type=int, default=2000)
    ap.add_argument("--refine", default="ppo", choices=("ppo", "cem"),
                    help="refinement loop: PPO or CEM episodic direct "
                         "search (needs a distilled init; --iterations "
                         "counts generations)")
    ap.add_argument("--cem-engine", default="auto",
                    choices=("auto", "mega", "lax"),
                    help="CEM rollout engine: the rollout kernels' "
                         "population launch (256 traces/gen, CUDA) or the "
                         "plain batched rollout; auto picks mega on CUDA")
    ap.add_argument("--out", default="",
                    help="checkpoint path (default: the package's "
                         "topology-keyed flagship location)")
    ap.add_argument("--runlog", default="runs/flagship.jsonl",
                    help="structured JSONL run log; '' disables")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted config override, e.g. "
                         "train.slo_weight=0.002")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]()
    if args.override:
        kv = {}
        for ov in args.override:
            k, _, v = ov.partition("=")
            kv[k] = json.loads(v)
        cfg = cfg.with_overrides(**kv)

    out = train_flagship(cfg, iterations=args.iterations,
                         eval_every=args.eval_every,
                         eval_steps=args.eval_steps,
                         n_eval_traces=args.traces, seed=args.seed,
                         init_from=args.init_from,
                         distill_iterations=args.distill_iterations,
                         refine=args.refine, cem_engine=args.cem_engine,
                         runlog=args.runlog, device=args.device)
    out["meta"]["preset"] = args.preset
    # Default to the loader's own path, where load_flagship_backend looks.
    out_path = args.out or flagship_checkpoint_path(cfg)
    path = save_params_npz(out_path, out["params"], meta=out["meta"])
    print(json.dumps({"checkpoint": path, **out["meta"]}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
