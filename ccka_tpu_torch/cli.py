"""The port's command line: the closed control loop and its recovery board.

The PyTorch form of two subcommands of `ccka_tpu/cli.py`:

  run          — the live closed-loop controller: scrape -> decide ->
                 render -> apply -> verify every interval
  recover-eval — the crash-recovery scoreboard (`harness/recovery.py`)

``python -m ccka_tpu_torch run --ticks 3 --device cpu`` reaches them.
Both run on the card unless ``--device cpu`` is given. Every other
subcommand of ``ccka`` is not ported yet (ROADMAP A14) and exits with a
message saying so.
"""

from __future__ import annotations

import argparse
import json
import sys

from ccka_tpu_torch.config import ConfigError, FrameworkConfig, config_from_env

PORTED = ("run", "recover-eval")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccka_tpu_torch",
        description="cost- and carbon-aware cluster autoscaler (PyTorch "
                    "port)")
    p.add_argument("--config", help="path to a FrameworkConfig JSON file")
    p.add_argument("--preset", default="default",
                   choices=("default", "multiregion"),
                   help="base config preset")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted config override, e.g. --set sim.dt_s=15")
    sub = p.add_subparsers(dest="command", required=True)

    sr = sub.add_parser(
        "run", help="the live closed-loop controller: scrape->decide->"
                    "render->apply->verify every interval")
    sr.add_argument("--backend", default="rule",
                    choices=("rule", "carbon", "mpc", "ppo"))
    sr.add_argument("--checkpoint", default="",
                    help="params .npz for ppo (default: the shipped "
                         "flagship of the preset's topology)")
    sr.add_argument("--forecaster", default="",
                    help="mpc planning-window source: oracle (default), "
                         "persistence, seasonal-naive, or ridge")
    sr.add_argument("--ticks", type=int, default=0,
                    help="stop after N ticks (0 = run forever)")
    sr.add_argument("--interval", type=float, default=None,
                    help="seconds between ticks (default: the signals' "
                         "scrape interval, 30s)")
    sr.add_argument("--live", action="store_true",
                    help="apply via kubectl instead of the dry-run sink")
    sr.add_argument("--hpa", action="store_true",
                    help="also apply the policy's HPA objects each tick")
    sr.add_argument("--keda", action="store_true",
                    help="also apply a KEDA SQS ScaledObject each tick "
                         "(needs workload.sqs_queue_name + aws_account_id)")
    sr.add_argument("--seed", type=int, default=0)
    sr.add_argument("--telemetry", default="",
                    help="append per-tick JSONL records to this file")
    sr.add_argument("--snapshot", default="",
                    help="write a durable controller snapshot to this path "
                         "(atomic, checksummed); what --resume restores")
    sr.add_argument("--snapshot-every", type=int, default=1,
                    help="ticks between snapshot writes (default 1)")
    sr.add_argument("--resume", action="store_true",
                    help="restore from --snapshot and continue at the "
                         "saved tick; --ticks stays the run's total length")
    sr.add_argument("--metrics-port", type=int, default=-1,
                    help="serve the ccka_* gauges on 127.0.0.1:PORT/metrics "
                         "(0 = pick a free port)")
    sr.add_argument("--metrics-textfile", default="",
                    help="also write the gauges to this .prom file each "
                         "tick")
    sr.add_argument("--trace-out", default="",
                    help="write the session's tick spans as Chrome "
                         "trace-event JSON on exit")
    sr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch version)")

    sre = sub.add_parser(
        "recover-eval", help="crash-recovery scoreboard: paired kill/no-"
                             "kill controller runs per {policy x actuation "
                             "intensity}")
    sre.add_argument("--intensities", default="off,mild,moderate,severe",
                     help="comma list of config.CHAOS_PRESETS names")
    sre.add_argument("--policies", default="rule,flagship",
                     help="comma list of rule,carbon,flagship")
    sre.add_argument("--runs", type=int, default=8,
                     help="paired kill/no-kill runs per cell")
    sre.add_argument("--ticks", type=int, default=32,
                     help="control ticks per run")
    sre.add_argument("--seed", type=int, default=101)
    sre.add_argument("--device", default="cuda",
                     help="torch device (default cuda)")
    return p


def _load_config(args) -> FrameworkConfig:
    if args.config:
        if args.preset != "default":
            raise SystemExit("ccka: --config and --preset are mutually "
                             "exclusive (the config file wins entirely; "
                             "drop one)")
        with open(args.config) as f:
            cfg = FrameworkConfig.from_json(f.read())
    else:
        from ccka_tpu_torch.config import PRESETS
        cfg = config_from_env(base=PRESETS[args.preset]())
    overrides = {}
    for kv in args.set:
        if "=" not in kv:
            raise SystemExit(f"--set expects KEY=VAL, got {kv!r}")
        key, val = kv.split("=", 1)
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    return cfg.with_overrides(**overrides) if overrides else cfg


def make_backend(cfg: FrameworkConfig, name: str, checkpoint: str = "",
                 forecaster: str = "", *, device=None):
    """The backend of a CLI spelling on ``device`` (the card unless
    ``device="cpu"``). ``forecaster`` (mpc only) names a
    `ccka_tpu_torch.forecast` backend the planner replans against;
    empty or "oracle" keeps the perfect-foresight windows. ``ppo``
    without a checkpoint loads the shipped flagship of the config's
    topology."""
    from ccka_tpu_torch import resolve_device
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy

    device = resolve_device(device)
    fc = None
    if forecaster:
        from ccka_tpu_torch.forecast.base import make_forecaster
        try:
            fc = make_forecaster(forecaster, dt_s=cfg.sim.dt_s)
        except ValueError as e:
            raise SystemExit(f"ccka: {e}")
    if fc is not None and name != "mpc":
        raise SystemExit("ccka: --forecaster only applies to the mpc "
                         "backend (rule/carbon/ppo decide from the "
                         "current tick, not a planning window)")
    if name == "rule":
        return RulePolicy(cfg.cluster, device=device)
    if name == "carbon":
        return CarbonAwarePolicy(cfg.cluster, device=device)
    if name == "mpc":
        from ccka_tpu_torch.train.mpc import MPCBackend
        if checkpoint:
            raise SystemExit("ccka: a trained mpc warm-start plan "
                             "(--checkpoint) is not ported yet (ROADMAP "
                             "A14)")
        return MPCBackend(cfg, forecaster=fc, device=device)
    if name == "ppo":
        from ccka_tpu_torch.train.ppo import PPOBackend
        if not checkpoint:
            from ccka_tpu_torch.train.flagship import load_flagship_backend
            backend, _meta = load_flagship_backend(cfg, device=device)
            if backend is None:
                raise SystemExit(
                    "ccka: --backend ppo needs --checkpoint (no flagship "
                    "checkpoint shipped for this topology; train one with "
                    "`python -m ccka_tpu_torch.train.flagship`)")
            return backend
        from ccka_tpu_torch.train.checkpoint import load_params_npz
        params, _meta = load_params_npz(checkpoint)
        return PPOBackend(cfg, params, device=device)
    raise SystemExit(f"ccka: unknown backend {name!r}")


def _cmd_run(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.harness.controller import (ControllerLockHeld,
                                                   controller_from_config)

    if args.resume and not args.snapshot:
        raise SystemExit("ccka: --resume needs --snapshot PATH (the "
                         "snapshot file to restore from and keep "
                         "writing to)")
    resume_body = None
    if args.resume:
        from ccka_tpu_torch.harness.snapshot import (SnapshotError,
                                                     load_snapshot)
        try:
            resume_body = load_snapshot(args.snapshot)
        except SnapshotError as e:
            raise SystemExit(f"ccka: {e}")
    backend = make_backend(cfg, args.backend, args.checkpoint,
                           forecaster=args.forecaster, device=args.device)
    tracer = None
    if args.trace_out:
        from ccka_tpu_torch.obs.trace import SpanTracer
        # Bounded: 100k spans is days of 30 s ticks.
        tracer = SpanTracer(max_spans=100_000)
    exporter = None
    if args.metrics_port >= 0 or args.metrics_textfile:
        from ccka_tpu_torch.harness.promexport import MetricsExporter
        exporter = MetricsExporter(
            port=args.metrics_port if args.metrics_port >= 0 else None,
            textfile=args.metrics_textfile, cluster=cfg.cluster.name)
        if exporter.port is not None:
            print(f"[ok] metrics: http://127.0.0.1:{exporter.port}/metrics",
                  file=sys.stderr)
    try:
        # Only live daemons take the per-cluster single-writer lock.
        ctrl = controller_from_config(
            cfg, backend, device=args.device, live=args.live,
            interval_s=args.interval, seed=args.seed, apply_hpa=args.hpa,
            apply_keda=args.keda, lock=args.live,
            telemetry_path=args.telemetry, exporter=exporter,
            tracer=tracer, snapshot_path=args.snapshot,
            snapshot_every=args.snapshot_every)
    except (ValueError, ControllerLockHeld) as e:
        if exporter is not None:
            exporter.close()
        raise SystemExit(f"ccka: {e}")
    try:
        start_tick = 0
        if resume_body is not None:
            from ccka_tpu_torch.harness.snapshot import SnapshotError
            try:
                start_tick = ctrl.restore(resume_body)
            except SnapshotError as e:
                raise SystemExit(f"ccka: {e}")
            print(f"[ok] resumed at tick {start_tick} "
                  f"(resume #{ctrl.resumes_total})", file=sys.stderr)
        # --ticks is the run's length, resumed or not.
        remaining = (None if args.ticks <= 0
                     else max(args.ticks - start_tick, 0))
        reports = ctrl.run(remaining, start_tick=start_tick)
    finally:
        ctrl.close()
        if exporter is not None:
            exporter.close()
        if tracer is not None:
            print(f"[ok] chrome trace -> "
                  f"{tracer.write_chrome_trace(args.trace_out)} "
                  "(load in ui.perfetto.dev)", file=sys.stderr)
    ok = all(r.applied and r.verified for r in reports) if reports else True
    print(f"[{'ok' if ok else 'err'}] controller ran "
          f"{len(reports)} tick(s)", file=sys.stderr)
    return 0 if ok else 1


def _cmd_recover_eval(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.harness.recovery import recovery_scoreboard

    def names(s: str) -> tuple:
        return tuple(x.strip() for x in s.split(",") if x.strip())

    try:
        board = recovery_scoreboard(
            cfg, intensities=names(args.intensities),
            policies=names(args.policies), runs_per_cell=args.runs,
            ticks=args.ticks, seed=args.seed, device=args.device)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    print(json.dumps(board, indent=2))
    return 0


def _command(argv: list[str]) -> str | None:
    """The subcommand word of ``argv`` (past the global options)."""
    takes_value = {"--config", "--preset", "--set"}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in takes_value:
            i += 2
            continue
        if a.startswith("-"):
            i += 1
            continue
        return a
    return None


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = _command(argv)
    if cmd is not None and cmd not in PORTED:
        print(f"ccka_tpu_torch: subcommand {cmd!r} is not ported yet "
              f"(ROADMAP A14); the port has {', '.join(PORTED)}",
              file=sys.stderr)
        return 2
    args = _build_parser().parse_args(argv)
    try:
        cfg = _load_config(args)
    except ConfigError as e:
        print(f"ccka: config error: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"ccka: cannot read config: {e}", file=sys.stderr)
        return 2
    if args.command == "run":
        return _cmd_run(cfg, args)
    return _cmd_recover_eval(cfg, args)
