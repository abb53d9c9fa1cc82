"""The port's command line: the reference's demo scripts and the scoring
and training entry points, as thin callers of the port's modules.

The PyTorch form of `ccka_tpu/cli.py`, with the same flags, output and
exit codes. Subcommand <-> script map:

  offpeak / peak / reset  <- demo_20 / demo_21 / demo_19 (NodePool patches)
  observe     the profile a policy would apply right now (read-only)
  run         the live closed-loop controller (scrape -> decide -> render
              -> apply -> verify every interval)
  preroll     <- demo_18 (environment assertions, the card's included)
  bootstrap   EC2NodeClass + NodePools (the reference's missing demo_01)
  guardrails  <- 04_kyverno (admission ClusterPolicies)
  map-nodes   <- demo_15 (Karpenter node role into aws-auth)
  cleanup     <- demo_50 (teardown order)
  burst       <- demo_30 (COUNT x REPLICAS load generator)
  watch       <- demo_40 observe (port-forwards + smoke queries)
  dashboard   <- demo_40 configure (Grafana stack)
  pipeline    <- 06_opencost collector stage
  fleet       the batched fleet loop over N dry-run sinks (one CUDA
              graph a tick on the card); ``--service`` runs the
              multi-tenant service layer over it
  overload-eval
              the paired stressed/calm multi-tenant service board
  incidents / decisions / tournament
              read the incident log, the decision ledger and the
              shadow tournament's board and audits
  geo         the geo-arbitrage Pareto scoreboard (regions/pareto.py)
  scenario-search
              the adversarial scenario search (search/adversarial.py):
              CEM over the scenario axis, the worst case minted
  flywheel    the continual-learning flywheel (train/flywheel.py): mine,
              distill, promote, status
  simulate, evaluate, train, forecast-eval, chaos-eval, scenario-eval,
  recover-eval, scenarios, distill-factory, capture, report, obs,
  show-config

Every subcommand that runs torch work takes ``--device`` (default
``cuda``); without a GPU and without ``--device cpu`` it exits non-zero
naming the device and never carries on on the CPU. ``python -m
ccka_tpu_torch <cmd> --device cpu`` runs the plain PyTorch versions.
Subcommands whose modules are not ported yet exit 2 naming their ROADMAP
item (:data:`NOT_PORTED`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ccka_tpu_torch.config import ConfigError, FrameworkConfig, config_from_env

# Subcommands of `ccka` the port has not yet, with the ROADMAP item that
# ports them.
NOT_PORTED = {"perf": "A12", "bench-diff": "A12", "scaling-curve": "A12"}
_DEVICE_HELP = ("torch device (default cuda; cpu runs the plain PyTorch "
                "version)")


def _names(s: str) -> tuple:
    return tuple(x.strip() for x in s.split(",") if x.strip())


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

    def device(sp) -> None:
        sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    for name, helptext in (
            ("offpeak", "apply the cost-biased Off-Peak profile (demo_20)"),
            ("peak", "apply the SLO-biased Peak profile (demo_21)"),
            ("reset", "normalize NodePools to neutral (demo_19)")):
        sp = sub.add_parser(name, help=helptext)
        sp.add_argument("--live", action="store_true",
                        help="apply via kubectl instead of dry-run")
        sp.add_argument("--json", action="store_true",
                        help="emit patches as JSON instead of commands")

    so = sub.add_parser("observe", help="print the profile a policy would "
                                        "apply right now (read-only)")
    so.add_argument("--backend", default="rule",
                    choices=("rule", "carbon", "mpc", "ppo"))
    so.add_argument("--checkpoint", default="",
                    help="ppo params (.npz or a `train` state directory); "
                         "mpc: a `train --backend mpc` warm-start plan")
    device(so)

    sr = sub.add_parser(
        "run", help="the live closed-loop controller: scrape->decide->"
                    "render->apply->verify every interval")
    sr.add_argument("--backend", default="rule",
                    choices=("rule", "carbon", "mpc", "ppo"))
    sr.add_argument("--checkpoint", default="",
                    help="ppo params (.npz or a `train` state directory; "
                         "default: the shipped flagship of the preset's "
                         "topology); mpc: a warm-start plan")
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
    device(sr)

    sp = sub.add_parser("preroll", help="environment assertions (demo_18), "
                                        "the card and its kernels included")
    sp.add_argument("--live", action="store_true")
    device(sp)

    sb = sub.add_parser(
        "bootstrap", help="create the EC2NodeClass + NodePools (the "
                          "reference's missing demo_01)")
    sb.add_argument("--live", action="store_true")
    sb.add_argument("--json", action="store_true",
                    help="print the manifests instead of applying")

    swatch = sub.add_parser(
        "watch", help="the demo_40 observe session: port-forward Grafana/"
                      "Prometheus/OpenCost and smoke-query the metrics "
                      "store (dry-run prints the tunnel plan)")
    swatch.add_argument("--live", action="store_true",
                        help="actually spawn kubectl port-forwards and "
                             "hold them until interrupted")
    swatch.add_argument("--duration", type=float, default=0.0,
                        help="with --live: seconds to hold the tunnels "
                             "(0 = until Ctrl-C)")

    sg2 = sub.add_parser(
        "guardrails", help="apply the Kyverno admission ClusterPolicies "
                           "(04_kyverno analog)")
    sg2.add_argument("--live", action="store_true")
    sg2.add_argument("--json", action="store_true",
                     help="print the ClusterPolicies instead of applying")

    sm = sub.add_parser(
        "map-nodes", help="map the Karpenter node role into aws-auth so "
                          "provisioned nodes can join (demo_15 analog)")
    sm.add_argument("--account-id", required=True,
                    help="AWS account id owning the node role")
    sm.add_argument("--live", action="store_true")

    sc = sub.add_parser(
        "cleanup", help="teardown in demo_50 order: namespace, NodePools "
                        "first, NodeClaims w/ finalizer scrub")
    sc.add_argument("--live", action="store_true")
    sc.add_argument("--wipe-nodeclass", action="store_true",
                    help="also delete the EC2NodeClass (WIPE_NODECLASS)")

    sw = sub.add_parser(
        "burst", help="the demo_30 load generator: COUNT x REPLICAS "
                      "deployments alternating spot/on-demand nodeSelectors")
    sw.add_argument("--count", type=int, default=None,
                    help="deployments (default: workload.deployments, 12)")
    sw.add_argument("--replicas", type=int, default=None,
                    help="replicas each (default: workload.replicas, 5)")
    sw.add_argument("--namespace", default=None,
                    help="target namespace (default: workload.namespace)")
    sw.add_argument("--live", action="store_true")
    sw.add_argument("--json", action="store_true",
                    help="print the manifests instead of applying")
    sw.add_argument("--status", action="store_true",
                    help="readiness summary of applied deployments "
                         "(demo_30_burst_observe)")
    sw.add_argument("--delete", action="store_true",
                    help="remove the burst deployments + PDB")

    st = sub.add_parser(
        "train", help="train a learned backend; a state directory out")
    st.add_argument("--backend", default="ppo", choices=("ppo", "mpc"))
    st.add_argument("--iterations", type=int, default=40,
                    help="PPO iterations / MPC warm-start Adam steps")
    st.add_argument("--checkpoint-dir", required=True)
    st.add_argument("--seed", type=int, default=None)
    st.add_argument("--log-every", type=int, default=10)
    st.add_argument("--runlog", default="",
                    help="structured JSONL run log (obs/runlog)")
    device(st)

    se = sub.add_parser(
        "evaluate", help="scoreboard: backends on held-out traces, with "
                         "vs-rule ratios")
    se.add_argument("--backends", default="rule,mpc",
                    help="comma list of rule,carbon,mpc,ppo")
    se.add_argument("--checkpoint", default="",
                    help="params for the ppo backend (.npz or a state "
                         "directory)")
    se.add_argument("--days", type=float, default=0.25)
    se.add_argument("--traces", type=int, default=4)
    se.add_argument("--seed", type=int, default=0)
    se.add_argument("--deterministic", action="store_true",
                    help="expectation dynamics instead of sampled worlds")
    device(se)

    ss = sub.add_parser("simulate", help="batched simulator + KPI report")
    ss.add_argument("--backend", default="rule",
                    choices=("rule", "carbon", "neutral", "mpc", "ppo"))
    ss.add_argument("--checkpoint", default="",
                    help="ppo params (.npz or a state directory); mpc: a "
                         "warm-start plan")
    ss.add_argument("--forecaster", default="",
                    help="mpc planning-window source: oracle (default), "
                         "persistence, seasonal-naive, or ridge")
    ss.add_argument("--days", type=float, default=1.0)
    ss.add_argument("--clusters", type=int, default=1)
    ss.add_argument("--seed", type=int, default=0)
    ss.add_argument("--stochastic", action="store_true")
    ss.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the rollout "
                         "into this directory")
    ss.add_argument("--mesh", action="store_true",
                    help="shard the cluster batch over all devices")
    ss.add_argument("--device-traces", action="store_true",
                    help="synthesize exogenous traces on the device; "
                         "synthetic backend only")
    device(ss)

    sfe = sub.add_parser(
        "forecast-eval", help="forecast quality scoreboard: horizon-"
                              "resolved MAPE/RMSE per signal channel for "
                              "each forecaster backend")
    sfe.add_argument("--trace", default="",
                     help="replay .npz to evaluate on (default: the "
                          "configured signal source)")
    sfe.add_argument("--forecasters",
                     default="persistence,seasonal-naive,ridge",
                     help="comma list of persistence,seasonal-naive,ridge")
    sfe.add_argument("--horizon", type=int, default=0,
                     help="forecast horizon in ticks "
                          "(default: train.mpc_horizon)")
    sfe.add_argument("--history", type=int, default=0,
                     help="history window in ticks (default: each "
                          "forecaster's own requirement)")
    sfe.add_argument("--stride", type=int, default=32,
                     help="ticks between evaluation anchors")
    sfe.add_argument("--steps", type=int, default=0,
                     help="trace length to evaluate over (default: the "
                          "stored trace length, or 2 days for "
                          "synthetic/live sources)")
    sfe.add_argument("--seed", type=int, default=0)
    sfe.add_argument("--per-horizon", action="store_true",
                     help="include the full per-tick error curves "
                          "(default: summary stats only)")
    device(sfe)

    sch = sub.add_parser(
        "chaos-eval", help="fault-injection robustness scoreboard: "
                           "policies x fault intensities on paired "
                           "kernel traces")
    sch.add_argument("--intensities", default="off,mild,moderate,severe",
                     help="comma list of config.FAULT_PRESETS names; "
                          "must include 'off' (the calm denominator)")
    sch.add_argument("--policies", default="rule,flagship,mpc",
                     help="comma list of rule,carbon,flagship,mpc")
    sch.add_argument("--traces", type=int, default=0,
                     help="paired traces per intensity (0 = 256)")
    sch.add_argument("--steps", type=int, default=0,
                     help="ticks per trace (0 = one day on the card, 96 "
                          "on the CPU)")
    sch.add_argument("--seed", type=int, default=31)
    device(sch)

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
    device(sre)

    sov = sub.add_parser(
        "overload-eval", help="multi-tenant overload scoreboard "
                              "(harness/overload.py): paired stressed/"
                              "calm FleetService runs per {tenant count "
                              "x chaos intensity x slow-tenant fraction} "
                              "— healthy-tenant $/SLO-hr isolation "
                              "ratios, p50/p99 tick latency vs the "
                              "deadline, shed/deferral counts and "
                              "breaker transitions")
    sov.add_argument("--tenants", default="16,64",
                     help="comma list of fleet sizes")
    sov.add_argument("--intensities", default="off,moderate,severe",
                     help="comma list of config.CHAOS_PRESETS names "
                          "composed onto the stressed tenants' sinks")
    sov.add_argument("--slow-fracs", default="0,0.25,0.5",
                     help="comma list of stressed-tenant fractions in "
                          "[0, 1); 0 is the zero-overhead control cell")
    sov.add_argument("--profile", default="slow",
                     help="stressed-tenant archetype "
                          "(service.TENANT_PROFILES name)")
    sov.add_argument("--service", default="default",
                     help="config.SERVICE_PRESETS posture for the runs")
    sov.add_argument("--policies", default="rule,flagship",
                     help="comma list of rule,carbon,flagship (flagship "
                          "rows need a committed checkpoint for the "
                          "chosen preset's topology)")
    sov.add_argument("--ticks", type=int, default=48,
                     help="service ticks per run")
    sov.add_argument("--seed", type=int, default=211)
    device(sov)

    slsc = sub.add_parser(
        "scenarios", help="list the named workload scenario library: "
                          "family mix, fault preset and arrival shapes "
                          "per scenario")
    slsc.add_argument("--minted-dir", default="",
                      help="a --mint-out JSON file or a directory of "
                           "them; entries are digest-validated on load "
                           "and listed with a 'minted' provenance "
                           "column (search/adversarial.py)")

    ssrch = sub.add_parser(
        "scenario-search",
        help="adversarial scenario search (ccka_tpu_torch/search): CEM "
             "over the ScenarioParams axis, every iteration's population "
             "scored with one stream and one kernel launch, and the worst "
             "case minted as a named reproducible scenario (params + "
             "digest + eval geometry)")
    ssrch.add_argument("--policy", default="rule",
                       help="packed policy mode to attack: rule|carbon "
                            "(artifact-free modes only)")
    ssrch.add_argument("--objective", default="usd_per_slo_hour",
                       help="scoreboard row field the search degrades "
                            "(e.g. usd_per_slo_hour, slo_attainment, "
                            "inf_slo_violations, batch_deadline_misses)")
    ssrch.add_argument("--iters", type=int, default=5,
                       help="CEM iterations (default 5)")
    ssrch.add_argument("--pop", type=int, default=12,
                       help="candidates per iteration = the scenario "
                            "axis S (default 12)")
    ssrch.add_argument("--elite-frac", type=float, default=0.25)
    ssrch.add_argument("--intensity", default="",
                       help="scale the whole search box: mild|moderate|"
                            "severe ('' = the full validated box)")
    ssrch.add_argument("--bound", action="append", default=[],
                       metavar="NAME=LO:HI",
                       help="override one knob's box, e.g. "
                            "--bound storm_hazard=0:2 (repeatable; "
                            "unknown names rejected up front)")
    ssrch.add_argument("--mint-out", default="",
                       help="write the minted scenario document "
                            "(scenario + objective + eval geometry) to "
                            "this JSON path; `scenarios --minted-dir` "
                            "lists it, replay_minted reproduces it")
    ssrch.add_argument("--name", default="",
                       help="minted scenario name (default: "
                            "minted-<policy>-<digest8>)")
    ssrch.add_argument("--runlog", default="",
                       help="append search_iter/search_mint events to "
                            "this RunLog JSONL path")
    ssrch.add_argument("--seed", type=int, default=0)
    device(ssrch)

    sfw = sub.add_parser(
        "flywheel",
        help="continual-learning flywheel (train/flywheel.py): mine "
             "ledger-attributed weakness cells, distill a weakness-"
             "weighted challenger with checksummed provenance, promote "
             "it through the gate battery, inspect the generation "
             "inventory")
    sfw.add_argument("action",
                     choices=("mine", "distill", "promote", "status"),
                     help="mine: rank weakness cells from recorded "
                          "ledgers; distill: mine + produce generation "
                          "N's challenger + paired evaluation + gate "
                          "decision; promote: apply a generation's "
                          "recorded gate decision (atomic live swap, "
                          "refused without passing gates); status: "
                          "live pointer + generation inventory with "
                          "per-generation provenance verification")
    sfw.add_argument("--root", default="data/flywheel",
                     help="flywheel artifact root (generations/, "
                          "live.npz, live.json)")
    sfw.add_argument("--decisions", default="",
                     help="decision-ledger JSONL (obs/decisions) to "
                          "mine; '' skips the surface")
    sfw.add_argument("--tournament", default="",
                     help="tournament board JSONL (obs/tournament) to "
                          "mine; '' skips")
    sfw.add_argument("--incidents", default="",
                     help="incident JSONL (obs/incidents) to mine; "
                          "'' skips")
    sfw.add_argument("--minted-dir", default="",
                     help="minted adversarial scenarios (digest-"
                          "validated on load) to fold into the "
                          "candidate cell set")
    sfw.add_argument("--intensities", default="off,moderate",
                     help="comma list of 'off' + config.FAULT_PRESETS "
                          "names for the mined cell grid (unknown "
                          "names rejected up front)")
    sfw.add_argument("--top-k", type=int, default=4,
                     help="ranked weakness cells to keep (default 4)")
    sfw.add_argument("--generation", type=int, default=1,
                     help="generation number to distill/promote")
    sfw.add_argument("--teacher", default="mpc",
                     help="factory planner protocol: mpc|mpc-rh "
                          "(unknown teachers rejected up front)")
    sfw.add_argument("--pairs-base", type=int, default=8)
    sfw.add_argument("--pairs-max", type=int, default=32)
    sfw.add_argument("--steps", type=int, default=48,
                     help="ticks per curriculum pair window")
    sfw.add_argument("--iters", type=int, default=240,
                     help="distillation Adam iterations")
    sfw.add_argument("--decision", default="",
                     help="promote: gate-decision JSON path (default: "
                          "the generation dir's decision.json written "
                          "by `flywheel distill`)")
    sfw.add_argument("--runlog", default="",
                     help="append flywheel_* events to this RunLog "
                          "JSONL path")
    sfw.add_argument("--seed", type=int, default=0)
    sfw.add_argument("--device", default="cuda",
                     help=_DEVICE_HELP + "; only distill runs torch work")

    ssc = sub.add_parser(
        "scenario-eval", help="per-family workload scoreboard: policies x "
                              "named scenarios on paired kernel traces")
    ssc.add_argument("--scenarios",
                     default="diurnal-inference,flash-crowd,"
                             "batch-backfill,mixed",
                     help="comma list of workload scenario names "
                          "(see `scenarios`)")
    ssc.add_argument("--policies", default="rule,flagship,mpc",
                     help="comma list of rule,carbon,flagship,mpc")
    ssc.add_argument("--traces", type=int, default=0,
                     help="paired traces per scenario (0 = 256)")
    ssc.add_argument("--steps", type=int, default=0,
                     help="ticks per trace (0 = one day on the card, 96 "
                          "on the CPU)")
    ssc.add_argument("--seed", type=int, default=31)
    device(ssc)

    sdf = sub.add_parser(
        "distill-factory",
        help="MPC-distillation data factory (train/factory.py): planned "
             "(state, plan) pairs across scenario x fault-intensity cells, "
             "labeled through the CARRY kernels, as an imitation dataset")
    sdf.add_argument("--scenarios",
                     default="diurnal-inference,batch-backfill",
                     help="comma list of workload scenario names")
    sdf.add_argument("--intensities", default="off,moderate",
                     help="comma list of 'off' + config.FAULT_PRESETS "
                          "names")
    sdf.add_argument("--teacher", default="mpc",
                     help="planner protocol: 'mpc' or 'mpc-rh'")
    sdf.add_argument("--pairs", type=int, default=64,
                     help="(state, plan) pairs per cell (default 64)")
    sdf.add_argument("--steps", type=int, default=96,
                     help="ticks per pair window (default 96)")
    sdf.add_argument("--iters", type=int, default=0,
                     help="planner gradient steps per window (0 = the "
                          "factory default protocol)")
    sdf.add_argument("--student-iterations", type=int, default=0,
                     help="distill the dataset into a fresh ActorCritic "
                          "for this many Adam steps (0 = dataset/report "
                          "only)")
    sdf.add_argument("--out", default="",
                     help="write the dataset (obs/target/returns) to "
                          "this .npz path")
    sdf.add_argument("--seed", type=int, default=41)
    device(sdf)

    sg = sub.add_parser(
        "capture", help="record exogenous signals from the configured "
                        "source into a replayable .npz trace")
    sg.add_argument("--out", required=True, help="output .npz path")
    sg.add_argument("--steps", type=int, default=2880,
                    help="ticks to record (default: one day at 30s)")
    sg.add_argument("--seed", type=int, default=0)
    device(sg)

    sp = sub.add_parser(
        "report", help="summarize a controller telemetry JSONL into a "
                       "session scoreboard")
    sp.add_argument("--telemetry", required=True,
                    help="JSONL file written by `run --telemetry`")

    sob = sub.add_parser(
        "obs", help="inspect structured run logs (obs/runlog JSONL): tail "
                    "the latest records or summarize them")
    sob.add_argument("action", choices=("tail", "summarize"))
    sob.add_argument("path", help="run-log JSONL")
    sob.add_argument("-n", "--lines", type=int, default=10,
                     help="tail: records to show (default 10)")

    sf = sub.add_parser(
        "fleet", help="fleet-scale dry-run control: one batched on-device "
                      "decide over N clusters fanning out to N sinks per "
                      "tick (report PDF p.4 s9 productization)")
    sf.add_argument("--clusters", type=int, default=64)
    sf.add_argument("--ticks", type=int, default=10)
    sf.add_argument("--backend", default="rule",
                    choices=("rule", "carbon", "ppo"))
    sf.add_argument("--checkpoint", default="")
    sf.add_argument("--seed", type=int, default=0)
    sf.add_argument("--service", default="",
                    help="run the multi-tenant service layer at this "
                         "config.SERVICE_PRESETS posture instead of the "
                         "bare fleet loop (bounded ticks, per-tenant "
                         "breakers, priority shed)")
    sf.add_argument("--profiles", default="healthy",
                    help="with --service: comma list of tenant profile "
                         "archetypes, cycled over the fleet")
    sf.add_argument("--obs", default="",
                    help="with --service: run the incident-grade obs "
                         "layer at this config.OBS_PRESETS posture")
    sf.add_argument("--incidents-out", default="",
                    help="with --service + obs: append structured "
                         "incident records (JSONL) here — inspect with "
                         "`incidents`")
    sf.add_argument("--decisions-out", default="",
                    help="with --service + obs: append the decision "
                         "ledger's per-tenant provenance rows (JSONL) "
                         "here — inspect with `decisions`")
    device(sf)

    sinc = sub.add_parser(
        "incidents", help="inspect structured incident records "
                          "(obs/incidents JSONL from a service/"
                          "controller run): list them, show one with "
                          "its verified recorder dump, or reconstruct "
                          "the causal timeline around it by joining "
                          "RunLog records and trace spans on tick keys")
    sinc.add_argument("action", choices=("list", "show", "timeline"))
    sinc.add_argument("path", help="incident JSONL (IncidentLog output)")
    sinc.add_argument("--id", type=int, default=0,
                      help="show/timeline: incident id (default: show "
                           "requires one; timeline centers on it, or "
                           "covers every tick when omitted)")
    sinc.add_argument("--runlog", default="",
                      help="timeline: RunLog JSONL to join on tick keys")
    sinc.add_argument("--trace", default="",
                      help="timeline: span JSONL (SpanTracer "
                           "jsonl_path output) to join on tick keys")
    sinc.add_argument("--window", type=int, default=8,
                      help="timeline --id: ticks of context around the "
                           "incident (default 8)")

    sdec = sub.add_parser(
        "decisions", help="inspect the decision-provenance ledger "
                          "(obs/decisions JSONL from a service/"
                          "controller run): list rows, show a tick's "
                          "raw records, or explain a decision's 'why' "
                          "— objective-term shares plus what the rule "
                          "shadow would have done on the same inputs")
    sdec.add_argument("action", choices=("list", "show", "explain"))
    sdec.add_argument("path", help="decision JSONL (DecisionLedger "
                                   "output). explain labels action "
                                   "components from the CURRENT "
                                   "--preset/--config cluster layout "
                                   "— run it with the config the log "
                                   "was recorded under (a length "
                                   "mismatch falls back to bare "
                                   "indices with a note)")
    sdec.add_argument("--t", type=int, default=-1,
                      help="show/explain: tick to render (show/explain "
                           "require one; list ignores it)")
    sdec.add_argument("--tenant", type=int, default=-1,
                      help="show/explain: restrict to one tenant index "
                           "(-1 = every tenant of the tick)")
    sdec.add_argument("-n", "--lines", type=int, default=20,
                      help="list: most recent rows to print "
                           "(default 20)")

    stour = sub.add_parser(
        "tournament", help="shadow-tournament observatory "
                           "(obs/tournament JSONL from a service run): "
                           "list the registered candidate builders, "
                           "render the windowed per-class win board, "
                           "or explain a signed promotion audit — who "
                           "beat whom, on which windows and classes, "
                           "with the signature verified")
    stour.add_argument("action", choices=("list", "board", "explain"))
    stour.add_argument("path", nargs="?", default="",
                       help="tournament JSONL (TournamentLedger "
                            "output; board/explain require it, list "
                            "ignores it)")
    stour.add_argument("--t", type=int, default=-1,
                       help="board/explain: tick to render (default: "
                            "the most recent board/audit row)")
    stour.add_argument("--key", default="",
                       help="explain: HMAC audit key (default: the "
                            "--preset/--config obs.tournament_audit_"
                            "key)")

    sd = sub.add_parser(
        "dashboard", help="render/apply the demo_40 observability stage: "
                          "Grafana Deployment/Service/admin-Secret plus "
                          "datasource+dashboard provisioning")
    sd.add_argument("--live", action="store_true")
    sd.add_argument("--json", action="store_true",
                    help="print the manifests instead of applying")
    sd.add_argument("--provision-only", action="store_true",
                    help="render only the ConfigMaps")

    spl = sub.add_parser(
        "pipeline", help="render/apply the metrics-pipeline deploy stage "
                         "(06_opencost.sh:204-387 analog)")
    spl.add_argument("--remote-write-url", default="",
                     help="prometheusremotewrite endpoint (default: "
                          "derived from signals.prometheus_url)")
    spl.add_argument("--region", default="",
                     help="enable SigV4 auth for this AWS region (AMP)")
    spl.add_argument("--writer-role-arn", default="",
                     help="IRSA role annotation for the collector SA")
    spl.add_argument("--query-role-arn", default="",
                     help="IRSA role annotation for the query-proxy SA")
    spl.add_argument("--proxy", action="store_true",
                     help="also render the SigV4 query proxy "
                          "Deployment/Service (requires --region)")
    spl.add_argument("--live", action="store_true")
    spl.add_argument("--json", action="store_true",
                     help="print the manifests instead of applying")

    sgeo = sub.add_parser(
        "geo", help="geo-arbitrage scoreboard (regions/pareto): run "
                    "the regional scenario suite (spot storms, "
                    "capacity denials, carbon seesaws) under the "
                    "migration-policy library and print the cost/"
                    "carbon/SLO Pareto front per workload class")
    sgeo.add_argument("--scenarios", default="",
                      help="comma-separated scenario names (default: "
                           "every library scenario); unknown names "
                           "are rejected up front")
    sgeo.add_argument("--policies", default="",
                      help="comma-separated migration-policy names "
                           "(default: every library policy); the "
                           "'none' baseline is always included")
    sgeo.add_argument("--steps", type=int, default=192,
                      help="rollout horizon in ticks (default 192)")
    sgeo.add_argument("--batch", type=int, default=8,
                      help="batched rollouts per scenario (default 8)")
    sgeo.add_argument("--seed", type=int, default=0,
                      help="suite seed (default 0)")
    sgeo.add_argument("--json", action="store_true",
                      help="print the raw suite record instead of "
                           "the rendered scoreboard")
    device(sgeo)

    sub.add_parser("show-config", help="print the resolved config")
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


def _device(name: str):
    """The torch device a subcommand asked for; exits naming it when it
    is absent (no silent fallback to the CPU)."""
    from ccka_tpu_torch import resolve_device
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(f"ccka: --device {name}: {e}")


def _source(cfg: FrameworkConfig):
    from ccka_tpu_torch.signals.live import make_signal_source
    return make_signal_source(cfg.cluster, cfg.workload, cfg.sim, cfg.signals,
                              faults=cfg.faults, workloads=cfg.workloads)


def _lead(trace):
    """A [T, ...] trace as a batch of one cluster."""
    return type(trace)(*(x[None] for x in trace))


def _cmd_profile(cfg: FrameworkConfig, profile: str, live: bool,
                 as_json: bool) -> int:
    from ccka_tpu_torch.actuation.patches import render_nodepool_patches
    from ccka_tpu_torch.actuation.sink import DryRunSink, KubectlSink
    from ccka_tpu_torch.policy.rule import (neutral_action, offpeak_action,
                                            peak_action)

    action, op = {
        "offpeak": (offpeak_action(cfg.cluster, "cpu"), "replace"),
        "peak": (peak_action(cfg.cluster, "cpu"), "add"),
        "reset": (neutral_action(cfg.cluster, "cpu"), "replace"),
    }[profile]
    patches = render_nodepool_patches(action, cfg.cluster, op=op)

    if as_json:
        print(json.dumps([{
            "pool": ps.pool,
            "disruption_merge": ps.disruption_merge,
            "requirements_json": ps.requirements_json,
        } for ps in patches], indent=2))

    sink = KubectlSink() if live else DryRunSink(echo=not as_json)
    results = sink.apply_all(patches)
    ok = all(r.ok for r in results)
    for r in results:
        status = "ok" if r.ok else "FAILED"
        fb = " (fallback path)" if r.used_fallback else ""
        print(f"[{status}] nodepool/{r.pool}{fb}", file=sys.stderr)
        if not r.ok and r.detail:
            print(r.detail, file=sys.stderr)
    print(f"[{'ok' if ok else 'err'}] {profile} profile "
          f"{'applied' if live else 'rendered (dry-run)'}", file=sys.stderr)
    return 0 if ok else 1


def _load_ppo_params(checkpoint: str):
    """PPO params from an .npz (`train/checkpoint.py::save_params_npz`,
    the shipped flagships' format) or from a state directory that
    `train --backend ppo` wrote."""
    from ccka_tpu_torch.train.checkpoint import load_params_npz, load_state

    if checkpoint.endswith(".npz"):
        return load_params_npz(checkpoint)[0]
    try:
        return load_state(checkpoint)
    except (OSError, ValueError, KeyError) as e:
        raise SystemExit(f"ccka: cannot load ppo params {checkpoint!r}: "
                         f"{e}")


def make_backend(cfg: FrameworkConfig, name: str, checkpoint: str = "",
                 forecaster: str = "", *, device=None):
    """The backend of a CLI spelling on ``device`` (the card unless
    ``device="cpu"``), shared by observe, simulate, run and evaluate.
    ``forecaster`` (mpc only) names a `ccka_tpu_torch.forecast` backend
    the planner replans against; empty or "oracle" keeps the
    perfect-foresight windows. ``ppo`` without a checkpoint loads the
    shipped flagship of the config's topology; ``mpc`` with one starts
    from the warm-start plan that ``train --backend mpc`` wrote."""
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
        backend = MPCBackend(cfg, forecaster=fc, device=device)
        if checkpoint:  # trained warm-start plan (train --backend mpc)
            import torch

            from ccka_tpu_torch.train.checkpoint import load_state
            try:
                plan = torch.as_tensor(load_state(checkpoint)["plan"])
            except (OSError, ValueError, KeyError) as e:
                raise SystemExit(f"ccka: cannot load the mpc plan "
                                 f"{checkpoint!r}: {e}")
            if plan.shape != backend._plan.shape:
                raise SystemExit(
                    f"ccka: the mpc plan {checkpoint!r} is "
                    f"{tuple(plan.shape)}, this config plans "
                    f"{tuple(backend._plan.shape)}")
            backend._plan = plan.to(device=device, dtype=torch.float32)
        return backend
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
        return PPOBackend(cfg, _load_ppo_params(checkpoint), device=device)
    raise SystemExit(f"ccka: unknown backend {name!r}")


def _cmd_observe(cfg: FrameworkConfig, args) -> int:
    """The first tick's decision of a backend from a fresh cluster, on
    the card (a batch of one, as the controller runs it)."""
    from ccka_tpu_torch.harness.controller import _batch1
    from ccka_tpu_torch.sim.dynamics import ExoStep
    from ccka_tpu_torch.sim.rollout import initial_state

    dev = _device(args.device)
    src = _source(cfg)
    exo = ExoStep(*src.tick(0, device=dev))
    policy = make_backend(cfg, args.backend, args.checkpoint, device=dev)
    state0 = initial_state(cfg, 1, dev)
    if hasattr(policy, "replan"):  # receding-horizon backends plan first
        policy.replan(state0, _lead(src.trace(policy.horizon, device=dev)))
    action = _batch1(policy.decide(state0, exo, 0))
    action = type(action)(*(x[0].detach().cpu() for x in action))
    is_peak = float(exo.is_peak[0]) > 0.5
    out = {
        "backend": args.backend,
        "is_peak": is_peak,
        "consolidate_after_s": [float(x) for x in action.consolidate_after_s],
        "consolidation_aggr": [float(x) for x in action.consolidation_aggr],
        "zone_weight": [[float(x) for x in row] for row in action.zone_weight],
    }
    if hasattr(policy, "profile_name"):
        out["profile"] = policy.profile_name(is_peak)
    print(json.dumps(out, indent=2))
    return 0


def _cmd_run(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.harness.controller import (ControllerLockHeld,
                                                   controller_from_config)

    if args.resume and not args.snapshot:
        raise SystemExit("ccka: --resume needs --snapshot PATH (the "
                         "snapshot file to restore from and keep "
                         "writing to)")
    dev = _device(args.device)
    resume_body = None
    if args.resume:
        from ccka_tpu_torch.harness.snapshot import (SnapshotError,
                                                     load_snapshot)
        try:
            resume_body = load_snapshot(args.snapshot)
        except SnapshotError as e:
            raise SystemExit(f"ccka: {e}")
    backend = make_backend(cfg, args.backend, args.checkpoint,
                           forecaster=args.forecaster, device=dev)
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
            cfg, backend, device=dev, live=args.live,
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


def simulate_report(summary, backend: str, clusters: int,
                    days: float) -> dict:
    """``simulate``'s report: each EpisodeSummary field's mean over the
    clusters (numpy's float32 mean, as the JAX package takes it), then
    the run's backend, clusters and days."""
    import numpy as np

    report = {k: np.asarray(v.detach().cpu()).mean().item()
              for k, v in summary._asdict().items()}
    report["backend"] = backend
    report["clusters"] = clusters
    report["days"] = days
    return report


def _fleet_summary(cfg, src, params, backend: str, backend_obj, action_fn,
                   steps: int, clusters: int, seed: int, stochastic: bool,
                   device_traces: bool, dev, mesh: bool = False,
                   backend_on=None):
    """The batch path of ``simulate``: one EpisodeSummary per cluster.

    rule, carbon and neutral go through the profile kernel's entries
    (`sim/megakernel.py`): the rule's off-peak and peak actions, the
    neutral action in both places, or the carbon teacher with the
    policy's constants (as `faults/scoreboard.py::score_rows` passes
    them). A source whose packed stream carries fault or workload lanes
    is synthesized packed on the device, as the boards do, and the
    ``*_summary_from_packed`` entries select the lane instantiation. On
    ``--device cpu`` the same entries run their plain versions, the
    semantics of `sim/rollout.py::batched_rollout_summary`. Every other
    backend (ppo) runs the plain rollout, with the lanes threaded
    through. ``mesh`` splits the fleet over every device
    (`parallel/mesh.py::make_mesh` of ``cfg.mesh``; one shard on one
    card or on the CPU): the sharded entries of
    `parallel/sharded_kernel.py` for the kernel backends, the sharded
    plain rollout for the rest (each device's action function from its
    own backend, ``backend_on(device)``), the summary gathered on
    ``dev``; on a one-shard mesh bitwise the same summary as without."""
    import torch

    from ccka_tpu_torch.faults.process import unpack_fault_lanes
    from ccka_tpu_torch.policy.rule import (neutral_action, offpeak_action,
                                            peak_action)
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            initial_state)
    from ccka_tpu_torch.workloads.process import unpack_workload_lanes

    Z = cfg.cluster.n_zones
    has_faults = getattr(src, "faults", None) is not None
    has_workloads = getattr(src, "workloads", None) is not None
    lanes = has_faults or has_workloads
    if (lanes or device_traces) and not getattr(
            src, "supports_device_traces", False):
        raise SystemExit(
            "ccka: --device-traces requires the synthetic signals backend"
            if device_traces else
            "ccka: a stream with fault or workload lanes is synthesized on "
            "the device: the synthetic signals backend only")
    stream, lane_kw = None, {}
    if lanes:
        stream = src.packed_trace_device(steps, seed + 7919, clusters,
                                         device=dev)
        traces = mk.unpack_exo(stream, steps, Z)
        lane_kw = dict(
            faults=unpack_fault_lanes(stream, steps, Z) if has_faults
            else None,
            workloads=unpack_workload_lanes(stream, steps, Z)
            if has_workloads else None)
    elif device_traces:
        traces = src.batch_trace_device(
            steps, torch.Generator(device=dev).manual_seed(seed + 7919),
            clusters, device=dev)
    else:
        traces = src.batch_trace(steps, [seed + i for i in range(clusters)],
                                 device=dev)
    dev_mesh = None
    if mesh:
        from ccka_tpu_torch.parallel import make_mesh
        from ccka_tpu_torch.parallel import sharded as psh
        from ccka_tpu_torch.parallel import sharded_kernel as psk
        from ccka_tpu_torch.parallel.mesh import gather

        dev_mesh = make_mesh(cfg.mesh, device=dev)
    if backend not in ("rule", "neutral", "carbon"):
        states0 = initial_state(cfg, clusters, dev)
        if dev_mesh is not None:
            fns: dict = {}

            def action_fn_for(d):
                if str(d) not in fns:
                    fns[str(d)] = backend_on(d).action_fn()
                return fns[str(d)]

            return gather(psh.sharded_batched_rollout_summary(
                dev_mesh, params, states0, None, traces, seed,
                stochastic=stochastic, action_fn_for=action_fn_for,
                **lane_kw)[1], dev)
        return batched_rollout_summary(
            params, states0, action_fn, traces, seed,
            stochastic=stochastic, **lane_kw)[1]
    if stream is None:
        stream = mk._pack_exo(traces, steps)
    off, peak = offpeak_action(cfg.cluster, dev), peak_action(cfg.cluster,
                                                              dev)
    if backend == "neutral":
        off = peak = neutral_action(cfg.cluster, dev)
    kw = dict(stochastic=stochastic)
    if backend == "carbon":
        kw.update(sharpness=backend_obj.sharpness,
                  min_weight=backend_obj.min_weight,
                  stickiness=backend_obj.stickiness)
    if dev_mesh is not None:
        entry = (psk.sharded_carbon_summary_from_packed if backend == "carbon"
                 else psk.sharded_megakernel_summary_from_packed)
        return gather(entry(dev_mesh, params, off, peak, stream, steps, seed,
                            **kw), dev)
    entry = (mk.carbon_megakernel_summary_from_packed if backend == "carbon"
             else mk.megakernel_summary_from_packed)
    return entry(params, off, peak, stream, steps, seed, **kw)


def _cmd_simulate(cfg: FrameworkConfig, args) -> int:
    """The batched simulator and its KPI report.

    With ``--clusters > 1`` the rule, carbon and neutral backends score
    the fleet through the profile kernel (:func:`_fleet_summary`). ppo
    stays on the plain rollout, as in the JAX package: the MLP kernel
    computes `sim/megakernel.py::kernel_numerics_action_fn` (the
    kernel's bf16 numerics), not ``PPOBackend.action_fn``. The
    single-cluster path and the receding-horizon mpc run the plain
    rollout, as there. ``--mesh`` splits the batch over every device
    (:func:`_fleet_summary`)."""
    import torch

    from ccka_tpu_torch.harness.telemetry import profile_trace
    from ccka_tpu_torch.policy.rule import neutral_action
    from ccka_tpu_torch.sim.metrics import summarize
    from ccka_tpu_torch.sim.rollout import initial_state, rollout
    from ccka_tpu_torch.sim.types import SimParams

    dev = _device(args.device)
    backend, clusters, seed = args.backend, args.clusters, args.seed
    params = SimParams.from_config(cfg, device=dev)
    steps = int(args.days * 86400.0 / cfg.sim.dt_s)
    src = _source(cfg)

    if clusters == 1 and (args.mesh or args.device_traces):
        raise SystemExit("ccka: --mesh/--device-traces are batch-path "
                         "flags; set --clusters > 1 (they would be "
                         "silently ignored on the single-cluster path)")

    backend_obj = None
    receding = False
    if backend == "neutral":
        neutral = neutral_action(cfg.cluster, dev)
        action_fn = lambda s, e, t: neutral  # noqa: E731
        if args.forecaster:
            from ccka_tpu_torch.forecast.base import make_forecaster
            if make_forecaster(args.forecaster,
                               dt_s=cfg.sim.dt_s) is not None:
                raise SystemExit("ccka: --forecaster only applies to the "
                                 "mpc backend")
    else:
        backend_obj = make_backend(cfg, backend, args.checkpoint,
                                   forecaster=args.forecaster, device=dev)
        # Receding-horizon backends carry host-side plan state a fixed
        # action_fn would freeze; they run their own closed loop.
        receding = getattr(backend_obj, "requires_receding_horizon", False)
        if not receding:
            action_fn = backend_obj.action_fn()
    if receding and clusters != 1:
        raise SystemExit(f"ccka: --backend {backend} simulates one cluster "
                         "(receding-horizon); use `ccka evaluate "
                         f"--backends {backend}` for paired comparisons")

    with profile_trace(args.profile_dir):
        if clusters == 1:
            trace = _lead(src.trace(steps, seed=seed, device=dev))
            if receding:
                _final, metrics = backend_obj.evaluate(
                    initial_state(cfg, 1, dev), trace, seed,
                    stochastic=args.stochastic)
            else:
                _final, metrics = rollout(params, initial_state(cfg, 1, dev),
                                          action_fn, trace, seed,
                                          stochastic=args.stochastic)
            s = summarize(params, metrics)
        else:
            s = _fleet_summary(cfg, src, params, backend, backend_obj,
                               action_fn, steps, clusters, seed,
                               args.stochastic, args.device_traces, dev,
                               mesh=args.mesh, backend_on=lambda d:
                               make_backend(cfg, backend, args.checkpoint,
                                            forecaster=args.forecaster,
                                            device=d))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    print(json.dumps(simulate_report(s, backend, clusters, args.days),
                     indent=2))
    return 0


def _cmd_forecast_eval(cfg: FrameworkConfig, args) -> int:
    """Forecast quality scoreboard: horizon-resolved MAPE/RMSE per signal
    channel for each forecaster backend (`forecast/`). The oracle row is
    omitted by construction: its error is identically zero."""
    from ccka_tpu_torch.forecast.base import make_forecaster
    from ccka_tpu_torch.forecast.metrics import evaluate_forecaster

    dev = _device(args.device)
    if args.trace:
        from ccka_tpu_torch.signals.replay import ReplaySignalSource
        try:
            src = ReplaySignalSource.from_file(args.trace)
        except (OSError, KeyError, ValueError) as e:
            raise SystemExit(f"ccka: cannot load trace {args.trace!r}: {e}")
        steps = args.steps or src._trace.steps
        # The trace's own cadence sets the seasonal period.
        dt_s = src.meta().dt_s or cfg.sim.dt_s
    else:
        src = _source(cfg)
        steps = args.steps or int(2 * 86400.0 / cfg.sim.dt_s)
        dt_s = cfg.sim.dt_s
    trace = src.trace(steps, seed=args.seed, device=dev)
    horizon = args.horizon or cfg.train.mpc_horizon

    out = {"trace": args.trace or cfg.signals.backend, "steps": int(steps),
           "horizon": int(horizon), "dt_s": dt_s,
           "forecasters": {}}
    for name in _names(args.forecasters):
        try:
            fc = make_forecaster(name, dt_s=dt_s)
        except ValueError as e:
            raise SystemExit(f"ccka: {e}")
        if fc is None:
            print("# oracle forecast error is zero by definition — row "
                  "omitted", file=sys.stderr)
            continue
        try:
            row = evaluate_forecaster(fc, trace, horizon=horizon,
                                      history_steps=args.history or None,
                                      stride=args.stride)
        except ValueError as e:  # e.g. trace shorter than history+horizon
            raise SystemExit(f"ccka: {name}: {e}")
        if not args.per_horizon:
            for field, errs in row.items():
                if isinstance(errs, dict) and "mape" in errs:
                    row[field] = {
                        "mape_h1": round(errs["mape"][0], 5),
                        "mape_hlast": round(errs["mape"][-1], 5),
                        "rmse_h1": round(errs["rmse"][0], 5),
                        "rmse_hlast": round(errs["rmse"][-1], 5),
                    }
        out["forecasters"][name] = row
    print(json.dumps(out, indent=2))
    return 0


def _cmd_distill_factory(cfg: FrameworkConfig, args) -> int:
    """The MPC-distillation data factory (`train/factory.py`). Unknown
    scenario, intensity and teacher names are rejected before anything
    runs."""
    from ccka_tpu_torch.train import factory as factory_mod

    dev = _device(args.device)
    scenarios, intensities = _names(args.scenarios), _names(args.intensities)
    try:
        factory_mod.validate_factory_names(
            scenarios=scenarios, intensities=intensities,
            teacher=args.teacher)
        dataset, report = factory_mod.factory_run(
            cfg, scenarios=scenarios, intensities=intensities,
            teacher=args.teacher, pairs_per_cell=args.pairs,
            steps=args.steps,
            iters=args.iters or factory_mod.FACTORY_ITERS,
            seed=args.seed, with_ledger=True, device=dev)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    if args.out:
        import numpy as np

        np.savez_compressed(
            args.out, obs=dataset.obs.detach().cpu().numpy(),
            target=dataset.target.detach().cpu().numpy(),
            returns=dataset.returns.detach().cpu().numpy())
        report = dict(report, dataset_path=args.out)
    if args.student_iterations > 0:
        from ccka_tpu_torch.train.imitate import imitate

        _params, hist = imitate(cfg, None, None, dataset=dataset,
                                iterations=args.student_iterations,
                                seed=args.seed, device=dev)
        report = dict(report,
                      student={"iterations": args.student_iterations,
                               "final_actor_mse": round(
                                   hist[-1]["actor_mse"], 5),
                               "final_critic_mse": round(
                                   hist[-1]["critic_mse"], 5)})
    print(json.dumps(report, indent=2))
    return 0


def _cmd_capture(cfg: FrameworkConfig, args) -> int:
    """Record the configured source into a replayable .npz
    (`signals/replay.py::save_trace`, the JAX package's layout)."""
    from ccka_tpu_torch.signals.replay import save_trace

    dev = _device(args.device)
    src = _source(cfg)
    trace = src.trace(args.steps, seed=args.seed, device=dev)
    save_trace(args.out, trace, src.meta())
    print(json.dumps({"out": args.out, "steps": args.steps,
                      "source": src.meta().source,
                      "zones": list(src.meta().zones)}))
    return 0


def _cmd_train(cfg: FrameworkConfig, args) -> int:
    """Train a learned backend into a state directory
    (`train/checkpoint.py::save_state`): PPO params in the checkpoints'
    flax layout, or mpc's warm-start plan (a plan optimized against a
    representative window, which seeds replans)."""
    from ccka_tpu_torch.obs.runlog import RunLog
    from ccka_tpu_torch.train.checkpoint import save_state

    dev = _device(args.device)
    src = _source(cfg)
    rl = RunLog(args.runlog or None, kind=f"{args.backend}-train",
                meta={"iterations": args.iterations, "seed": args.seed})
    if args.backend == "ppo":
        from ccka_tpu_torch import bridge
        from ccka_tpu_torch.train.ppo import PPOTrainer
        trainer = PPOTrainer(cfg, device=dev)
        ts, history = trainer.train(src, args.iterations, seed=args.seed,
                                    log_every=args.log_every or 1,
                                    runlog=rl)
        for rec in history:
            print(json.dumps(rec))
        path = save_state(args.checkpoint_dir,
                          bridge.actor_critic_to_flax(ts.params),
                          step=int(ts.iteration))
        rl.close(checkpoint=path)
        print(f"[ok] ppo params -> {path}", file=sys.stderr)
        return 0
    from ccka_tpu_torch.models.nets import action_to_latent
    from ccka_tpu_torch.policy.rule import neutral_action
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train.mpc import optimize_plan
    h = cfg.train.mpc_horizon
    base = action_to_latent(neutral_action(cfg.cluster, dev), cfg.cluster)
    init = base.expand(h, *base.shape)
    result = optimize_plan(SimParams.from_config(cfg, device=dev),
                           cfg.cluster, cfg.train, initial_state(cfg, 1, dev),
                           src.trace(h, seed=args.seed or cfg.train.seed,
                                     device=dev),
                           init, iters=args.iterations)
    first, final = float(result.losses[0]), float(result.losses[-1])
    print(json.dumps({"final_objective": final, "first_objective": first}))
    path = save_state(args.checkpoint_dir, {"plan": result.plan_latent},
                      step=args.iterations)
    rl.event("mpc_plan", first_objective=first, final_objective=final,
             iters=args.iterations)
    rl.close(checkpoint=path)
    print(f"[ok] mpc warm-start plan -> {path}", file=sys.stderr)
    return 0


def _cmd_evaluate(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.train.evaluate import compare_backends, heldout_traces

    dev = _device(args.device)
    src = _source(cfg)
    steps = max(int(args.days * 86400.0 / cfg.sim.dt_s), 1)
    traces = heldout_traces(src, steps=steps, n=args.traces,
                            seed0=10_000 + args.seed, device=dev)
    backends = {name: make_backend(cfg, name, args.checkpoint, device=dev)
                for name in args.backends.split(",") if name}
    board = compare_backends(cfg, backends, traces,
                             stochastic=not args.deterministic)
    print(json.dumps(board, indent=2, sort_keys=True))
    return 0


def _cmd_bootstrap(cfg: FrameworkConfig, live: bool, as_json: bool) -> int:
    from ccka_tpu_torch.actuation.bootstrap import (
        bootstrap, render_ec2nodeclass_manifest, render_nodepool_manifest)
    from ccka_tpu_torch.actuation.sink import DryRunSink, KubectlSink

    if as_json:
        docs = [render_ec2nodeclass_manifest(cfg.cluster)]
        docs += [render_nodepool_manifest(cfg.cluster, p)
                 for p in cfg.cluster.pools]
        print(json.dumps(docs, indent=2))
        return 0
    sink = KubectlSink() if live else DryRunSink(echo=True)
    results = bootstrap(cfg, sink)
    ok = all(r.ok for r in results)
    for r in results:
        print(f"[{'ok' if r.ok else 'FAILED'}] {r.pool}"
              + (f" — {r.detail}" if r.detail else ""), file=sys.stderr)
    print(f"[{'ok' if ok else 'err'}] bootstrap "
          f"{'applied' if live else 'rendered (dry-run)'}", file=sys.stderr)
    return 0 if ok else 1


def _apply_docs(docs: list, live: bool, label: str, *, sink=None) -> int:
    """Shared render -> sink -> per-result report path for the manifest
    commands."""
    from ccka_tpu_torch.actuation.sink import DryRunSink, KubectlSink

    if sink is None:
        sink = KubectlSink() if live else DryRunSink(echo=True)
    results = sink.apply_manifests(docs)
    ok = all(r.ok for r in results)
    for r in results:
        print(f"[{'ok' if r.ok else 'FAILED'}] {r.pool}"
              + (f" — {r.detail}" if r.detail else ""), file=sys.stderr)
    print(f"[{'ok' if ok else 'err'}] {label} "
          f"{'applied' if live else 'rendered (dry-run)'}", file=sys.stderr)
    return 0 if ok else 1


def _cmd_burst(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.actuation.burst import (apply_burst, burst_status,
                                                delete_burst,
                                                render_burst_deployments,
                                                render_burst_pdb,
                                                render_burst_rbac)
    from ccka_tpu_torch.actuation.sink import DryRunSink, KubectlSink

    ns = args.namespace or cfg.workload.namespace
    if args.json and (args.delete or args.status):
        raise SystemExit("ccka: burst --json renders the creation "
                         "manifests and conflicts with --delete/--status "
                         "(--status output is already JSON)")
    if args.json:
        docs = render_burst_rbac(ns)
        docs.append(render_burst_pdb(cfg.workload, ns))
        docs += render_burst_deployments(cfg.workload, ns,
                                         count=args.count,
                                         replicas=args.replicas)
        print(json.dumps(docs, indent=2))
        return 0
    sink = KubectlSink() if args.live else DryRunSink(echo=True)
    if args.delete:
        ok = delete_burst(sink, ns)
        print("[ok] burst workload removed" if ok
              else "[err] burst delete failed", file=sys.stderr)
        return 0 if ok else 1
    if args.status:
        print(json.dumps(burst_status(sink, ns), indent=2))
        return 0
    results = apply_burst(cfg.workload, sink, ns,
                          count=args.count, replicas=args.replicas)
    ok = all(r.ok for r in results)
    for r in results:
        if not r.ok:
            print(f"[FAILED] {r.pool} — {r.detail}", file=sys.stderr)
    print(f"[{'ok' if ok else 'err'}] burst: {len(results)} object(s) "
          f"{'applied' if args.live else 'rendered (dry-run)'}",
          file=sys.stderr)
    return 0 if ok else 1


def _cmd_map_nodes(cfg: FrameworkConfig, account_id: str, live: bool) -> int:
    from ccka_tpu_torch.actuation.bootstrap import ensure_node_role_mapping
    from ccka_tpu_torch.actuation.sink import DryRunSink, KubectlSink

    sink = KubectlSink() if live else DryRunSink(echo=True)
    if not live:
        # Seed a representative aws-auth so the dry-run demonstrates the
        # patch it would make against a real cluster.
        sink.objects[("configmap", "kube-system", "aws-auth")] = {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "aws-auth", "namespace": "kube-system"},
            "data": {"mapRoles": ""},
        }
    r = ensure_node_role_mapping(cfg, sink, account_id=account_id)
    print(f"[{'ok' if r.ok else 'FAILED'}] {r.pool}"
          + (f" — {r.detail}" if r.detail else ""), file=sys.stderr)
    return 0 if r.ok else 1


def _cmd_cleanup(cfg: FrameworkConfig, live: bool,
                 wipe_nodeclass: bool) -> int:
    from ccka_tpu_torch.actuation.bootstrap import cleanup
    from ccka_tpu_torch.actuation.sink import DryRunSink, KubectlSink

    sink = KubectlSink() if live else DryRunSink(echo=True)
    results = cleanup(cfg, sink, wipe_nodeclass=wipe_nodeclass)
    ok = all(good for _, good in results)
    for name, good in results:
        print(f"[{'ok' if good else 'FAILED'}] delete {name}",
              file=sys.stderr)
    print(f"[{'ok' if ok else 'err'}] cleanup "
          f"{'done' if live else 'rendered (dry-run)'}", file=sys.stderr)
    return 0 if ok else 1


def _cmd_dashboard(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.actuation.sink import DryRunSink, KubectlSink
    from ccka_tpu_torch.harness.dashboard import (render_dashboard_configmap,
                                                  render_observability_stack)
    if args.provision_only:
        docs = render_dashboard_configmap(cfg.signals.prometheus_url,
                                          cfg.workload.namespace)
    else:
        # The whole demo_40 configure stage: provisioning, admin Secret,
        # Grafana Deployment/Service.
        docs = render_observability_stack(cfg.signals.prometheus_url,
                                          cfg.workload.namespace)
    if args.json:
        print(json.dumps(docs, indent=2))
        return 0
    sink = KubectlSink() if args.live else DryRunSink(echo=True)
    # Re-applying must not rotate an existing admin Secret: the running
    # Grafana resolved its password at container start
    # (demo_40_watch_config.sh:36-48).
    existing = sink.get_object("Secret", "ccka-grafana-admin",
                               namespace=cfg.workload.namespace)
    if existing:
        docs = [d for d in docs if d.get("kind") != "Secret"]
        print("[ok] existing grafana admin secret preserved",
              file=sys.stderr)
    return _apply_docs(docs, args.live, "dashboard stack", sink=sink)


def _cmd_pipeline(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.harness.pipeline import render_metrics_pipeline
    if args.query_role_arn and not args.proxy:
        # The query role only lands on the proxy's SA.
        raise SystemExit("ccka: --query-role-arn has no effect "
                         "without --proxy")
    rw_url = args.remote_write_url or (
        cfg.signals.prometheus_url.rstrip("/")
        # AMP serves remote-write at /api/v1/remote_write; plain
        # Prometheus at /api/v1/write.
        + ("/api/v1/remote_write" if args.region else "/api/v1/write"))
    try:
        docs = render_metrics_pipeline(
            rw_url, cfg.workload.namespace, region=args.region,
            writer_role_arn=args.writer_role_arn,
            query_role_arn=args.query_role_arn, proxy=args.proxy)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    if args.json:
        print(json.dumps(docs, indent=2))
        return 0
    return _apply_docs(docs, args.live, "metrics pipeline")


def _cmd_watch(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.harness.watch import WatchSession, watch_plan
    if not args.live:
        # Dry-run prints the tunnel plan only: no network I/O.
        plan = watch_plan(cfg)
        for fw in plan:
            print(f"[dry-run] would run: {' '.join(fw.argv())}",
                  file=sys.stderr)
        print(json.dumps({"plan": [fw.name for fw in plan]}, indent=2))
        return 0
    with WatchSession(cfg) as session:
        try:
            ready = session.start()
        except RuntimeError as e:  # e.g. kubectl missing
            raise SystemExit(f"ccka: {e}")
        for name, ok in ready.items():
            print(f"[{'ok' if ok else 'err'}] tunnel {name}",
                  file=sys.stderr)
        smoke = session.smoke()
        print(json.dumps({"ready": ready, "smoke": smoke}, indent=2))
        if not all(ready.values()):
            return 1
        try:
            if args.duration > 0:
                time.sleep(args.duration)
            else:
                print("[ok] tunnels up — Ctrl-C to stop", file=sys.stderr)
                while True:
                    time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return 0


def _cmd_board(cfg: FrameworkConfig, args) -> int:
    """chaos-eval and scenario-eval: the fault and workload boards
    (`faults/scoreboard.py`, `workloads/scoreboard.py`) on the card."""
    dev = _device(args.device)
    kw = dict(policies=_names(args.policies), n_traces=args.traces or 256,
              eval_steps=args.steps or None, seed=args.seed, device=dev)
    try:
        if args.command == "chaos-eval":
            from ccka_tpu_torch.faults.scoreboard import fault_scoreboard
            board = fault_scoreboard(
                cfg, intensities=_names(args.intensities), **kw)
        else:
            from ccka_tpu_torch.workloads.scoreboard import (
                workload_scoreboard)
            board = workload_scoreboard(
                cfg, scenarios=_names(args.scenarios), **kw)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    print(json.dumps(board, indent=2))
    return 0


def _cmd_recover_eval(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.harness.recovery import recovery_scoreboard

    dev = _device(args.device)
    try:
        board = recovery_scoreboard(
            cfg, intensities=_names(args.intensities),
            policies=_names(args.policies), runs_per_cell=args.runs,
            ticks=args.ticks, seed=args.seed, device=dev)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    print(json.dumps(board, indent=2))
    return 0


def _cmd_overload_eval(cfg: FrameworkConfig, args) -> int:
    from ccka_tpu_torch.harness.overload import overload_scoreboard

    dev = _device(args.device)
    try:
        board = overload_scoreboard(
            cfg,
            tenants=tuple(int(s) for s in args.tenants.split(",")
                          if s.strip()),
            intensities=_names(args.intensities),
            slow_fracs=tuple(float(s) for s in args.slow_fracs.split(",")
                             if s.strip()),
            slow_profile=args.profile,
            service_preset=args.service,
            policies=_names(args.policies),
            ticks=args.ticks,
            seed=args.seed, device=dev)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    print(json.dumps(board, indent=2))
    return 0


def _cmd_geo(cfg: FrameworkConfig, args) -> int:
    """The Pareto scoreboard: the migration-policy library on the
    regional scenario suite, rendered as the cost / carbon / SLO front
    per workload class."""
    from ccka_tpu_torch.regions.migrate import GEO_POLICIES
    from ccka_tpu_torch.regions.pareto import GEO_SCENARIOS, run_geo_suite

    scenarios = list(_names(args.scenarios)) or sorted(GEO_SCENARIOS)
    policies = list(_names(args.policies)) or sorted(GEO_POLICIES)
    dev = _device(args.device)
    try:
        suite = run_geo_suite(
            scenarios=scenarios, policies=policies,
            zone_region_index=cfg.cluster.zone_region_index,
            seed=args.seed, steps=max(args.steps, 8),
            batch=max(args.batch, 1), dt_s=cfg.sim.dt_s, device=dev)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    if args.json:
        print(json.dumps(suite, indent=2, sort_keys=True))
        return 0
    for scn in suite["scenarios"]:
        print(f"== {scn['scenario']}: {scn['description']}")
        for klass in suite["classes"]:
            fr = scn["pareto"][klass]
            print(f"  {klass}: front = {', '.join(fr['front'])}"
                  + (f"; dominates none: "
                     f"{', '.join(fr['dominates_none'])}"
                     if fr["dominates_none"] else ""))
            for pname in suite["policies"]:
                usd, kg, slo = fr["points"][pname]
                tag = ("*" if pname in fr["front"] else " ")
                print(f"   {tag} {pname:<12s} ${usd:9.4f}  "
                      f"{kg:8.3f} kgCO2e  slo {slo:10.2f}")
        res = max(scn["conservation_residual"].values())
        print(f"  conservation residual: {res:.2e} pods")
    print(f"# geo: {len(suite['scenarios'])} scenario(s), "
          f"{len(suite['policies'])} policies, dominance_found="
          f"{suite['dominance_found']}, max residual "
          f"{suite['max_conservation_residual']:.2e} pods",
          file=sys.stderr)
    return 0


def _cmd_scenarios(args) -> int:
    """The scenario library, with the minted scenarios of
    ``--minted-dir`` (digest-checked) after the hand-named ones."""
    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    load_minted_scenarios)

    library = dict(WORKLOAD_SCENARIOS)
    if args.minted_dir:
        try:
            library.update(load_minted_scenarios(args.minted_dir))
        except (ValueError, OSError, KeyError) as e:
            raise SystemExit(f"ccka: {e}")
    listing = []
    for name, sc in library.items():
        wl = sc.workloads
        listing.append({
            "name": name,
            "description": sc.description,
            "family_mix": sc.family_mix(),
            "fault_preset": sc.fault_preset or None,
            "minted": ({"by": sc.minted_by,
                        "params_digest": sc.params_digest}
                       if sc.minted else None),
            "inference": {
                "flash_frac": wl.inference_flash_frac,
                "flash_mult": wl.inference_flash_mult,
                "queue_max": wl.inference_queue_max,
                "slo_ms": wl.inference_slo_ms,
            },
            "batch": {
                "burst_frac": wl.batch_burst_frac,
                "burst_mult": wl.batch_burst_mult,
                "deadline_ticks": wl.batch_deadline_ticks,
            },
        })
    print(json.dumps({"scenarios": listing}, indent=2))
    return 0


def _parse_bounds(specs: list) -> dict:
    """``--bound NAME=LO:HI`` overrides -> {name: (lo, hi)}. Shape errors
    here; unknown names and out-of-box ranges are validate_bounds'."""
    out = {}
    for spec in specs:
        name, eq, rng = spec.partition("=")
        lo, colon, hi = rng.partition(":")
        if not eq or not colon or not name:
            raise ValueError(f"malformed --bound {spec!r} "
                             "(want NAME=LO:HI)")
        try:
            out[name] = (float(lo), float(hi))
        except ValueError:
            raise ValueError(f"non-numeric --bound {spec!r}")
    return out


def _cmd_scenario_search(cfg: FrameworkConfig, args) -> int:
    """`scenario-search`: the CEM adversarial search on ``--device``; prints
    (and with ``--mint-out`` writes) the minted scenario document. Unknown
    policy, objective, intensity and knob names are refused before the
    device is touched."""
    from ccka_tpu_torch.obs.runlog import RunLog
    from ccka_tpu_torch.search.adversarial import (SEARCH_POLICIES,
                                                   intensity_bounds,
                                                   resolve_objective,
                                                   search_scenarios)
    from ccka_tpu_torch.search.params import validate_bounds

    try:
        if args.policy not in SEARCH_POLICIES:
            raise ValueError(f"unknown search policy {args.policy!r}; "
                             f"artifact-free policies: "
                             f"{list(SEARCH_POLICIES)}")
        resolve_objective(args.objective)
        intensity_bounds(args.intensity or None)
        bounds = _parse_bounds(args.bound)
        validate_bounds(bounds)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    dev = _device(args.device)
    runlog = RunLog(args.runlog or None, kind="scenario-search",
                    echo=lambda s: None,
                    meta={"policy": args.policy,
                          "objective": args.objective})
    try:
        result = search_scenarios(
            cfg, policy=args.policy, objective=args.objective,
            iters=args.iters, pop=args.pop, elite_frac=args.elite_frac,
            seed=args.seed, bounds=bounds or None,
            intensity=args.intensity or None,
            mint_name=args.name or None, runlog=runlog, device=dev)
    except ValueError as e:
        runlog.close(status="error")
        raise SystemExit(f"ccka: {e}")
    runlog.close()
    doc = result.to_doc()
    if args.mint_out:
        with open(args.mint_out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
        print(f"# minted {result.scenario.name!r} -> {args.mint_out}",
              file=sys.stderr)
    print(json.dumps(doc, indent=2))
    print(f"# worst case: {result.objective}="
          f"{result.best_value:.6g} ({'DOMINATES' if result.dominates else 'does not dominate'} "
          f"the hand-named library) after {result.evals} cells",
          file=sys.stderr)
    return 0


def _cmd_flywheel(cfg: FrameworkConfig, args) -> int:
    """`flywheel`: the continual-learning loop's operator surface.
    Unknown intensity and teacher names are refused before any ledger
    read or device work; promote applies only a recorded gate decision
    and refuses without one. Only distill touches ``--device``."""
    import os

    from ccka_tpu_torch.config import FAULT_PRESETS
    from ccka_tpu_torch.obs.runlog import RunLog
    from ccka_tpu_torch.train.factory import FACTORY_TEACHERS
    from ccka_tpu_torch.train.flywheel import Flywheel, promotion_gates

    intensities = _names(args.intensities)
    try:
        bad = [i for i in intensities
               if i != "off" and i not in FAULT_PRESETS]
        if bad or not intensities:
            raise ValueError(
                f"unknown fault intensities {bad or '<empty>'}; have "
                f"{sorted(set(FAULT_PRESETS) | {'off'})}")
        if args.teacher not in FACTORY_TEACHERS:
            raise ValueError(f"unknown teacher {args.teacher!r}; "
                             f"teachers: {sorted(FACTORY_TEACHERS)}")
        device = (_device(args.device) if args.action == "distill"
                  else args.device)
        fw = Flywheel(cfg, args.root, teacher=args.teacher,
                      steps=args.steps, pairs_base=args.pairs_base,
                      pairs_max=args.pairs_max, iterations=args.iters,
                      seed=args.seed, minted_dir=args.minted_dir,
                      device=device)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")

    if args.action == "status":
        print(json.dumps(fw.status(), indent=2, default=str))
        return 0

    runlog = RunLog(args.runlog or None, kind="flywheel",
                    echo=lambda s: None,
                    meta={"action": args.action, "root": args.root})
    fw.runlog = runlog
    try:
        if args.action == "mine":
            cells = fw.mine(decisions_path=args.decisions,
                            tournament_path=args.tournament,
                            incidents_path=args.incidents,
                            intensities=intensities, top_k=args.top_k)
            print(json.dumps([{
                "scenario": c.scenario, "intensity": c.intensity,
                "workload_class": c.workload_class,
                "tenant_regime": c.tenant_regime, "score": c.score,
                "evidence": c.evidence} for c in cells], indent=2))
        elif args.action == "distill":
            from ccka_tpu_torch.train.checkpoint import load_params_npz
            cells = fw.mine(decisions_path=args.decisions,
                            tournament_path=args.tournament,
                            incidents_path=args.incidents,
                            intensities=intensities, top_k=args.top_k)
            rep = fw.distill(cells, generation=args.generation)
            params, _meta = load_params_npz(rep["checkpoint"])
            eval_rows = fw.evaluate(params, rep["produced"])
            decision = promotion_gates(
                eval_rows, provenance=rep["provenance"])
            dec_path = os.path.join(fw.gen_dir(args.generation),
                                    "decision.json")
            with open(dec_path, "w", encoding="utf-8") as fh:
                json.dump({"decision": decision, "eval": eval_rows},
                          fh, indent=1, sort_keys=True)
            print(json.dumps({
                "generation": args.generation,
                "checkpoint": rep["checkpoint"],
                "checkpoint_digest": rep["checkpoint_digest"],
                "curriculum": rep["curriculum"],
                "eval": eval_rows, "decision": decision,
                "decision_path": dec_path}, indent=2))
        elif args.action == "promote":
            dec_path = args.decision or os.path.join(
                fw.gen_dir(args.generation), "decision.json")
            if not os.path.exists(dec_path):
                raise ValueError(
                    f"no gate decision at {dec_path!r} — run `ccka "
                    "flywheel distill` (or the FlywheelRunner) first; "
                    "a promotion without recorded gate evidence is "
                    "refused")
            with open(dec_path, encoding="utf-8") as fh:
                decision = json.load(fh)["decision"]
            live = fw.promote(args.generation, decision)
            print(json.dumps(live, indent=2, default=str))
    except ValueError as e:
        runlog.close(status="error")
        raise SystemExit(f"ccka: {e}")
    runlog.close()
    return 0


def _cmd_report(args) -> int:
    from ccka_tpu_torch.harness.telemetry import (read_telemetry,
                                                  summarize_telemetry)
    try:
        records = read_telemetry(args.telemetry)
    except OSError as e:
        raise SystemExit(f"ccka: cannot read telemetry: {e}")
    except json.JSONDecodeError as e:
        # e.g. a partial line from a controller killed mid-write
        raise SystemExit(f"ccka: corrupt telemetry line in "
                         f"{args.telemetry}: {e}")
    print(json.dumps(summarize_telemetry(records), indent=2))
    return 0


def _cmd_obs(args) -> int:
    from ccka_tpu_torch.obs.runlog import read_runlog, summarize_runlog
    try:
        # Non-strict: a live run's last line may be mid-write, a counted
        # torn tail (interior corruption still raises).
        records, stats = read_runlog(args.path, with_stats=True)
    except OSError as e:
        raise SystemExit(f"ccka: cannot read run log: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"ccka: corrupt run log {args.path}: {e}")
    if stats["torn_tail"]:
        print("# note: final line torn (crash or live writer mid-write) "
              "— showing the intact prefix", file=sys.stderr)
    if args.action == "tail":
        for rec in records[-max(args.lines, 1):]:
            print(json.dumps(rec, sort_keys=True))
        return 0
    print(json.dumps(summarize_runlog(records), indent=2))
    return 0


def _service_obs(args):
    """The obs posture ``fleet --service`` runs under (None: the
    config's), with the output flags folded in."""
    import dataclasses
    import os

    from ccka_tpu_torch.config import OBS_PRESETS

    if not (args.obs or args.incidents_out or args.decisions_out):
        return None
    preset = args.obs or "default"
    if preset not in OBS_PRESETS:
        raise SystemExit(f"ccka: unknown obs preset {preset!r}; "
                         f"presets: {sorted(OBS_PRESETS)}")
    obs = OBS_PRESETS[preset]
    if (args.incidents_out or args.decisions_out) and args.obs \
            and not obs.enabled:
        # An explicit off posture must not be silently inverted by the
        # output flags.
        raise SystemExit(
            f"ccka: --obs {args.obs} is the off posture but "
            "--incidents-out/--decisions-out need the obs layer running "
            "— drop one")
    if args.incidents_out:
        out_dir = os.path.dirname(os.path.abspath(args.incidents_out)) \
            or "."
        obs = dataclasses.replace(
            obs, enabled=True, incident_log_path=args.incidents_out,
            dump_dir=os.path.join(out_dir, "recorder-dumps"))
    if args.decisions_out:
        obs = dataclasses.replace(obs, enabled=True,
                                  decision_log_path=args.decisions_out)
    return obs


def _run_service(cfg: FrameworkConfig, args, backend, dev):
    """`fleet --service`: prints the service summary and returns None
    (an enabled posture), or returns the delegated FleetTickReports and
    the controller they ran on (the off gate)."""
    from ccka_tpu_torch.config import SERVICE_PRESETS
    from ccka_tpu_torch.harness.service import (fleet_service_from_config,
                                                resolve_profiles)

    if args.service not in SERVICE_PRESETS:
        raise SystemExit(f"ccka: unknown service preset {args.service!r}; "
                         f"presets: {sorted(SERVICE_PRESETS)}")
    names = list(_names(args.profiles))
    if not names:
        raise SystemExit("ccka: --profiles needs at least one tenant "
                         "profile name")
    try:
        resolve_profiles(names)
    except ValueError as e:
        raise SystemExit(f"ccka: {e}")
    profiles = [names[i % len(names)] for i in range(args.clusters)]
    obs = _service_obs(args)
    try:
        service = fleet_service_from_config(
            cfg, backend, args.clusters, profiles=profiles,
            service=SERVICE_PRESETS[args.service], obs=obs,
            horizon_ticks=max(args.ticks + 2, 8), seed=args.seed,
            log_fn=lambda s: print(s, file=sys.stderr), device=dev)
    except ValueError as e:  # e.g. corrupt incident log
        raise SystemExit(f"ccka: {e}")
    service.warmup()
    sreports = service.run(args.ticks)
    if not SERVICE_PRESETS[args.service].enabled:
        # The off gate delegates: the bare-fleet summary over the
        # delegated FleetTickReports.
        return sreports, service.ctrl
    last = sreports[-1]
    summary = {
        "clusters": args.clusters,
        "ticks": args.ticks,
        "service": args.service,
        "admitted_frac": sum(r.admitted for r in sreports)
        / (args.clusters * len(sreports)),
        "sheds_total": last.sheds_total,
        "deferrals_total": last.deferrals_total,
        "breaker_transitions_total": last.breaker_transitions_total,
        "tick_latency_ms_last": last.tick_latency_ms,
        "fleet_cost_usd_hr_last": last.cost_usd_hr,
    }
    if service.incidents is not None:
        summary["incidents_total"] = service.incidents.total
        summary["incident_counts"] = service.incidents.counts()
        summary["recorder_dumps_total"] = service.recorder.dumps_total
        summary["slo_burn_rate_last"] = last.slo_burn_rate
    if service.decisions is not None:
        summary["decision_rows_total"] = service.decisions.rows_total
        summary["policy_divergence_rate_last"] = \
            last.policy_divergence_rate
    service.close()
    print(json.dumps(summary, indent=2))
    return None


def _cmd_fleet(cfg: FrameworkConfig, args) -> int:
    """`fleet`: the bare fleet loop, or with ``--service`` the
    multi-tenant service layer over it."""
    from ccka_tpu_torch.harness.fleet import fleet_controller_from_config

    if args.clusters < 1 or args.ticks < 1:
        raise SystemExit("ccka: fleet needs --clusters >= 1 and "
                         "--ticks >= 1")
    if (args.obs or args.incidents_out or args.decisions_out) \
            and (not args.service or args.service == "off"):
        # The obs layer rides the service loop; letting these flags
        # silently no-op would leave the operator believing incidents
        # were being recorded.
        raise SystemExit(
            "ccka: --obs/--incidents-out/--decisions-out need an ENABLED "
            "--service posture (the obs layer rides the service loop; "
            "'off' delegates to the bare fleet)")
    dev = _device(args.device)
    backend = make_backend(cfg, args.backend, args.checkpoint, device=dev)
    if args.service:
        delegated = _run_service(cfg, args, backend, dev)
        if delegated is None:
            return 0
        reports, ctrl = delegated
    else:
        ctrl = fleet_controller_from_config(
            cfg, backend, args.clusters,
            horizon_ticks=max(args.ticks + 2, 8), seed=args.seed,
            log_fn=lambda s: print(s, file=sys.stderr), device=dev)
        reports = ctrl.run(args.ticks)
    ctrl.close()
    ok = all(r.applied == r.n_clusters for r in reports)
    n = args.clusters * max(len(reports), 1)
    print(json.dumps({
        "clusters": args.clusters,
        "ticks": args.ticks,
        "applied_frac": sum(r.applied for r in reports) / n,
        "slo_ok_frac": sum(r.slo_ok for r in reports) / n,
        "fleet_cost_usd_hr_last": reports[-1].cost_usd_hr,
        "decide_ms_mean": round(sum(r.decide_ms for r in reports)
                                / len(reports), 2),
        "fanout_ms_mean": round(sum(r.fanout_ms for r in reports)
                                / len(reports), 2),
    }, indent=2))
    return 0 if ok else 1


def _cmd_incidents(cfg: FrameworkConfig, args) -> int:
    """`incidents list|show|timeline` — the incident JSONL plus (for
    show) the checksum-verified recorder dump and (for timeline) the
    causal join against RunLog records and trace spans."""
    from ccka_tpu_torch.obs.incidents import (attach_dump_entries,
                                              build_timeline, read_incidents)

    try:
        incidents = read_incidents(args.path)
    except OSError as e:
        raise SystemExit(f"ccka: cannot read incidents: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"ccka: corrupt incident log {args.path}: {e}")
    if args.action == "list":
        for rec in incidents:
            print(json.dumps(rec, sort_keys=True))
        counts: dict = {}
        for rec in incidents:
            counts[rec.get("trigger", "?")] = \
                counts.get(rec.get("trigger", "?"), 0) + 1
        print(f"# {len(incidents)} incident(s): "
              + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())),
              file=sys.stderr)
        return 0
    by_id = {int(rec.get("id", 0)): rec for rec in incidents}
    if args.action == "show":
        if not args.id:
            raise SystemExit("ccka: incidents show needs --id N "
                             "(see `ccka incidents list`)")
        rec = by_id.get(args.id)
        if rec is None:
            raise SystemExit(f"ccka: no incident with id {args.id} in "
                             f"{args.path}")
        from ccka_tpu_torch.harness.snapshot import SnapshotError
        try:
            print(json.dumps(attach_dump_entries(rec), indent=2))
        except SnapshotError as e:
            raise SystemExit(f"ccka: recorder dump failed verification "
                             f"— refusing to render it: {e}")
        return 0
    # timeline
    runlog = spans = ()
    if args.runlog:
        from ccka_tpu_torch.obs.runlog import read_runlog
        try:
            runlog = read_runlog(args.runlog)
        except OSError as e:
            raise SystemExit(f"ccka: cannot read run log: {e}")
        except json.JSONDecodeError as e:
            raise SystemExit(f"ccka: corrupt run log {args.runlog}: {e}")
    if args.trace:
        try:
            with open(args.trace, encoding="utf-8") as fh:
                spans = [json.loads(line) for line in fh if line.strip()]
        except OSError as e:
            raise SystemExit(f"ccka: cannot read span JSONL: {e}")
        except json.JSONDecodeError as e:
            raise SystemExit(f"ccka: corrupt span JSONL {args.trace}: "
                             f"{e}")
    around = None
    if args.id:
        rec = by_id.get(args.id)
        if rec is None:
            raise SystemExit(f"ccka: no incident with id {args.id} in "
                             f"{args.path}")
        around = int(rec.get("t", 0))
    timeline = build_timeline(incidents, runlog=runlog, spans=spans,
                              around=around, window=args.window)
    for row in timeline:
        print(json.dumps(row, sort_keys=True))
    print(f"# {len(timeline)} timeline event(s)"
          + (f" around tick {around} ±{args.window}"
             if around is not None else ""), file=sys.stderr)
    return 0


def _cmd_decisions(cfg: FrameworkConfig, args) -> int:
    """`decisions list|show|explain` — the decision-provenance JSONL:
    compact recent rows, a tick's raw records, or the rendered "why"
    (objective-term shares + the rule shadow's counterfactual)."""
    from ccka_tpu_torch.obs.decisions import (explain_row,
                                              flat_action_names,
                                              read_decisions)

    try:
        rows = read_decisions(args.path)
    except OSError as e:
        raise SystemExit(f"ccka: cannot read decisions: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"ccka: corrupt decision log {args.path}: {e}")
    if args.action == "list":
        for rec in rows[-max(args.lines, 1):]:
            sh = rec.get("shadow", {})
            print(json.dumps({
                "t": rec.get("t"), "tenant": rec.get("tenant"),
                "lane": rec.get("lane"),
                "objective_total": rec.get("objective", {}).get("total"),
                "diverged": sh.get("diverged"),
                "div_max_abs": sh.get("div_max_abs"),
                "usd_delta": sh.get("usd_delta"),
            }, sort_keys=True))
        div = sum(1 for r in rows
                  if r.get("shadow", {}).get("diverged"))
        print(f"# {len(rows)} decision row(s), {div} diverged from "
              "the rule shadow", file=sys.stderr)
        return 0
    if args.t < 0:
        raise SystemExit(f"ccka: decisions {args.action} needs --t TICK "
                         "(see `ccka decisions list`)")
    sel = [r for r in rows if r.get("t") == args.t
           and (args.tenant < 0 or r.get("tenant") == args.tenant)]
    if not sel:
        where = (f" tenant {args.tenant}" if args.tenant >= 0 else "")
        raise SystemExit(f"ccka: no decision rows for tick "
                         f"{args.t}{where} in {args.path}")
    if args.action == "show":
        for rec in sel:
            print(json.dumps(rec, sort_keys=True))
        return 0
    names = flat_action_names(cfg.cluster)
    for rec in sel:
        print(explain_row(rec, action_names=names))
        print()
    return 0


def _cmd_tournament(cfg: FrameworkConfig, args) -> int:
    """`tournament list|board|explain` — the shadow-tournament
    observatory: the registered candidate roster, the windowed
    per-workload-class win board, or a signed promotion audit with its
    signature verified against the config's audit key."""
    from ccka_tpu_torch.obs.tournament import (CANDIDATE_BUILDERS,
                                               explain_audit, explain_board,
                                               read_tournament)

    if args.action == "list":
        for name in sorted(CANDIDATE_BUILDERS):
            _builder, desc = CANDIDATE_BUILDERS[name]
            print(f"{name}: {desc}")
        print(f"# {len(CANDIDATE_BUILDERS)} registered candidate "
              "builder(s); compose a roster with "
              "obs.tournament_roster", file=sys.stderr)
        return 0
    if not args.path:
        raise SystemExit(f"ccka: tournament {args.action} needs the "
                         "tournament JSONL path")
    try:
        rows = read_tournament(args.path)
    except OSError as e:
        raise SystemExit(f"ccka: cannot read tournament log: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"ccka: corrupt tournament log {args.path}: "
                         f"{e}")
    kind = "board" if args.action == "board" else "promotion_audit"
    sel = [r for r in rows if r.get("kind") == kind
           and (args.t < 0 or r.get("t") == args.t)]
    if not sel:
        where = f" at tick {args.t}" if args.t >= 0 else ""
        raise SystemExit(f"ccka: no {kind} rows{where} in {args.path}"
                         + ("" if kind == "board" else
                            " — no challenger has sustained a win yet"))
    if args.action == "board":
        print(explain_board(sel[-1]))
        return 0
    key = args.key or cfg.obs.tournament_audit_key
    for rec in sel if args.t >= 0 else sel[-1:]:
        print(explain_audit(rec, key))
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


def _not_ported(argv: list[str]) -> str | None:
    """The ROADMAP item of a subcommand the port has not yet, or None."""
    return NOT_PORTED.get(_command(argv))


_HANDLERS = {
    "observe": _cmd_observe, "run": _cmd_run, "simulate": _cmd_simulate,
    "evaluate": _cmd_evaluate, "train": _cmd_train,
    "forecast-eval": _cmd_forecast_eval, "chaos-eval": _cmd_board,
    "scenario-eval": _cmd_board, "recover-eval": _cmd_recover_eval,
    "overload-eval": _cmd_overload_eval,
    "distill-factory": _cmd_distill_factory, "capture": _cmd_capture,
    "dashboard": _cmd_dashboard, "pipeline": _cmd_pipeline,
    "watch": _cmd_watch, "burst": _cmd_burst, "fleet": _cmd_fleet,
    "incidents": _cmd_incidents, "decisions": _cmd_decisions,
    "tournament": _cmd_tournament, "geo": _cmd_geo,
    "scenario-search": _cmd_scenario_search, "flywheel": _cmd_flywheel,
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    item = _not_ported(argv)
    if item is not None:
        print(f"ccka_tpu_torch: subcommand {_command(argv)!r} is not "
              f"ported yet (ROADMAP {item})", file=sys.stderr)
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

    cmd = args.command
    try:
        if cmd in ("offpeak", "peak", "reset"):
            return _cmd_profile(cfg, cmd, args.live, args.json)
        if cmd in _HANDLERS:
            return _HANDLERS[cmd](cfg, args)
        if cmd == "preroll":
            from ccka_tpu_torch.harness.preroll import run_preroll
            return run_preroll(cfg, live=args.live, device=args.device)
        if cmd == "bootstrap":
            return _cmd_bootstrap(cfg, args.live, args.json)
        if cmd == "guardrails":
            from ccka_tpu_torch.actuation.guardrails import render_guardrails
            if args.json:
                print(json.dumps(render_guardrails(), indent=2))
                return 0
            return _apply_docs(render_guardrails(), args.live, "guardrails")
        if cmd == "map-nodes":
            return _cmd_map_nodes(cfg, args.account_id, args.live)
        if cmd == "cleanup":
            return _cmd_cleanup(cfg, args.live, args.wipe_nodeclass)
        if cmd == "scenarios":
            return _cmd_scenarios(args)
        if cmd == "report":
            return _cmd_report(args)
        if cmd == "obs":
            return _cmd_obs(args)
        if cmd == "show-config":
            print(cfg.to_json())
            return 0
    except ConfigError as e:
        # e.g. a replay trace that validates as a path but fails to load
        print(f"ccka: config error: {e}", file=sys.stderr)
        return 2
    raise SystemExit(f"unknown command {cmd}")
