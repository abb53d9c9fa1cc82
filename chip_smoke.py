"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Four main paths. The rule-profile fleet rollout: a batch of clusters
gets one simulated day (T = 2880 ticks of 30 s) of synthetic price, carbon
and demand signals, is stepped under the Peak/Off-Peak rule, and is
folded into one EpisodeSummary per cluster. The three-policy scoreboard:
the rule, the carbon teacher and the shipped learned flagship scored on
one packed multiregion fleet-day, paired world for world. The fault and
workload boards: the same three policies and diff-MPC (the quick
receding-horizon planner on the calm world, its plan played back by the
plan kernel) on streams widened with fault lanes (four intensities) and
workload-family lanes (four scenarios). The streaming path: the same
policies and a plan over a day synthesized block by block beside the
kernels, the rollout resumed at each block from its carried state, and a
fleet of 262144 clusters in chunks whose whole stream would not fit the
card.
Phases, in order; any failure ends the run with a nonzero exit code:

1. the card: nvidia-smi's name and power limit, device properties;
2. build every CUDA source in each lane variant with nvcc (8 processes,
   all started together), printing registers and spill, and every kernel
   function's SASS counts (`cuobjdump -sass`, `kernels/build.py::
   sass_counts`: instructions, those of the tick loop, tensor-core HMMA,
   warp shuffles SHFL, special-function MUFU, slow-path CALLs, global
   loads LDG, spill loads and stores LDL/STL); a build whose MLP kernels
   hold no HMMA fails, and so does a profile build whose
   rollout_profiles_kernel instantiations hold no SHFL (the pair of lanes
   a cluster is then absent);
3. philox_uniform_kernel against `sim/random.uniforms`, bitwise. This
   kernel is on no rollout path (the rollout kernels inline the same
   device function); its launch count is this phase's;
4. default preset B = 8192 and multiregion B = 1024, T = 360, both
   modes: the rule kernel and the carbon kernel, each against its plain
   version (deterministic: batch means within 1e-4 relative, at least
   99.9 % of clusters within 2e-3 on every field; stochastic:
   `mean_parity_violations` empty, at least 99 % of clusters within
   2e-3), with whether they are bitwise equal; then the carbon kernel
   with other constants (sharpness 40, min_weight 0.2, stickiness 0)
   against the plain version under the same constants, and that they
   change `carbon_kg`;
4b. the plan kernel (the profile kernel's PLAN instantiation) against its
   plain version (`rollout_actions`' loop under the plan): default
   B = 8192 and multiregion B = 1024, T = 360, both modes, a random
   decoded plan per cluster and one broadcast to every cluster, at phase
   4's standard; a rule-equivalent plan bitwise the rule kernel; its time
   at multiregion B = 32768 x T = 2880 on a random plan;
5. the MLP kernel against `kernel_numerics_action_fn` (the tensor cores
   add the torso's sums in another order than the plain chains; the
   kernel rounds each hidden unit to the chain's side): (a) the shipped
   multiregion flagship, B = 1024 x T = 32, deterministic, every field's
   largest per-cluster relative difference within 1e-3 (five near-zero-
   denominator fields 2e-2); (d) the same with the replay checkpoint on
   the default preset; (b) multiregion B = 8192 x T = 360, both modes,
   `mean_parity_violations(..., NEURAL_MEAN_PARITY_TOLERANCES)` empty;
   (c) two stacked members: member 0 bitwise the single run, member 1
   (weights halved) another policy;
5b. the zero gates: on "off" fault lanes, on zero-rate workload lanes and
   on both, every lane instantiation of the three kernels gives bitwise
   what the plain-stream kernel gives (both presets, B = 8192 x T = 2880,
   both modes);
5c. each lane instantiation against its plain version (the plain rollout
   with the lanes threaded through): rule, carbon and the plan (a random
   decoded plan per cluster) on the severe, flash-crowd and mixed streams,
   multiregion B = 8192 x T = 360, both modes, at phase 4's standard; the
   MLP on the same streams at B = 1024 x T = 32 per cluster (phase 5's
   standard; denials, stale ticks, shed load and deadline misses among
   the near-zero fields) and at B = 8192 x T = 360 by
   NEURAL_MEAN_PARITY_TOLERANCES;
5e. the MLP kernel's forward layer by layer (`mlp_forward`, the C entry
   `ccka_mlp_forward` running the rollout kernel's device functions):
   the observations of the plain multiregion rollout's states on the
   calm stream at ticks 0, 60, 120 and 180, B = 32768, through the
   shipped flagship; `check_mlp_forward`: each pre-activation within
   2^-16 x sum_k |w[k][j] x[k]| of the plain float32 chain, x, h1, h2 and
   u bitwise given the kernel's own input to each layer; then
   `mlp_forward_departures`: every sum within 2^-20 x sum_k |w[k][j]
   x[k]| of the chain (the kernel's near-tie window, the premise of its
   bitwise rounding) and h1, h2 and u wholly bitwise the plain end-to-end
   forward; u's largest difference; the entry's time. Its launches are
   this phase's;
6. the rule path at default B = 32768 x T = 2880, stochastic: trace
   synthesis and `megakernel_rollout_summary`, with the launch counters
   zeroed just before and read just after; then the plain version on the
   same traces, held against it (the one plain check whose horizon
   reaches the peak hours, 09:00-21:00); the pack's and the kernel's
   time, its bound and its issue floor (the tick loop's SASS
   instructions x T x the launch's warps over the card's 4 x 132 warp
   schedulers at the SM clock nvidia-smi reads under load; also in
   phases 4b, 7 and 8);
7. the three-policy path at multiregion B = 32768 x T = 2880, stochastic:
   trace synthesis, one `_pack_exo`, then the rule, carbon and neural
   `*_summary_from_packed` entries on that stream and seed, with all
   launch counters zeroed just before and read just after, before any
   plain version runs; then all three results held against their plain
   versions on the same stream; the three policies' fleet means;
   each kernel's median time of 5 launches, its bound and cluster-days/s
   (the plain versions at T = 360 on the stream's first ticks, the kernels
   re-run there);
8. the rule kernel's time across fleet sizes B = 8192 ... 65536, both
   modes, against its bound and issue floor, with the lanes a cluster,
   the warps per SM the launch gives and those an SM holds at once;
9. the boards: first the graphed planner against the eager one, bitwise
   (multiregion N = 1024 x T = 96); then `fault_scoreboard` and
   `workload_scoreboard` at multiregion B = 32768 x T = 2880, stochastic,
   rule, carbon, flagship and mpc, each with the counters (by entry and
   by instantiation) zeroed just before and read just after; the
   planner's time; the boards' fleet means; then every stream once more
   from the same seed (its rows checked equal to the board's), timed:
   synthesis, each entry, each kernel as the median of 5 (the plan kernel
   on the board's plan, made again from the same calm rows); on severe
   and mixed each policy's result
   held against its plain version at T = 360 on the stream's first ticks
   (stochastic standard; the flagship's by
   NEURAL_MEAN_PARITY_TOLERANCES);
10. carried-state streaming (the main path of the fifth slice): (a)
   every CARRY instantiation (rule, carbon, MLP, plan x the plain,
   severe, flash-crowd and mixed streams x both modes), multiregion
   B = 8192 x T = 720 in blocks of 180: bitwise the non-carry kernel on
   the concatenated stream, its day timed against it; (b) at B = 1024
   x T = 32 in blocks of 16, both modes: the carried state after every
   block bitwise its plain version's `pack_carry`; (c) the streaming
   path at multiregion B = 32768 x T = 2880, stochastic, the mixed
   stream in 8 blocks of 360, rule, carbon, flagship and a per-cluster
   plan, each through the synchronous and the double-buffered drive,
   the CARRY counters zeroed just before and read just after, both
   drives bitwise each other and the unblocked reference, the walls, the
   occupancy and the two stream buffers; a day of 8 CARRY launches timed
   against one non-carry launch; the carried state after each of the
   day's first two blocks bitwise its plain version's at B = 32768; (d)
   the cluster-chunked rule drive at
   B = 262144 (8 chunks of 32768): wall, peak memory against two blocks
   and against the whole stream, the last chunk bitwise a single-chunk
   run;
11. the training path (the main path of the eighth slice), multiregion
   with the shipped net's widths (36 -> 128 -> 128 -> 18): (a) the carbon
   teacher distilled (`collect_dataset` at B = 256 x T = 256, `imitate`
   300 iterations at minibatch 4096; both losses finite and falling);
   (b) two CEM generations on the mega engine from (a)'s params, NP = 64
   members x G = 256 traces x T = 2880, the counters zeroed just before
   and read just after: one rule, one carbon and one population launch a
   generation; generation 0's population launch held member by member
   against `population_plain_summary` (the batched
   `kernel_numerics_action_fn`) at T = 720 by
   NEURAL_MEAN_PARITY_TOLERANCES, its rule and carbon bars at phase 4's
   stochastic standard; the generation's stages timed alone (synthesis,
   the three launches, the host's rest) and the population launch's
   bound; (c) three PPO iterations at B = 256 x T = 64, diagnostics
   finite, seconds each; (d) one `produce_cell` at its defaults (64 pairs
   x 96 ticks in blocks of 48, diurnal-inference under moderate faults):
   its CARRY playback and rule column bitwise
   `unblocked_reference_summary`, its pairs/s against
   `naive_lax_pair_rate`, one pair timed on its first 4 of 12 plan
   segments (32 ticks; each segment plans the same horizon of 32 at the
   same iterations, so a 96-tick pair takes 3 times as long); a
   selection evaluation timed (5 x 2880 eager ticks); (e)
   `train_flagship` through `main` (distill:carbon, cem on the mega engine, 2 generations, selection on
   5 x 2880) with the counters around it, the npz loaded back and its
   digest checked;
12. one JSON line listing every kernel and lane instantiation, the
   card's line, and the result.


Cut for time (the plain version's eager tick and the planner of the mpc
rows set most of the run): phases 7 and 9 hold their kernels against
the plain versions on the full-size streams' first ticks (they held all
2880 ticks before); phases 4-5c, 7 and 9 hold them over 360 ticks from
midnight (720 before; neither reaches the peak hours, which phase 6's
full day covers); phase 11d times the naive pair on a third of its
segments.

The bound of a call is the larger of its bytes (each input row the kernel
reads, once, its weights, the plan rows it reads and its output) over
HBM's rate and its
operations over the card's peak rate for their type: the float operations
of the plain version's tick, counted by dispatch, at the float32 rate for
multiplies and adds that are not fused; for the MLP kernel also the
torso's products at the dense bf16 tensor-core rate and the head's at the
float32 rate. Operations of one execution unit add up (the tick and the
head both need the float32 pipes); the tensor cores, the float32 pipes
and HBM work side by side, so the slowest of them sets the bound. The
terms, each unit's sum and the unit that sets the bound are printed
beside it.

It needs no network and runs no JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense, no sparsity). The 67 TFLOP/s float32
# rate counts a fused multiply-add as two operations; the kernels are built
# with -fmad=false, so each multiply and add of the tick issues alone, at
# half of it.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_UNFUSED_OPS_PER_S = F32_OPS_PER_S / 2
BF16_TENSOR_OPS_PER_S = 989e12

T_DAY = 2880
T_SHORT = 32
# The depth of the plain versions held from midnight in phases 4-5c, 7
# and 9 (the plain version's eager tick sets their time).
T_PARITY = 360
T_BLOCKED = 720  # phase 10a's blocked day (4 blocks of 180)
T_POP = 720      # phase 11b's population held member by member
B_PARITY = 8192
B_MULTI = 1024
B_MAIN = 32768
SWEEP = (8192, 16384, 32768, 65536)
N_TIMED = 5
OUT_ROWS = 24
CARBON_OTHER = dict(sharpness=40.0, min_weight=0.2, stickiness=0.0)
# tests/test_megakernel.py::test_short_horizon_exact's standard.
SHORT_TOL, SHORT_LOOSE_TOL = 1e-3, 2e-2
SHORT_LOOSE = ("evictions", "queue_depth_mean", "interruptions",
               "spot_exposure", "waste_frac")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, n: int = 1) -> list[float]:
    """Times of ``n`` calls of ``fn`` on the current stream (CUDA events)."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn) -> float:
    """Median of N_TIMED calls of ``fn``, after a warm-up."""
    cuda_ms(fn, 1)
    return float(np.median(cuda_ms(fn, N_TIMED)))


def field_rel(a, b) -> dict:
    """Every field's largest per-cluster relative difference,
    ``|a - b| / (|b| + 1e-6)``; fails on a non-finite value."""
    out = {}
    for f in a._fields:
        x = getattr(a, f).double()
        y = getattr(b, f).double()
        if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
            fail(f"non-finite values in field {f}")
        out[f] = float(((x - y).abs() / (y.abs() + 1e-6)).max())
    return out


def per_cluster_share(a, b, tol: float = 2e-3):
    """Share of clusters whose every field agrees within ``tol`` relative,
    the worst field, and the largest absolute difference."""
    ok = None
    max_abs = 0.0
    for f in a._fields:
        x = getattr(a, f).double()
        y = getattr(b, f).double()
        good = (x - y).abs() / (y.abs() + 1e-6) <= tol
        ok = good if ok is None else ok & good
        max_abs = max(max_abs, float((x - y).abs().max()))
    rel = field_rel(a, b)
    worst = max(rel, key=rel.get)
    return float(ok.double().mean()), worst, rel[worst], max_abs


def bitwise(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


def mean_rel(a, b) -> dict:
    out = {}
    for f in a._fields:
        x = getattr(a, f).double().mean().item()
        y = getattr(b, f).double().mean().item()
        out[f] = abs(x - y) / (abs(y) + 1e-9)
    return out


def bound(nbytes: float, op_terms: dict) -> tuple[float, str, dict]:
    """(least time in ms, "bytes" or "operations", every term in ms) for a
    call that moves ``nbytes`` and does ``op_terms``: name -> (operations,
    the card's rate for their type, the unit that executes them). Terms of
    one unit add up; the units (HBM, the float32 pipes, the tensor cores)
    run side by side, so the bound is the slowest unit's time. The dict
    also gives each unit's sum under ``unit:<name>`` and the unit that
    sets the bound under ``set_by``."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    units: dict = {}
    for name, (ops, rate, unit) in op_terms.items():
        terms[name] = ops / rate * 1e3
        units[unit] = units.get(unit, 0.0) + terms[name]
    slowest = max(units, key=units.get)
    by_bytes = terms["bytes"] >= units[slowest]
    terms.update({f"unit:{u}": ms for u, ms in units.items()})
    terms["set_by"] = "hbm" if by_bytes else slowest
    return (max(terms["bytes"], units[slowest]),
            "bytes" if by_bytes else "operations", terms)


def rollout_bytes(Z: int, B: int, T: int, weight_bytes: int = 0,
                  faults: bool = False, workloads: bool = False,
                  plan_rows: int = 0) -> int:
    """Bytes a rollout kernel must move: the stream rows it reads (spot,
    od, carbon per zone, two demands, is_peak; with faults the Z+3 fault
    rows, with workloads the 3 arrival rows; not the padding rows) once
    per tick, a per-cluster plan's used rows, its weights, and its
    [24, B] output."""
    rows = (3 * Z + 3 + (Z + 3 if faults else 0) + (3 if workloads else 0)
            + plan_rows)
    return (rows * T + OUT_ROWS) * B * 4 + weight_bytes


# rollout_profiles_kernel's layout (csrc/rollout_profiles.cu: kGroup lanes
# a cluster, kBlock threads a block); four warp schedulers an SM.
PAIR, PROFILE_BLOCK, SCHEDULERS_PER_SM = 2, 64, 4
_POLICY_NAMES = ("rule", "carbon", "plan")


def profile_key(name: str) -> tuple | None:
    """(policy, Z, stochastic, faults, wl_depth, carry) of a
    rollout_profiles_kernel function name, mangled or demangled."""
    m = re.search(r"rollout_profiles_kernel<2, (\d+), 3, (true|false), "
                  r"(\d+), (true|false), (\d+), (true|false)>", name)
    if m:
        z, st, pol, fa, wl, ca = m.groups()
        flags = [v == "true" for v in (st, fa, ca)]
    else:
        m = re.search(r"rollout_profiles_kernelILi2ELi(\d+)ELi3ELb(\d)ELi"
                      r"(\d+)ELb(\d)ELi(\d+)ELb(\d)E", name)
        if not m:
            return None
        z, st, pol, fa, wl, ca = m.groups()
        flags = [v == "1" for v in (st, fa, ca)]
    return (_POLICY_NAMES[int(pol)], int(z), flags[0], flags[1], int(wl),
            flags[2])


class ProfileBuilds:
    """What phase 2 reads off every rollout_profiles_kernel instantiation,
    keyed by profile_key: its tick loop's SASS instructions (``loop``) and
    its registers (``regs``, ptxas); and the SM clock nvidia-smi reads
    under load, read once."""

    def __init__(self):
        self.loop: dict = {}
        self.regs: dict = {}
        self.clock_mhz: float | None = None

    def sm_clock_mhz(self, fn) -> float:
        """The SM clock while 40 launches of ``fn`` run (the first
        reading is kept for the whole run)."""
        if self.clock_mhz is None:
            for _ in range(40):
                fn()
            self.clock_mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True, timeout=60).stdout.split()[0])
            torch.cuda.synchronize()
            log(f"# SM clock under load: {self.clock_mhz:.0f} MHz")
        return self.clock_mhz

    def issue_floor_ms(self, key: tuple, B: int, T: int, fn) -> float:
        """The least time the warp schedulers take to issue the profile
        kernel's tick loop for B clusters x T ticks, one instruction a
        cycle each: the loop's SASS instructions x T x the launch's warps
        (PAIR lanes a cluster) over the card's schedulers at the SM clock
        read while ``fn`` runs. A pair issues each cluster's shared work
        twice, so this says how far the layout is from what its
        instruction stream allows."""
        warps = math.ceil(PAIR * B / 32)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return (self.loop[key] * T * warps
                / (SCHEDULERS_PER_SM * sms * self.sm_clock_mhz(fn) * 1e6)
                * 1e3)

    def resident_warps_per_sm(self, key: tuple, B: int) -> float:
        """Warps of a B-cluster launch an SM holds at once: the launch's
        warps per SM, capped by what the instantiation's registers
        (allocated in units of 8) leave room for."""
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        regs = -(-self.regs[key] // 8) * 8
        blocks = min(32, 65536 // (regs * PROFILE_BLOCK))
        return min(math.ceil(PAIR * B / 32) / sms,
                   blocks * PROFILE_BLOCK / 32)


def float_ops_per_cluster_tick(cfg, stochastic: bool, policy: str = "rule",
                               net_params=None, faults: bool = False,
                               workloads: bool = False) -> int:
    """Floating-point pointwise operations of one tick of the plain step
    for one cluster under ``policy`` (with its uniforms' conversion in
    stochastic mode; with ``faults`` the fault branch and the held
    observation, with ``workloads`` the D = 16 queues), counted by
    dispatching it on the CPU. The MLP's chained products (`addcmul`) are
    left out: the bound counts them from the layer widths."""
    from ccka_tpu_torch.faults.types import FaultStep
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.dynamics import ExoStep, step
    from ccka_tpu_torch.sim.random import uniforms
    from ccka_tpu_torch.sim.rollout import initial_state, observed_exo
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.workloads.types import WorkloadState, WorkloadStep

    params = SimParams.from_config(cfg, device="cpu")
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    tr = src.batch_trace(1, [0], device="cpu")
    exo = ExoStep(*(x[:, 0] for x in tr))
    state = initial_state(cfg, 1, device="cpu")
    P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
    action_fn = {
        "rule": lambda: RulePolicy(cfg.cluster, device="cpu").action_fn(),
        "carbon": lambda: CarbonAwarePolicy(cfg.cluster,
                                            device="cpu").action_fn(),
        "mlp": lambda: mk.kernel_numerics_action_fn(net_params, cfg.cluster,
                                                    params),
        # A plan's action is loaded, not computed.
        "plan": lambda: (lambda s, e, t, a=RulePolicy(
            cfg.cluster, device="cpu").off: a),
    }[policy]()
    one = torch.ones((1,))
    fault = (FaultStep(torch.full((1, Z), 2.0), 0.5 * one, 0.5 * one, one)
             if faults else None)
    lanes = (dict(workload=WorkloadStep(one, one, one),
                  wl_state=WorkloadState.zero(16, 1, "cpu"))
             if workloads else {})
    def one_tick():
        u3 = (uniforms(0, torch.zeros((1, 1), dtype=torch.int64), 0,
                       torch.arange(P * Z)[None, :]).reshape(3, 1, P, Z)
              if stochastic else None)
        obs = (observed_exo(exo, exo, fault.signal_stale)
               if faults and policy in ("carbon", "mlp") else exo)
        action = action_fn(state, obs, 0)
        step(params, state, action, exo, u3, stochastic=stochastic,
             fault=fault, **lanes)

    return pointwise_ops(one_tick)


def pointwise_ops(fn) -> int:
    """Elements written by the floating-point pointwise operations that
    ``fn()`` dispatches (on the CPU), the chained products' `addcmul`s
    left out: a bound counts those from the layer widths."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (torch.Tag.pointwise in func.tags
                    and isinstance(out, torch.Tensor)
                    and out.dtype.is_floating_point
                    and func is not torch.ops.aten.addcmul.default):
                Count.n += out.numel()
            return out

    with Count():
        fn()
    return Count.n


# ---- the fault- and workload-widened paths (phases 5b, 5c, 9)

LANE_SEED = 5
BOARD_SEED, BOARD_TRACE_SEED = 31, 97
POLICIES = ("rule", "carbon", "mlp")
# The boards' rows and their kernels: "plan" is the mpc row's.
BOARD_POLICIES = POLICIES + ("plan",)
BOARD_ROW = {"rule": "rule", "carbon": "carbon", "mlp": "flagship",
             "plan": "mpc"}
PLAN_REPLACES = "ccka_tpu/sim/megakernel.py:1657"
PLAN_SEED = 79
FAULT_LEVELS = ("off", "mild", "moderate", "severe")
SCENARIOS = ("diurnal-inference", "flash-crowd", "batch-backfill", "mixed")
# The TPU kernel's lines of each branch (ccka_tpu/sim/megakernel.py).
REPLACES = {"FAULTS": "ccka_tpu/sim/megakernel.py:400",
            "WL_D=16": "ccka_tpu/sim/megakernel.py:780"}


def lane_source(cfg, name: str):
    """(source, its WorkloadsConfig or None) of a fault intensity or a
    workload scenario."""
    from ccka_tpu_torch.config import FAULT_PRESETS
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    scenario_source)

    if name in WORKLOAD_SCENARIOS:
        sc = WORKLOAD_SCENARIOS[name]
        return scenario_source(cfg, sc), sc.workloads
    return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals,
                                 faults=FAULT_PRESETS[name]), None


def lane_params(cfg, workloads, dev):
    """SimParams of ``cfg`` under a scenario's WorkloadsConfig."""
    import dataclasses

    from ccka_tpu_torch.sim.types import SimParams

    if workloads is not None:
        cfg = dataclasses.replace(cfg, workloads=workloads)
    return SimParams.from_config(cfg, device=dev)


def random_plan(cfg, B: int, T: int, T_pad: int, dev, seed=PLAN_SEED):
    """A per-cluster plan [T_pad, plan_rows, B]: latents 0.3 * N(0, 1),
    decoded by the codec, packed."""
    from ccka_tpu_torch.models.nets import latent_dim, latent_to_action
    from ccka_tpu_torch.sim import megakernel as mk

    lat = 0.3 * torch.randn((B, T, latent_dim(cfg.cluster)), device=dev,
                            generator=torch.Generator(
                                device=dev).manual_seed(seed))
    return mk.pack_plan(latent_to_action(lat, cfg.cluster), T_pad)


def run_entry(policy, cfg, params, net, stream, T, stochastic,
              seed=LANE_SEED, plan=None):
    """The packed entry of ``policy`` (the kernel on a CUDA stream);
    "plan" plays ``plan`` back."""
    from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
    from ccka_tpu_torch.sim import megakernel as mk

    dev = stream.device
    off, peak = offpeak_action(cfg.cluster, dev), peak_action(cfg.cluster,
                                                              dev)
    kw = dict(seed=seed, stochastic=stochastic)
    if policy == "plan":
        return mk.plan_megakernel_summary_from_packed(
            params, cfg.cluster, plan, stream, T, **kw)
    if policy == "rule":
        return mk.megakernel_summary_from_packed(params, off, peak, stream,
                                                 T, **kw)
    if policy == "carbon":
        return mk.carbon_megakernel_summary_from_packed(
            params, off, peak, stream, T, **kw)
    return mk.neural_megakernel_summary_from_packed(params, cfg.cluster, net,
                                                    stream, T, **kw)


def lane_plain(policy, cfg, params, net, stream, T, stochastic,
               seed=LANE_SEED, plan=None):
    """The plain version on the card: `batched_rollout_summary` under the
    policy's action function (for "plan", tick t's row of ``plan``), the
    stream's lanes threaded through."""
    from ccka_tpu_torch.faults.process import unpack_fault_lanes
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.lanes import resolve_layout
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            initial_state)
    from ccka_tpu_torch.workloads.process import unpack_workload_lanes

    dev = stream.device
    Z = cfg.cluster.n_zones
    layout = resolve_layout(stream.shape[1], Z)
    action_fn = {
        "rule": lambda: RulePolicy(cfg.cluster, dev).action_fn(),
        "carbon": lambda: CarbonAwarePolicy(cfg.cluster,
                                            device=dev).action_fn(),
        "mlp": lambda: mk.kernel_numerics_action_fn(net, cfg.cluster,
                                                    params),
        "plan": lambda: mk.plan_action_fn(
            mk.unpack_plan(plan, T, cfg.cluster.n_pools, Z),
            plan.dim() == 3)}[policy]()
    return batched_rollout_summary(
        params, initial_state(cfg, stream.shape[2], dev), action_fn,
        mk.unpack_exo(stream, T, Z), seed, stochastic=stochastic,
        faults=(unpack_fault_lanes(stream, T, Z) if layout.has("faults")
                else None),
        workloads=(unpack_workload_lanes(stream, T, Z)
                   if layout.has("workloads") else None))[1]


def instantiation_name(policy: str, name: str) -> str:
    """The kernel instantiation a policy runs on a lane stream."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    sc = WORKLOAD_SCENARIOS.get(name)
    faults = sc is None or bool(sc.fault_preset)
    suffix = build.instantiation(policy, faults,
                                 16 if sc is not None else 0)
    return ("rollout_mlp_kernel" if policy == "mlp"
            else "rollout_profiles_kernel") + suffix


def lane_phases(dev, setup, hold) -> dict:
    """5b: the zero gates: on "off" fault lanes and on zero-rate workload
    lanes every lane instantiation gives, bitwise, what the plain-stream
    kernel gives (both presets, both modes). 5c: each lane instantiation
    against its plain version: rule, carbon and a random per-cluster plan
    on severe, flash-crowd and mixed (multiregion B = 8192 x T = 360, both
    modes); the MLP on the
    same streams per cluster at B = 1024 x T = 32 and by
    NEURAL_MEAN_PARITY_TOLERANCES at B = 8192 x T = 360, deterministic.
    Returns {instantiation: parity record}."""
    from ccka_tpu_torch.config import FAULT_PRESETS, WorkloadsConfig
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk

    zero = WorkloadsConfig(enabled=True, inference_rate_pods=0.0,
                           batch_rate_pods=0.0, background_rate_pods=0.0)
    for preset, variant in (("default", "replay"), ("multiregion", "")):
        cfg, _, params, _, _, net = setup(preset, variant)

        def stream(**kw):
            return SyntheticSignalSource(
                cfg.cluster, cfg.workload, cfg.sim, cfg.signals, **kw
            ).packed_trace_device(T_DAY, 61, B_PARITY, device=dev)

        base = stream()
        widened = {"off faults": stream(faults=FAULT_PRESETS["off"]),
                   "zero-rate workloads": stream(workloads=zero),
                   "both": stream(faults=FAULT_PRESETS["off"],
                                  workloads=zero)}
        n = 0
        for policy in POLICIES:
            for st in (False, True):
                want = run_entry(policy, cfg, params, net, base, T_DAY, st)
                for name, s in widened.items():
                    got = run_entry(policy, cfg, params, net, s, T_DAY, st)
                    torch.cuda.synchronize()
                    n += 1
                    if not bitwise(got, want):
                        fail(f"zero gate: {policy} on {name} ({preset}, "
                             f"stochastic={st}) is not bitwise the "
                             f"plain-stream kernel")
        log(f"# zero gates {preset} B={B_PARITY} T={T_DAY}: {n} lane runs "
            f"(rule, carbon, mlp x off faults, zero-rate workloads, both x "
            f"two modes), every one bitwise the plain-stream kernel")
        del base, widened
        torch.cuda.empty_cache()

    found: dict = {}
    cfg, _, _, _, _, net = setup("multiregion")
    plan = random_plan(cfg, B_PARITY, T_PARITY, T_PARITY, dev)
    for name in ("severe", "flash-crowd", "mixed"):
        source, wl = lane_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        stream = source.packed_trace_device(T_PARITY, 67, B_PARITY,
                                            device=dev)
        for policy in ("rule", "carbon", "plan"):
            label = instantiation_name(policy, name)
            for st in (False, True):
                k = run_entry(policy, cfg, params, net, stream, T_PARITY, st,
                              plan=plan)
                t0 = time.perf_counter()
                p = lane_plain(policy, cfg, params, net, stream, T_PARITY, st,
                               plan=plan)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                same, max_abs = hold(
                    f"{label} {name} multiregion B={B_PARITY} T={T_PARITY} "
                    f"{'stochastic' if st else 'deterministic'}", k, p, st)
                rec = found.setdefault(label, {"bitwise": True,
                                               "max_abs_err": 0.0})
                rec["bitwise"] &= same
                rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
                rec["plain_ms"] = plain_s * 1e3
                rec["shape"] = (f"{name} multiregion B={B_PARITY} "
                                f"T={T_PARITY} "
                                f"{'stochastic' if st else 'deterministic'}")
        label = instantiation_name("mlp", name)
        short = source.packed_trace_device(T_SHORT, 71, B_MULTI, device=dev)
        k = run_entry("mlp", cfg, params, net, short, T_SHORT, False)
        p = lane_plain("mlp", cfg, params, net, short, T_SHORT, False)
        rel = field_rel(k, p)
        loose = SHORT_LOOSE + ("denials", "stale_ticks", "inf_dropped",
                               "batch_deadline_misses")
        bad = {f: r for f, r in rel.items()
               if r > (SHORT_LOOSE_TOL if f in loose else SHORT_TOL)}
        worst = max(rel, key=rel.get)
        log(f"# parity {label} {name} multiregion B={B_MULTI} T={T_SHORT} "
            f"deterministic: bitwise {bitwise(k, p)}; largest per-cluster "
            f"rel diff {worst} {rel[worst]:.3g}")
        if bad:
            fail(f"mlp short-horizon parity on {name}: {bad}")
        k = run_entry("mlp", cfg, params, net, stream, T_PARITY, False)
        t0 = time.perf_counter()
        p = lane_plain("mlp", cfg, params, net, stream, T_PARITY, False)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        viol = mk.mean_parity_violations(k, p,
                                         mk.NEURAL_MEAN_PARITY_TOLERANCES)
        same = bitwise(k, p)
        log(f"# parity {label} {name} multiregion B={B_PARITY} T={T_PARITY} "
            f"deterministic: bitwise {same}; {share * 100:.4f} % of clusters "
            f"within 2e-3; worst {worst} (rel {worst_rel:.3g}); max abs diff "
            f"{max_abs:.4g}; mean_parity_violations {viol}")
        if viol:
            fail(f"mlp mean parity on {name}")
        found[label] = {"bitwise": same, "max_abs_err": max_abs,
                        "plain_ms": plain_s * 1e3,
                        "shape": f"{name} multiregion B={B_PARITY} "
                                 f"T={T_PARITY} deterministic"}
        del stream, short, k, p
        torch.cuda.empty_cache()
    return found


def plan_phase(dev, setup, hold, profiles) -> dict:
    """4b: the plan kernel against its plain version: default B = 8192 and
    multiregion B = 1024 at T = 360, both modes, a random decoded plan per
    cluster and the same plan's first cluster broadcast to every cluster;
    a rule-equivalent per-cluster plan bitwise the rule kernel. Then the
    plain-stream PLAN instantiation's time and issue floor at multiregion
    B = 32768 x T = 2880, stochastic, on a random plan. Returns its
    `kernels` row."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.sim import megakernel as mk

    before = sum(build.launch_rollout_plan.launches.values())
    rec = {"bitwise": True, "max_abs_err": 0.0, "plain_ms": 0.0}
    for preset, B in (("default", B_PARITY), ("multiregion", B_MULTI)):
        cfg, src, params, off, peak, _ = setup(preset)
        P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
        stream = src.packed_trace_device(T_PARITY, 73, B, device=dev)
        per = random_plan(cfg, B, T_PARITY, T_PARITY, dev)
        broadcast = per[..., 0].contiguous()
        is_peak = mk.unpack_exo(stream, T_PARITY, Z).is_peak > 0.5
        rule_eq = mk.pack_plan(type(off)(*(
            torch.where(is_peak.reshape(B, T_PARITY, *([1] * o.dim())), q,
                        o) for o, q in zip(off, peak))), T_PARITY)
        for st in (False, True):
            mode = "stochastic" if st else "deterministic"
            for form, plan in (("per-cluster", per),
                               ("broadcast", broadcast)):
                k = run_entry("plan", cfg, params, None, stream, T_PARITY,
                              st, plan=plan)
                t0 = time.perf_counter()
                p = lane_plain("plan", cfg, params, None, stream, T_PARITY,
                               st, plan=plan)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                same, max_abs = hold(f"plan {form} {preset} B={B} "
                                     f"T={T_PARITY} {mode}", k, p, st)
                rec["bitwise"] &= same
                rec["max_abs_err"] = max(rec["max_abs_err"], max_abs)
                if preset == "multiregion" and form == "per-cluster":
                    rec["plain_ms"] = plain_ms
            k = run_entry("plan", cfg, params, None, stream, T_PARITY, st,
                          plan=rule_eq)
            want = run_entry("rule", cfg, params, None, stream, T_PARITY, st)
            torch.cuda.synchronize()
            log(f"# plan rule-equivalent {preset} B={B} T={T_PARITY} {mode}: "
                f"bitwise the rule kernel {bitwise(k, want)}")
            if not bitwise(k, want):
                fail(f"the rule-equivalent plan is not bitwise the rule "
                     f"kernel ({preset}, {mode})")
        del stream, per, broadcast, rule_eq
        torch.cuda.empty_cache()
    rec["launches"] = sum(build.launch_rollout_plan.launches.values()) - before

    cfg, src, params, _, _, _ = setup("multiregion")
    stream = src.packed_trace_device(T_DAY, 83, B_MAIN, device=dev)
    plan = random_plan(cfg, B_MAIN, T_DAY, T_DAY, dev)
    torch.cuda.empty_cache()
    def timed():
        return run_entry("plan", cfg, params, None, stream, T_DAY, True,
                         plan=plan)

    rec["ms"] = median_ms(timed)
    b_ms, b_by, terms, ops = lane_bound(cfg, "plan", "plain")
    floor = profiles.issue_floor_ms(("plan", cfg.cluster.n_zones, True,
                                     False, 0, False), B_MAIN, T_DAY, timed)
    rec.update(bound_ms=b_ms, bound_by=b_by, bound_unit=terms["set_by"],
               ops_per_cluster_tick=ops, issue_floor_ms=floor)
    log(f"# plan kernel (plain stream) multiregion B={B_MAIN} T={T_DAY} "
        f"stochastic, random plan: {rec['ms']:.4f} ms median of {N_TIMED}; "
        f"bound {b_ms:.4f} ms ({b_by}; terms in ms {terms}; {ops} float ops "
        f"per cluster-tick); issue floor {floor:.4f} ms")
    del stream, plan
    torch.cuda.empty_cache()
    return rec


def planner_check(dev, setup) -> None:
    """The graphed receding-horizon planner against the eager one, bitwise
    (multiregion N = 1024 x T = 96, the boards' quick planner)."""
    from ccka_tpu_torch.faults.scoreboard import QUICK_PLANNER
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.train import mpc

    cfg, src, params, _, _, _ = setup("multiregion")
    N, T = B_MULTI, 96
    traces = mk.unpack_exo(src.packed_trace_device(T, 89, N, device=dev), T,
                           cfg.cluster.n_zones)
    lat0 = mpc.zero_latent(cfg.cluster, dev)
    lat0 = lat0.expand(N, QUICK_PLANNER["horizon"], *lat0.shape)
    got, secs = {}, {}
    for graph in (False, True):
        t0 = time.perf_counter()
        got[graph] = mpc.receding_horizon_plan_batch(
            params, cfg.cluster, cfg.train, initial_state(cfg, N, dev),
            traces, lat0, graph=graph, **QUICK_PLANNER)
        torch.cuda.synchronize()
        secs[graph] = time.perf_counter() - t0
    same = torch.equal(got[True], got[False])
    log(f"# planner N={N} T={T}: graphed {secs[True]:.3f} s (capture "
        f"included), eager {secs[False]:.3f} s; bitwise {same}; largest "
        f"|latent| {float(got[True].abs().max()):.4g}; "
        f"{planner_ops(cfg)} operations dispatched a segment (counted on "
        f"the CPU, views included)")
    if not same:
        fail("the graphed planner differs from the eager one")


def planner_ops(cfg) -> int:
    """Operations one segment of the quick planner dispatches (its two
    Adam iterations, forward and backward, and its executed ticks),
    counted on the CPU at N = 4."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ccka_tpu_torch.faults.scoreboard import QUICK_PLANNER
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train import mpc

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    H, R = QUICK_PLANNER["horizon"], QUICK_PLANNER["replan_every"]
    traces = SyntheticSignalSource(
        cfg.cluster, cfg.workload, cfg.sim, cfg.signals).batch_trace(
        H, [1, 2, 3, 4], device="cpu")
    window, seg = next(mpc._segment_windows(traces, H, R))
    lat0 = mpc.zero_latent(cfg.cluster, "cpu")
    with Count():
        mpc._segment(SimParams.from_config(cfg, device="cpu"), cfg.cluster,
                     cfg.train, initial_state(cfg, 4, "cpu"),
                     lat0.expand(4, H, *lat0.shape).contiguous(), window,
                     seg, QUICK_PLANNER["iters"], R)
    return Count.n


def lane_bound(cfg, policy: str, name: str, net=None, B: int = B_MAIN,
               T: int = T_DAY, extra_bytes: int = 0):
    """(bound ms, "bytes" or "operations", terms) of a lane kernel at the
    boards' size (multiregion B = 32768 x T = 2880, stochastic) or at
    ``B`` x ``T``, with ``extra_bytes`` moved besides (a carried state's
    round trips); ``name`` a fault intensity, a workload scenario or
    "plain"."""
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    sc = WORKLOAD_SCENARIOS.get(name)
    faults = (sc is None and name != "plain") or bool(sc and sc.fault_preset)
    wl = sc is not None
    Z = cfg.cluster.n_zones
    ops = float_ops_per_cluster_tick(cfg, True, policy, net, faults, wl)
    terms = {"tick": (ops * B * T, F32_UNFUSED_OPS_PER_S, "float32")}
    weight_bytes = extra_bytes
    plan_rows = mk._act_rows(cfg.cluster.n_pools, Z) if policy == "plan" \
        else 0
    if policy == "mlp":
        F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools, Z=Z)[0]
        weight_bytes += (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4
        terms["torso"] = (2 * (F * H + H * H) * B * T,
                          BF16_TENSOR_OPS_PER_S, "tensor cores")
        terms["head"] = (2 * H * A * B * T, F32_OPS_PER_S, "float32")
    return bound(rollout_bytes(Z, B, T, weight_bytes, faults, wl,
                               plan_rows), terms) + (ops,)


def board_phase(dev, setup, zero_counters, read_counters) -> dict:
    """9: the main path of this slice. The graphed planner against the
    eager one; then `fault_scoreboard` (four intensities) and
    `workload_scoreboard` (four scenarios) on the multiregion preset at
    B = 32768 x T = 2880, stochastic, rule, carbon, flagship and mpc,
    each with the launch counters zeroed just before and read just after,
    and then its :func:`stage_times` on the plan it made."""
    from ccka_tpu_torch.faults.scoreboard import fault_scoreboard
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.workloads.scoreboard import workload_scoreboard

    planner_check(dev, setup)
    cfg, _, _, _, _, net = setup("multiregion")
    policies = ("rule", "carbon", "flagship", "mpc")
    out: dict = {"launches": {}, "rows": {}, "planner_s": {}}
    out["synth_ms"], out["kernels"] = {}, {}
    runs = (("fault board", FAULT_LEVELS, "intensities", fault_scoreboard),
            ("workload board", SCENARIOS, "scenarios", workload_scoreboard))
    for board_name, names, key, scoreboard in runs:
        kept: dict = {}
        torch.cuda.synchronize()
        zero_counters()
        for counter in (build.launch_rollout_profiles,
                        build.launch_rollout_mlp, build.launch_rollout_plan):
            counter.launches.clear()
        t0 = time.perf_counter()
        board = scoreboard(cfg, policies=policies, n_traces=B_MAIN,
                           seed=BOARD_SEED, trace_seed=BOARD_TRACE_SEED,
                           device=dev, plan_out=kept)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(read_counters())
        for kernel, counter in (
                ("rollout_profiles_kernel", build.launch_rollout_profiles),
                ("rollout_profiles_kernel", build.launch_rollout_plan),
                ("rollout_mlp_kernel", build.launch_rollout_mlp)):
            launches.update({kernel + k: v
                             for k, v in counter.launches.items()})
        out["launches"][board_name] = launches
        out["planner_s"][board_name] = board["mpc_planner"]["seconds"]
        log(f"# {board_name} multiregion B={B_MAIN} T={T_DAY} stochastic: "
            f"{secs:.3f} s from a seed, of which the planner "
            f"{board['mpc_planner']['seconds']:.3f} s "
            f"({board['mpc_planner']}); launches {launches}")
        if not (board["stochastic"] and board["eval_steps"] == T_DAY
                and board["n_traces"] == B_MAIN):
            fail(f"{board_name}: not the full-size stochastic board")
        check_board(board_name, board[key], names, launches, out)
        del board
        stage_times(dev, cfg, net, out, board_name, names,
                    kept.pop("plan_packed"))
    return out


def check_board(board_name: str, boards: dict, names, launches: dict,
                out: dict) -> None:
    """Every row of a board finite and logged; every instantiation of its
    streams launched, each entry once per intensity or scenario."""
    for name in names:
        rows = boards[name]["rows"]
        if set(rows) != {"rule", "carbon", "flagship", "mpc"}:
            fail(f"{board_name} {name}: rows {sorted(rows)}")
        for policy, row in rows.items():
            if not all(math.isfinite(v) for v in row.values()):
                fail(f"{board_name} {name} {policy}: {row}")
            out["rows"][(name, policy)] = row
        log(f"#   {name}: " + "; ".join(
            f"{p} $/SLO-hr {r['usd_per_slo_hour']} SLO "
            f"{r['slo_attainment']}"
            + (f" vs calm {r['vs_calm_usd_per_slo_hour']}"
               if "vs_calm_usd_per_slo_hour" in r else
               f" inf viol {r['inf_slo_violations']} batch miss "
               f"{r['batch_deadline_misses']}")
            for p, r in rows.items()))
        for policy in BOARD_POLICIES:
            label = instantiation_name(policy, name)
            if launches.get(label, 0) < 1:
                fail(f"{board_name} never launched {label}")
    for entry in ("rollout_profiles_kernel",
                  "rollout_profiles_kernel<CARBON>",
                  "rollout_mlp_kernel", "plan entry"):
        if launches[entry] != len(names):
            fail(f"{board_name}: {entry} launched {launches[entry]} "
                 f"times, expected {len(names)}")


def stage_times(dev, cfg, net, out: dict, board_name: str, names,
                plan: torch.Tensor) -> None:
    """Each of a board's streams once more from the same seed, timed:
    synthesis, each entry, each kernel as the median of 5 (the plan
    kernel on the packed plan the board made; each row, the mpc row
    included, is checked to reproduce the board's); on severe and mixed
    each row held against its plain version at T = 360."""
    from ccka_tpu_torch.faults.scoreboard import summary_mean
    from ccka_tpu_torch.sim import megakernel as mk

    stage = {}
    for name in names:
        source, wl = lane_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        held = []
        out["synth_ms"][name] = cuda_ms(lambda: held.append(
            source.packed_trace_device(T_DAY, BOARD_TRACE_SEED, B_MAIN,
                                       device=dev)))[0]
        stream = held.pop()
        log(f"# {name}: packed_trace_device {out['synth_ms'][name]:.4f} ms "
            f"([{T_DAY}, {stream.shape[1]}, {B_MAIN}])")
        for policy in BOARD_POLICIES:
            label = instantiation_name(policy, name)

            def entry(T=T_DAY):
                return run_entry(policy, cfg, params, net, stream, T, True,
                                 seed=BOARD_SEED, plan=plan)

            got = []
            entry_ms = cuda_ms(lambda: got.append(entry()))[0]
            k = got.pop()
            row = out["rows"][(name, BOARD_ROW[policy])]
            if summary_mean(k.usd_per_slo_hour) != row["usd_per_slo_hour"]:
                fail(f"{name} {policy}: the regenerated stream does not "
                     f"reproduce the board's row")
            k_ms = median_ms(entry)
            stage[(name, policy)] = k_ms
            if name not in ("severe", "flash-crowd", "mixed"):
                log(f"#   {label} on {name}: entry {entry_ms:.4f} ms, "
                    f"kernel {k_ms:.4f} ms median of {N_TIMED}")
                continue
            b_ms, b_by, terms, ops = lane_bound(cfg, policy, name, net)
            rec = {"ms": k_ms, "entry_ms": entry_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bound_unit": terms["set_by"],
                   "ops_per_cluster_tick": ops,
                   "shape": f"{name} multiregion B={B_MAIN} T={T_DAY} "
                            f"stochastic"}
            log(f"#   {label} on {name}: entry {entry_ms:.4f} ms, kernel "
                f"{k_ms:.4f} ms median of {N_TIMED}; bound {b_ms:.4f} ms "
                f"({b_by}; terms in ms {terms}; {ops} float ops per "
                f"cluster-tick)")
            if name != "flash-crowd":
                k = entry(T_PARITY)
                t0 = time.perf_counter()
                p = lane_plain(policy, cfg, params, net, stream, T_PARITY,
                               True, seed=BOARD_SEED, plan=plan)
                torch.cuda.synchronize()
                rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
                rec["plain_shape"] = (f"{name} multiregion B={B_MAIN} "
                                      f"T={T_PARITY} stochastic")
                share, worst, worst_rel, max_abs = per_cluster_share(k, p)
                tol = (mk.NEURAL_MEAN_PARITY_TOLERANCES if policy == "mlp"
                       else None)
                viol = mk.mean_parity_violations(k, p, tol)
                rec.update(max_abs_err=max_abs, bitwise=bitwise(k, p))
                log(f"#   {label} vs plain at T={T_PARITY} "
                    f"({rec['plain_ms']:.4f} ms): "
                    f"bitwise {rec['bitwise']}; {share * 100:.4f} % of "
                    f"clusters within 2e-3; worst {worst} (rel "
                    f"{worst_rel:.3g}); max abs diff {max_abs:.4g}; "
                    f"mean_parity_violations {viol}")
                if viol or (policy != "mlp" and share < 0.99):
                    fail(f"{name} {policy}: kernel and plain version "
                         f"disagree")
                del p
            out["kernels"][label] = rec
        del stream
        torch.cuda.empty_cache()
    del plan
    torch.cuda.empty_cache()
    synth = sum(out["synth_ms"][n] for n in names)
    kern = {p: sum(stage[(n, p)] for n in names) for p in BOARD_POLICIES}
    planner_ms = out["planner_s"][board_name] * 1e3
    log(f"# {board_name} stages, timed one by one: synthesis "
        f"{synth:.4f} ms, planner {planner_ms:.4f} ms, kernels "
        + ", ".join(f"{p} {ms:.4f} ms" for p, ms in kern.items())
        + f"; sum {synth + planner_ms + sum(kern.values()):.4f} ms")


def lane_kernel_rows(boards: dict, found: dict) -> list:
    """The `kernels` line's entries of the lane instantiations."""
    rows = []
    for name in ("severe", "flash-crowd", "mixed"):
        for policy in BOARD_POLICIES:
            label = instantiation_name(policy, name)
            rec = dict(boards["kernels"][label])
            parity = found[label]
            if "plain_ms" not in rec:   # flash-crowd: from phase 5c
                rec.update(plain_ms=parity["plain_ms"],
                           max_abs_err=parity["max_abs_err"],
                           bitwise=parity["bitwise"],
                           parity_shape=parity["shape"])
            else:
                rec["bitwise_in_phase_5c"] = parity["bitwise"]
            by_path = {b: n.get(label, 0)
                       for b, n in boards["launches"].items()}
            rows.append({
                "name": label, "route": "cuda",
                "source": ("ccka_tpu_torch/csrc/rollout_mlp.cu"
                           if policy == "mlp" else
                           "ccka_tpu_torch/csrc/rollout_profiles.cu"),
                "replaces": (PLAN_REPLACES if policy == "plan" else
                             REPLACES["FAULTS" if "FAULTS" in label
                                      else "WL_D=16"]),
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": rec.pop("max_abs_err"),
                "ms": rec.pop("ms"), "plain_ms": rec.pop("plain_ms"),
                "bound_ms": rec.pop("bound_ms"),
                "bound_by": rec.pop("bound_by"), "library_ms": None,
                **rec})
    return rows


# ---- the MLP kernel's forward, layer by layer (phase 5e)

FWD_TICKS = (0, 60, 120, 180)
FWD_REPLACES = "ccka_tpu/sim/megakernel.py:509"


def forward_ops(net) -> int:
    """Floating-point pointwise operations of the plain forward on one
    observation (:func:`pointwise_ops`)."""
    from ccka_tpu_torch.sim import megakernel as mk

    weights = tuple(w[0] for w in mk._pack_mlp_tensors(net, "cpu"))
    obs = torch.ones((1, weights[0].shape[0]))
    return pointwise_ops(lambda: mk.mlp_stages(obs, weights))


def forward_phase(dev, setup) -> dict:
    """5e: the observations of the plain multiregion rollout's states on
    the calm stream (B = 32768, `kernel_numerics_action_fn`) at
    FWD_TICKS through `mlp_forward` on the card, each held by
    `check_mlp_forward` and `mlp_forward_departures`; the entry's time, its plain version's and its
    bound at N = 32768. Returns its `kernels` row."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.base import observe
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            initial_state)

    cfg, src, params, _, _, net = setup("multiregion")
    T = max(FWD_TICKS) + 1
    traces = src.batch_trace_device(
        T, torch.Generator(device=dev).manual_seed(59), B_MAIN, device=dev)
    plain = mk.kernel_numerics_action_fn(net, cfg.cluster, params)
    seen = {}

    def action_fn(state, exo, t):
        if t in FWD_TICKS:
            seen[t] = observe(params, state, exo).flatten().contiguous()
        return plain(state, exo, t)

    batched_rollout_summary(params, initial_state(cfg, B_MAIN, dev),
                            action_fn, traces, 5, stochastic=False)
    del traces
    weights = mk._pack_mlp_tensors(net, dev)
    build.launch_mlp_forward.launches = 0
    worst: dict = {"u_max_abs_diff": 0.0}
    for t in FWD_TICKS:
        got = mk.mlp_forward(seen[t], weights)
        torch.cuda.synchronize()
        rep = mk.check_mlp_forward(got, seen[t], weights)
        log(f"# 5e forward multiregion N={B_MAIN} tick {t}: {rep}")
        if any(rep["violations"].values()):
            fail(f"5e: the MLP kernel's forward at tick {t} breaks its "
                 f"standard: {rep['violations']}")
        departures = mk.mlp_forward_departures(rep)
        if departures:
            fail(f"5e: the MLP kernel's forward at tick {t} is not "
                 f"bitwise its plain version, or its sums leave the "
                 f"near-tie window: {departures}")
        worst["u_max_abs_diff"] = max(worst["u_max_abs_diff"],
                                      rep["u_max_abs_diff"])
        for f, v in rep["bitwise_share"].items():
            worst[f"min_bitwise_share_{f}"] = min(
                worst.get(f"min_bitwise_share_{f}", 1.0), v)
        for key in ("sum_bound_use", "near_tie_share"):
            for f, v in rep[key].items():
                worst[f"max_{key}_{f}"] = max(
                    worst.get(f"max_{key}_{f}", 0.0), v)
    launches = build.launch_mlp_forward.launches
    if launches != len(FWD_TICKS):
        fail(f"5e launched the forward {launches} times, expected "
             f"{len(FWD_TICKS)}")
    obs = seen[FWD_TICKS[-1]]
    ms = median_ms(lambda: mk.mlp_forward(obs, weights))
    member = tuple(w[0] for w in weights)
    plain_ms = median_ms(lambda: mk.mlp_stages(obs, member))
    F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools,
                           Z=cfg.cluster.n_zones)[0]
    N = B_MAIN
    ops = forward_ops(net)
    nbytes = (N * F * 4 + N * F * 2 + 2 * N * H * (4 + 2) + N * A * 4
              + (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4)
    b_ms, b_by, terms = bound(nbytes, {
        "pointwise": (ops * N, F32_UNFUSED_OPS_PER_S, "float32"),
        "torso": (2 * (F * H + H * H) * N, BF16_TENSOR_OPS_PER_S,
                  "tensor cores"),
        "head": (2 * H * A * N, F32_OPS_PER_S, "float32")})
    log(f"# 5e forward N={N}: {ms:.4f} ms median of {N_TIMED}, plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}; terms in ms "
        f"{terms}; {ops} pointwise float ops per observation); over the "
        f"{len(FWD_TICKS)} ticks {worst}")
    return {"name": "mlp_forward_kernel", "route": "cuda",
            "source": "ccka_tpu_torch/csrc/rollout_mlp.cu",
            "replaces": FWD_REPLACES, "launches": launches,
            "launches_from": "phase 5e, its check: the rollout kernel "
                             "inlines the same device functions (0 "
                             "launches on every path)",
            "max_abs_err": worst["u_max_abs_diff"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": f"multiregion N={N}, F={F} H={H} A={A}, the plain "
                     f"rollout's observations at tick {FWD_TICKS[-1]}",
            **{k: v for k, v in worst.items() if k != "u_max_abs_diff"}}


# ---- carried-state streaming (phase 10)

STREAM_KEY, STREAM_SEED = 83, 41    # the blocked stream's seed; Philox's
BLOCK_DAY = 360                     # 8 blocks a day (phase 10c, 10d)
BLOCK_PARITY = 180                  # 4 blocks of T_BLOCKED (phase 10a)
HELD_BLOCKS = 2                     # full-width blocks held to plain (10c)
# The port's kernels have no time chunk; 20 ticks divide every block here,
# so the splits pass the JAX package's own checks.
T_CHUNK_STREAM = 20
B_CHUNKED, CHUNK = 262144, 32768    # phase 10d: 8 chunks
CARRY_REPLACES = "ccka_tpu/sim/megakernel.py:340"
ROUTES = ("rule", "carbon", "mlp", "plan")
BLOCK_MODE = {"rule": "rule", "carbon": "carbon", "mlp": "neural",
              "plan": "plan"}
STREAM_NAMES = ("plain", "severe", "flash-crowd", "mixed")


def stream_source(cfg, name: str):
    """(source, WorkloadsConfig or None) of the plain stream or a lane
    stream."""
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    if name == "plain":
        return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                     cfg.signals), None
    return lane_source(cfg, name)


def carry_label(route: str, name: str) -> str:
    """The CARRY instantiation a route runs on a stream."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.workloads.scenarios import WORKLOAD_SCENARIOS

    sc = WORKLOAD_SCENARIOS.get(name)
    faults = (name in FAULT_LEVELS) or bool(sc and sc.fault_preset)
    suffix = build.instantiation(route, faults, 16 if sc else 0, carry=True)
    return ("rollout_mlp_kernel" if route == "mlp"
            else "rollout_profiles_kernel") + suffix


def block_fns(cfg, params, route: str, T: int, block_T: int, stochastic,
              net=None, plan=None):
    from ccka_tpu_torch.sim import megakernel as mk

    return mk.packed_mode_block_summary_fn(
        params, cfg.cluster, BLOCK_MODE[route], T=T, block_T=block_T,
        t_chunk=T_CHUNK_STREAM if block_T % 16 else 16,
        stochastic=stochastic, net_params=net if route == "mlp" else None,
        plan_packed=plan if route == "plan" else None)


def carry_day(fns, blocks, seed: int = STREAM_SEED):
    """Every block through the CARRY kernel from a fresh state, the state
    alternating between two buffers; returns the last block's accumulator
    rows."""
    first = fns.init_state(blocks[0].shape[1], blocks[0].shape[2],
                           device=blocks[0].device)
    states = [first, torch.zeros_like(first)]
    out = None
    for j, blk in enumerate(blocks):
        out, _ = fns.step(blk, states[j % 2], j, seed,
                          state_out=states[(j + 1) % 2])
    return out


def hold_carry(fns, blocks, what: str) -> tuple[float, float]:
    """Each block through the CARRY kernel and through its plain version
    (`plain_step` on the card) from the same carried state; fails unless
    the two states after every block are bitwise equal. Returns (the plain
    version's seconds over all blocks, the largest absolute difference)."""
    state = fns.init_state(blocks[0].shape[1], blocks[0].shape[2],
                           device=blocks[0].device)
    k_state, p_state = torch.zeros_like(state), torch.zeros_like(state)
    plain_s = err = 0.0
    for j, blk in enumerate(blocks):
        fns.step(blk, state, j, STREAM_SEED, state_out=k_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns.plain_step(blk, state, j, STREAM_SEED, state_out=p_state)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        diff = (k_state - p_state).abs()
        err = max(err, float(diff.max()))
        if not torch.equal(k_state, p_state):
            rows = sorted(set(torch.nonzero(diff)[:, -2].tolist()))
            fail(f"{what}: the carried state after block {j} differs from "
                 f"its plain version in rows {rows[:12]} (max abs "
                 f"{float(diff.max()):.4g})")
        state, p_state = p_state, state
    return plain_s, err


def state_bytes(cfg, params, route: str, rows: int, B: int,
                n_blocks: int) -> int:
    """Bytes a blocked day moves in carried state: the used rows read and
    written once a block."""
    from ccka_tpu_torch.sim import megakernel as mk

    layout = mk._carry_layout(params, cfg.cluster, BLOCK_MODE[route], rows)
    return layout.blocks()["queues"][1] * 4 * B * 2 * n_blocks


def carry_phase(dev, setup) -> dict:
    """10a: every CARRY instantiation (4 routes x plain, severe,
    flash-crowd, mixed x both modes), multiregion B = 8192 x T = 720 in
    blocks of 180: its last state's summary bitwise the non-carry
    kernel's on the concatenated stream; the stochastic day's time (4
    launches) against the non-carry launch's. 10b: at B = 1024 x T = 32
    in blocks of 16, both modes, the carried state after every block
    bitwise its plain version's `pack_carry` (`plain_step` on the card);
    the plain version's time (10c holds the mixed stream's at full
    width). Returns {instantiation: record}."""
    from ccka_tpu_torch.sim import megakernel as mk

    t_phase = time.perf_counter()
    cfg, _, _, _, _, net = setup("multiregion")
    found: dict = {}
    plan = random_plan(cfg, B_PARITY, T_BLOCKED, T_BLOCKED, dev)
    n_bitwise = 0
    for name in STREAM_NAMES:
        source, wl = stream_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        blocks = [source.packed_block_trace_device(
            BLOCK_PARITY, STREAM_KEY, B_PARITY, j, t_chunk=T_CHUNK_STREAM,
            device=dev) for j in range(T_BLOCKED // BLOCK_PARITY)]
        full = torch.cat(blocks)
        for route in ROUTES:
            label = carry_label(route, name)
            rec = found.setdefault(label, {"route": route, "stream": name})
            for st in (False, True):
                fns = block_fns(cfg, params, route, T_BLOCKED, BLOCK_PARITY,
                                st, net, plan)

                def noncarry():
                    return mk.packed_mode_summary(
                        params, cfg.cluster, BLOCK_MODE[route], full,
                        T_BLOCKED, STREAM_SEED, stochastic=st,
                        net_params=net if route == "mlp" else None,
                        plan_packed=plan)

                got = fns.finalize(carry_day(fns, blocks))
                want = noncarry()
                torch.cuda.synchronize()
                if not bitwise(got, want):
                    bad = [f for f in got._fields if not torch.equal(
                        getattr(got, f), getattr(want, f))]
                    fail(f"10a: {label} on {name} (stochastic={st}) is not "
                         f"bitwise the non-carry kernel: {bad}")
                n_bitwise += 1
                if st:
                    rec["a_ms"] = median_ms(lambda: carry_day(fns, blocks))
                    rec["a_noncarry_ms"] = median_ms(noncarry)
                    rec["a_bound"] = lane_bound(
                        cfg, route, name, net, B_PARITY, T_BLOCKED,
                        state_bytes(cfg, params, route, full.shape[1],
                                    B_PARITY, len(blocks)))
        del blocks, full
        torch.cuda.empty_cache()
    log(f"# 10a carry: {n_bitwise} blocked days (4 routes x "
        f"{len(STREAM_NAMES)} streams x 2 modes, multiregion B={B_PARITY} "
        f"T={T_BLOCKED}, blocks of {BLOCK_PARITY}), every one bitwise the "
        f"non-carry kernel on the concatenated stream "
        f"({time.perf_counter() - t_phase:.1f} s)")
    for label, rec in found.items():
        log(f"#   {label} ({rec['stream']}): day of 4 CARRY launches "
            f"{rec['a_ms']:.4f} ms, non-carry {rec['a_noncarry_ms']:.4f} ms "
            f"(x {rec['a_ms'] / rec['a_noncarry_ms']:.4f}); bound "
            f"{rec['a_bound'][0]:.4f} ms ({rec['a_bound'][1]})")

    # 10b: the carried state against its plain version after every block.
    n_states = 0
    T, bT = T_SHORT, 16
    bplan = random_plan(cfg, B_MULTI, T, T, dev)
    for name in STREAM_NAMES:
        source, wl = stream_source(cfg, name)
        params = lane_params(cfg, wl, dev)
        blocks = [source.packed_block_trace_device(
            bT, STREAM_KEY, B_MULTI, j, t_chunk=16, device=dev)
            for j in range(T // bT)]
        for route in ROUTES:
            label = carry_label(route, name)
            rec = found[label]
            for st in (False, True):
                fns = block_fns(cfg, params, route, T, bT, st, net, bplan)
                plain_s, err = hold_carry(
                    fns, blocks, f"10b: {label} on {name} (stochastic={st})")
                n_states += len(blocks)
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
                if st:
                    rec["plain_ms"] = plain_s * 1e3
                    rec["plain_shape"] = (f"{name} multiregion B={B_MULTI} "
                                          f"T={T} in blocks of {bT}, "
                                          f"stochastic, the plain version on "
                                          f"the card (plain_step)")
        del blocks
    log(f"# 10b carry: {n_states} carried states (every block of 4 routes x "
        f"{len(STREAM_NAMES)} streams x 2 modes at B={B_MULTI}), every one "
        f"bitwise its plain version's pack_carry (10a and 10b "
        f"{time.perf_counter() - t_phase:.1f} s)")
    torch.cuda.empty_cache()
    return found


def streaming_phase(dev, setup, found: dict) -> dict:
    """10c: the main path of this slice: multiregion B = 32768 x T = 2880,
    stochastic, the mixed stream in 8 blocks of 360, rule, carbon, the
    shipped flagship and a decoded per-cluster plan, each through the
    synchronous and the double-buffered drive of
    `streaming_rollout_summary`, the CARRY counters zeroed just before and
    read just after; both drives bitwise each other and
    `unblocked_reference_summary`; a day of 8 CARRY launches timed against
    the non-carry launch on the same stream; the CARRY kernels held
    against `plain_step` on the day's first two blocks at full width,
    their carried state bitwise after each. 10d: the cluster-chunked
    rule drive at B = 262144 (8 chunks of 32768), its peak memory, its
    last chunk bitwise a single-chunk run. Returns the phase's record."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm

    cfg, _, _, _, _, net = setup("multiregion")
    source, wl = stream_source(cfg, "mixed")
    params = lane_params(cfg, wl, dev)
    plan = random_plan(cfg, B_MAIN, T_DAY, T_DAY, dev)
    kw = dict(key=STREAM_KEY, batch=B_MAIN, T=T_DAY, block_T=BLOCK_DAY,
              seed=STREAM_SEED, t_chunk=T_CHUNK_STREAM, stochastic=True,
              device=dev)

    def route_kw(route):
        return dict(kw, net_params=net if route == "mlp" else None,
                    plan_packed=plan if route == "plan" else None)

    counters = (build.launch_rollout_profiles, build.launch_rollout_plan,
                build.launch_rollout_mlp)
    rec: dict = {"drives": {}}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    for counter in counters:
        counter.launches.clear()
    runs = {}
    for route in ROUTES:
        # Each drive twice, in turns: sync, double-buffered, then the other
        # way round.
        for pipelined in (False, True, True, False):
            runs.setdefault((route, pipelined), []).append(
                stm.streaming_rollout_summary(
                    source, params, cfg.cluster, BLOCK_MODE[route],
                    pipelined=pipelined, **route_kw(route)))
    torch.cuda.synchronize()
    launches: dict = {}
    for counter, kernel in zip(counters, ("rollout_profiles_kernel",
                                          "rollout_profiles_kernel",
                                          "rollout_mlp_kernel")):
        launches.update({kernel + k: v for k, v in counter.launches.items()})
    rec["launches"] = launches
    log(f"# 10c streaming path multiregion B={B_MAIN} T={T_DAY} stochastic, "
        f"mixed stream in {T_DAY // BLOCK_DAY} blocks of {BLOCK_DAY}: "
        f"launches {launches}")
    for route in ROUTES:
        label = carry_label(route, "mixed")
        if launches.get(label, 0) != 4 * (T_DAY // BLOCK_DAY):
            fail(f"10c: {label} launched {launches.get(label, 0)} times, "
                 f"expected {4 * (T_DAY // BLOCK_DAY)}")
    if any("CARRY" not in k for k in launches):
        fail(f"10c: a non-carry kernel ran on the streaming path: "
             f"{launches}")
    for route in ROUTES:
        ref = stm.unblocked_reference_summary(
            source, params, cfg.cluster, BLOCK_MODE[route],
            **{k: v for k, v in route_kw(route).items()})
        for summary, rep in runs[route, False] + runs[route, True]:
            if not bitwise(summary, ref):
                fail(f"10c: {route}: the {rep['pipeline']} drive is not "
                     f"bitwise the unblocked reference")
        pipe = runs[route, True][0][0]
        buffers = [rep["stream_buffers"] for _, rep in runs[route, True]]
        if buffers != [2, 2]:
            fail(f"10c: {route}: the double-buffered drives used {buffers} "
                 f"stream buffers")
        for f in ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment",
                  "inf_slo_violations", "batch_deadline_misses"):
            v = getattr(pipe, f)
            if v.shape != (B_MAIN,) or not torch.isfinite(v).all():
                fail(f"10c: {route}.{f} malformed")
        rec["drives"][route] = {
            "sync": [{"wall_s": rep["wall_s"],
                      "seconds": rep["occupancy"]["seconds"],
                      "fractions": rep["occupancy"]["fractions"]}
                     for _, rep in runs[route, False]],
            "double_buffered": [{"wall_s": rep["wall_s"],
                                 "pipeline_s": rep["pipeline_s"],
                                 "host_s": rep["host_s"],
                                 "stream_buffers": rep["stream_buffers"]}
                                for _, rep in runs[route, True]]}
        log(f"#   {route}: " + "; ".join(
            f"sync wall {d['wall_s']} s (stages {d['seconds']}, fractions "
            f"{d['fractions']})" for d in rec["drives"][route]["sync"])
            + "; " + "; ".join(
            f"double-buffered wall {d['wall_s']} s (pipeline "
            f"{d['pipeline_s']} s, host {d['host_s']} s, "
            f"{d['stream_buffers']} stream buffers)"
            for d in rec["drives"][route]["double_buffered"])
            + f"; all four bitwise the unblocked reference; $/SLO-hr "
            f"{pipe.usd_per_slo_hour.mean().item():.6f}, SLO attainment "
            f"{pipe.slo_attainment.mean().item():.6f}")
    del runs, ref, pipe
    torch.cuda.empty_cache()
    log(f"#   10c drives and references: "
        f"{time.perf_counter() - t_phase:.1f} s")

    # A day of 8 CARRY launches against one non-carry launch, same stream.
    blocks = [source.packed_block_trace_device(
        BLOCK_DAY, STREAM_KEY, B_MAIN, j, t_chunk=T_CHUNK_STREAM,
        device=dev) for j in range(T_DAY // BLOCK_DAY)]
    full = torch.cat(blocks)
    del blocks
    torch.cuda.empty_cache()
    views = [full[j * BLOCK_DAY:(j + 1) * BLOCK_DAY]
             for j in range(T_DAY // BLOCK_DAY)]
    for route in ROUTES:
        fns = block_fns(cfg, params, route, T_DAY, BLOCK_DAY, True, net,
                        plan)
        r = found[carry_label(route, "mixed")]
        r["ms"] = median_ms(lambda: carry_day(fns, views))
        r["noncarry_ms"] = median_ms(lambda: mk.packed_mode_summary(
            params, cfg.cluster, BLOCK_MODE[route], full, T_DAY,
            STREAM_SEED, net_params=net if route == "mlp" else None,
            plan_packed=plan))
        r["bound"] = lane_bound(
            cfg, route, "mixed", net, B_MAIN, T_DAY,
            state_bytes(cfg, params, route, full.shape[1], B_MAIN,
                        len(views)))
        log(f"#   {route}: day of {len(views)} CARRY launches "
            f"{r['ms']:.4f} ms, non-carry {r['noncarry_ms']:.4f} ms "
            f"(x {r['ms'] / r['noncarry_ms']:.4f}); bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; terms "
            f"{r['bound'][2]})")
        # The main path's shape held against the plain version: the day's
        # first blocks, across a block boundary.
        label = carry_label(route, "mixed")
        plain_s, err = hold_carry(fns, views[:HELD_BLOCKS],
                                  f"10c: {label} at full width")
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        r["plain_ms"] = plain_s * 1e3
        r["plain_shape"] = (f"mixed multiregion B={B_MAIN}, the day's first "
                            f"{HELD_BLOCKS} blocks of {BLOCK_DAY} (T="
                            f"{HELD_BLOCKS * BLOCK_DAY}), stochastic, the "
                            f"plain version on the card (plain_step)")
        log(f"#   {route}: the carried state after each of the first "
            f"{HELD_BLOCKS} blocks bitwise its plain version's at B={B_MAIN} "
            f"(max abs {err}); plain version {r['plain_ms']:.4f} ms")
    del full, views, plan, fns
    torch.cuda.empty_cache()

    # 10d: the cluster-chunked rule drive.
    torch.cuda.synchronize()
    chunked, rep = stm.chunked_streaming_summary(
        source, params, cfg.cluster, "rule", key=STREAM_KEY,
        batch=B_CHUNKED, chunk=CHUNK, T=T_DAY, block_T=BLOCK_DAY,
        seed=STREAM_SEED, t_chunk=T_CHUNK_STREAM, stochastic=True,
        device=dev)
    last = B_CHUNKED // CHUNK - 1
    single, _ = stm.streaming_rollout_summary(
        source, params, cfg.cluster, "rule", **dict(
            kw, batch=CHUNK, shard=last, cluster0=last * CHUNK))
    tail = type(chunked)(*(x[last * CHUNK:] for x in chunked))
    if not bitwise(tail, single):
        fail("10d: the chunked drive's last chunk is not bitwise a "
             "single-chunk run")
    if rep["stream_buffers"] != 2:
        fail(f"10d: {rep['stream_buffers']} stream buffers")
    if not all(torch.isfinite(x).all() for x in chunked) or \
            chunked.cost_usd.shape != (B_CHUNKED,):
        fail("10d: malformed chunked summary")
    rec["chunked"] = rep
    log(f"# 10d chunked rule drive B={B_CHUNKED} ({rep['chunks']} chunks of "
        f"{CHUNK}) T={T_DAY} stochastic, mixed stream: wall "
        f"{rep['wall_s']:.6f} s; peak memory {rep['peak_bytes']} bytes "
        f"against two live blocks {rep['live_block_bytes']} bytes and the "
        f"unchunked stream {rep['stream_bytes']} bytes; "
        f"{rep['stream_buffers']} stream buffers; the last chunk bitwise a "
        f"single-chunk run; $/SLO-hr "
        f"{chunked.usd_per_slo_hour.mean().item():.6f}")
    del chunked, single, tail
    torch.cuda.empty_cache()
    log(f"#   10c and 10d: {time.perf_counter() - t_phase:.1f} s")
    return rec


def carry_kernel_rows(found: dict, stream_rec: dict) -> list:
    """The `kernels` line's entries of the CARRY instantiations: on the
    mixed stream (the streaming path's), times at full size; on the
    others, at phase 10a's B = 8192 x T = 720."""
    rows = []
    n_day, n_parity = T_DAY // BLOCK_DAY, T_BLOCKED // BLOCK_PARITY
    for label, rec in found.items():
        main = rec["stream"] == "mixed"
        b_ms, b_by, _, _ = rec["bound"] if main else rec["a_bound"]
        rows.append({
            "name": label, "route": "cuda",
            "source": ("ccka_tpu_torch/csrc/rollout_mlp.cu"
                       if rec["route"] == "mlp" else
                       "ccka_tpu_torch/csrc/rollout_profiles.cu"),
            "replaces": CARRY_REPLACES,
            "launches": stream_rec["launches"].get(label, 0),
            "launches_from": ("phase 10c, the streaming path (sync and "
                              "double-buffered drives)" if main else
                              "phase 10a, its checks (not on the streaming "
                              "path, whose stream is mixed)"),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"] if main else rec["a_ms"],
            "noncarry_ms": (rec["noncarry_ms"] if main
                            else rec["a_noncarry_ms"]),
            "plain_ms": rec["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "bitwise": True,
            "shape": (f"{rec['stream']} multiregion B="
                      f"{B_MAIN if main else B_PARITY} T="
                      f"{T_DAY if main else T_BLOCKED} stochastic, a day of "
                      f"{n_day if main else n_parity} CARRY launches (ms) "
                      f"against one non-carry launch (noncarry_ms)"),
            "plain_shape": rec["plain_shape"]})
    return rows


# ---- the training path (phase 11)

TRAIN_SEED = 11
TRAIN_G, TRAIN_POP = 256, 64        # the mega engine's generation
DISTILL_B, DISTILL_T = 256, 256     # collect_dataset's batch and ticks
DISTILL_ITERS, DISTILL_MB = 300, 4096
CEM_GENS = 2
PPO_ITERS = 3                       # at the config's 256 x 64
FACTORY_SCENARIO, FACTORY_INTENSITY = "diurnal-inference", "moderate"
NAIVE_PAIRS = 1
NAIVE_STEPS = 32                    # 4 of a 96-tick pair's 12 segments
FLAGSHIP_GENS, FLAGSHIP_DISTILL = 2, 200
N_SELECT = 5                        # selection traces of a full day


def synced(fn):
    """``(fn(), seconds)`` on the host clock between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def training_phase(dev, setup, hold, plain, rule_fn, carbon_fn,
                   zero_counters, read_counters) -> dict:
    """Phase 11, the training path at multiregion with the shipped net's
    widths: (a) the carbon teacher distilled; (b) two CEM generations on
    the mega engine from (a)'s params, each one rule, one carbon and one
    64-member population launch, generation 0's launches held against
    their plain versions on the stream's first T_POP ticks; (c) three
    PPO iterations; (d) one factory cell, its CARRY playback and rule
    column bitwise the unblocked references, its pairs/s against the
    naive per-pair loop; (e) `train_flagship` through `main` with the
    mega engine, the npz loaded back and its digest checked. Returns the
    phase's record."""
    import contextlib
    import io

    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.models.nets import latent_to_action
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim import streaming as stm
    from ccka_tpu_torch.train import cem, factory, flagship, imitate
    from ccka_tpu_torch.train.checkpoint import (PARAMS_DIGEST_KEY,
                                                 load_params_npz,
                                                 params_digest)
    from ccka_tpu_torch.obs.runlog import read_runlog
    from ccka_tpu_torch.train.ppo import PPOTrainer
    from ccka_tpu_torch.workloads.scenarios import resolve_scenarios

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, src, params, off, peak, _ = setup("multiregion")
    Zm = cfg.cluster.n_zones
    teacher = CarbonAwarePolicy(cfg.cluster, device=dev)
    rec: dict = {}

    # 11a: distil the carbon teacher.
    data, collect_s = synced(lambda: imitate.collect_dataset(
        cfg, teacher, src, batch_clusters=DISTILL_B, steps=DISTILL_T,
        seed=TRAIN_SEED, device=dev))
    (net, hist), imitate_s = synced(lambda: imitate.imitate(
        cfg, teacher, src, iterations=DISTILL_ITERS, minibatch=DISTILL_MB,
        dataset=data, seed=TRAIN_SEED, device=dev))
    for k in ("actor_mse", "critic_mse"):
        vals = [h[k] for h in hist]
        if not np.isfinite(vals).all() or not vals[-1] < vals[0]:
            fail(f"11a: {k} not finite and falling: {vals}")
    rec["distill"] = {"collect_s": collect_s, "imitate_s": imitate_s,
                      "rows": int(data.obs.shape[0]), "history": hist}
    log(f"# 11a distil: collect_dataset B={DISTILL_B} x T={DISTILL_T} "
        f"{collect_s:.3f} s ({data.obs.shape[0]} rows), imitate "
        f"{DISTILL_ITERS} iterations at minibatch {DISTILL_MB} "
        f"{imitate_s:.3f} s; actor_mse {hist[0]['actor_mse']:.4f} -> "
        f"{hist[-1]['actor_mse']:.4f}, critic_mse "
        f"{hist[0]['critic_mse']:.4f} -> {hist[-1]['critic_mse']:.4f}")
    del data

    # 11b: CEM on the mega engine, its draws kept for the checks.
    ccfg = cem.CEMConfig(generations=CEM_GENS, popsize=TRAIN_POP,
                         traces_per_gen=TRAIN_G, eval_steps=T_DAY,
                         sigma_min=1e-3)
    flat0, spec = cem._flatten(net, dev)
    rng = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    draws = []

    def draw(g):
        seed_g = int(torch.randint(2 ** 30, (1,), generator=rng, device=dev))
        d = cem.CEMDraws(
            src.packed_trace_device(T_DAY, seed_g, TRAIN_G, device=dev),
            int(torch.randint(2 ** 30, (1,), generator=rng, device=dev)),
            torch.randn((TRAIN_POP - 1, flat0.shape[0]), generator=rng,
                        device=dev))
        draws.append(d)
        return d

    zero_counters()
    (best, chist, info), cem_s = synced(lambda: cem.cem_refine(
        cfg, net, src, cem=ccfg, engine="mega", teacher_policy=teacher,
        draws=draw, device=dev))
    cem_launches = read_counters()
    for name in ("rollout_profiles_kernel", "rollout_profiles_kernel<CARBON>",
                 "rollout_mlp_kernel"):
        if cem_launches[name] != CEM_GENS:
            fail(f"11b: {CEM_GENS} generations launched {name} "
                 f"{cem_launches[name]} times, not once a generation")
    for r in chist:
        if not np.isfinite(r["incumbent_fitness"]):
            fail(f"11b: generation {r['generation']} fitness not finite")
    gens = [(r["incumbent_fitness"], r["best_fitness"], r["improved"])
            for r in chist]
    log(f"# 11b CEM mega engine NP={TRAIN_POP} x G={TRAIN_G} x T={T_DAY}: "
        f"{CEM_GENS} generations {cem_s:.3f} s; launches {cem_launches}; "
        f"(incumbent, best, improved) by generation {gens}")

    d0 = draws[0]
    mask = cem.perturbation_mask(net, ccfg, cfg.cluster, dev)
    cand = cem.candidates(flat0, torch.tensor(ccfg.sigma0,
                                              dtype=torch.float32,
                                              device=dev), d0.noise, mask)
    stacked = cem._unflatten(cand, spec)
    k_pop = mk.neural_megakernel_summary_from_packed(
        params, cfg.cluster, stacked, d0.worlds, T_POP, d0.world_seed)
    p_pop, pop_plain_s = synced(lambda: mk.population_plain_summary(
        params, cfg.cluster, stacked, d0.worlds, T_POP, d0.world_seed))
    pop_abs, worst, n_bitwise = 0.0, {}, 0
    for m in range(TRAIN_POP):
        km = type(k_pop)(*(x[m] for x in k_pop))
        pm = type(p_pop)(*(x[m] for x in p_pop))
        viol = mk.mean_parity_violations(km, pm,
                                         mk.NEURAL_MEAN_PARITY_TOLERANCES)
        if viol:
            fail(f"11b: member {m} of the population launch and its plain "
                 f"version disagree: {viol}")
        n_bitwise += bitwise(km, pm)
        pop_abs = max(pop_abs, per_cluster_share(km, pm)[3])
        rel = mean_rel(km, pm)
        for f, v in rel.items():
            worst[f] = max(worst.get(f, 0.0), v)
    f_max = max(worst, key=worst.get)
    log(f"#   population launch vs population_plain_summary at "
        f"T={T_POP} ({pop_plain_s:.3f} s plain): {TRAIN_POP} members "
        f"within NEURAL_MEAN_PARITY_TOLERANCES, {n_bitwise} bitwise; "
        f"largest batch-mean rel diff {f_max} {worst[f_max]:.3g}; max abs "
        f"diff {pop_abs:.4g}")
    views = mk.unpack_exo(d0.worlds, T_POP, Zm)
    bars = {}
    for name, entry, fn in (
            ("rule", lambda: mk.megakernel_summary_from_packed(
                params, off, peak, d0.worlds, T_POP, d0.world_seed),
             rule_fn(cfg)),
            ("carbon", lambda: mk.carbon_megakernel_summary_from_packed(
                params, off, peak, d0.worlds, T_POP, d0.world_seed),
             carbon_fn(cfg))):
        p, p_s = synced(lambda: plain(cfg, params, views, d0.world_seed,
                                      True, fn))
        same, max_abs = hold(f"11b {name} bar G={TRAIN_G} T={T_POP}",
                             entry(), p, True)
        bars[name] = {"bitwise": same, "max_abs_err": max_abs,
                      "plain_s": p_s}
    del views, k_pop, p_pop

    # The generation's stages on the card, timed alone.
    buf = torch.empty_like(d0.worlds)
    synth_ms = float(np.median(cuda_ms(lambda: src.packed_trace_device(
        T_DAY, 7, TRAIN_G, out=buf, device=dev), N_TIMED)))
    rule_ms = median_ms(lambda: mk.megakernel_summary_from_packed(
        params, off, peak, d0.worlds, T_DAY, d0.world_seed))
    carbon_ms = median_ms(lambda: mk.carbon_megakernel_summary_from_packed(
        params, off, peak, d0.worlds, T_DAY, d0.world_seed))
    pop_ms = median_ms(lambda: mk.neural_megakernel_summary_from_packed(
        params, cfg.cluster, stacked, d0.worlds, T_DAY, d0.world_seed))
    F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools, Z=Zm)[0]
    weight_bytes = (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4
    cells = TRAIN_POP * TRAIN_G * T_DAY
    pop_bound = bound(
        rollout_bytes(Zm, TRAIN_G, T_DAY) + (TRAIN_POP - 1) * OUT_ROWS
        * TRAIN_G * 4 + TRAIN_POP * weight_bytes,
        {"tick": (float_ops_per_cluster_tick(cfg, True, "mlp", net) * cells,
                  F32_UNFUSED_OPS_PER_S, "float32"),
         "torso": (2 * (F * H + H * H) * cells, BF16_TENSOR_OPS_PER_S,
                   "tensor cores"),
         "head": (2 * H * A * cells, F32_OPS_PER_S, "float32")})
    gen_s = cem_s / CEM_GENS
    host_s = gen_s - (synth_ms + rule_ms + carbon_ms + pop_ms) / 1e3
    rec["cem"] = {
        "generations": CEM_GENS, "wall_s": cem_s, "generation_s": gen_s,
        "synthesis_ms": synth_ms, "rule_ms": rule_ms,
        "carbon_ms": carbon_ms, "population_ms": pop_ms,
        "host_s": host_s, "launches": cem_launches,
        "population_bound_ms": pop_bound[0],
        "population_bound_by": pop_bound[1],
        "population_plain_s": pop_plain_s,
        "population_max_abs_err": pop_abs,
        "population_bitwise_members": n_bitwise, "bars": bars,
        "history": chist}
    log(f"#   a generation {gen_s:.3f} s: synthesis {synth_ms:.4f} ms, "
        f"rule {rule_ms:.4f} ms, carbon {carbon_ms:.4f} ms, population "
        f"{pop_ms:.4f} ms (median of {N_TIMED}; bound {pop_bound[0]:.4f} ms,"
        f" {pop_bound[1]}; terms in ms {pop_bound[2]}; {TRAIN_POP} x "
        f"{TRAIN_G} = {TRAIN_POP * TRAIN_G // 32} warps), host and the "
        f"rest {host_s:.3f} s")
    del draws, d0, buf, stacked
    torch.cuda.empty_cache()

    # 11c: PPO at the config's batch and window.
    trainer = PPOTrainer(cfg, device=dev)
    ts = trainer.fresh_state(best, TRAIN_SEED)
    t_len = cfg.train.unroll_steps
    windows = trainer.make_windows(src, PPO_ITERS, seed=TRAIN_SEED)
    ppo_s = []
    for it in range(PPO_ITERS):
        (ts, diag), secs = synced(lambda: trainer.iteration(
            ts, windows.slice_steps(it * t_len, t_len + 1)))
        ppo_s.append(secs)
        d = {k: float(v) for k, v in diag._asdict().items()}
        if not all(np.isfinite(list(d.values()))):
            fail(f"11c: PPO iteration {it} diagnostics not finite: {d}")
    rec["ppo"] = {"batch": cfg.train.batch_clusters, "window": t_len,
                  "iteration_s": ppo_s, "last": d}
    log(f"# 11c PPO B={cfg.train.batch_clusters} x T={t_len}: iterations "
        f"{[round(x, 4) for x in ppo_s]} s; last diagnostics {d}")
    del trainer, ts, windows

    # 11d: one factory cell at its defaults.
    scen = resolve_scenarios([FACTORY_SCENARIO])[FACTORY_SCENARIO]
    for counter in (build.launch_rollout_profiles, build.launch_rollout_plan):
        counter.launches.clear()
    zero_counters()
    cell, cell_s = synced(lambda: factory.produce_cell(
        cfg, scen, FACTORY_INTENSITY, seed=TRAIN_SEED, device=dev))
    carry = {"rollout_profiles_kernel" + k: v for counter in (
        build.launch_rollout_profiles, build.launch_rollout_plan)
        for k, v in counter.launches.items()}
    if not any("PLAN" in k and "CARRY" in k for k in carry) or not any(
            "PLAN" not in k and "CARRY" in k for k in carry):
        fail(f"11d: the factory's playback launched no plan and rule CARRY "
             f"instantiation: {carry}")
    rp = cell.report
    fsrc = factory._cell_source(cfg, scen, FACTORY_INTENSITY)
    kw = dict(key=TRAIN_SEED, batch=rp["pairs"], T=rp["steps"],
              block_T=rp["block_T"], seed=TRAIN_SEED, t_chunk=rp["t_chunk"],
              device=dev)
    n_blocks = rp["playback"]["n_blocks"]
    plan_packed = mk.pack_plan(latent_to_action(cell.plan_latents,
                                                cfg.cluster),
                               n_blocks * rp["block_T"])
    ref_play = stm.unblocked_reference_summary(
        fsrc, params, cfg.cluster, "plan", plan_packed=plan_packed, **kw)
    ref_rule = stm.unblocked_reference_summary(fsrc, params, cfg.cluster,
                                               "rule", **kw)
    if not (bitwise(cell.teacher_summary, ref_play)
            and bitwise(cell.rule_summary, ref_rule)):
        fail("11d: the factory's streamed labels differ from the unblocked "
             "references")
    for f in ("obs", "target", "returns"):
        if not torch.isfinite(getattr(cell.dataset, f)).all():
            fail(f"11d: dataset {f} not finite")
    naive, naive_s = synced(lambda: factory.naive_lax_pair_rate(
        cfg, scen, FACTORY_INTENSITY, pairs=NAIVE_PAIRS, steps=NAIVE_STEPS,
        block_T=rp["block_T"], t_chunk=rp["t_chunk"], seed=TRAIN_SEED,
        warm=False, device=dev))
    if naive["mpc_horizon"] != min(cfg.train.mpc_horizon, rp["steps"]):
        fail(f"11d: the shortened naive pair plans another horizon: {naive}")
    # A pair of rp["steps"] ticks runs steps/NAIVE_STEPS times the
    # segments timed, each the same plan over the same horizon.
    naive_pair_s = naive["wall_s"] / NAIVE_PAIRS * rp["steps"] / NAIVE_STEPS
    ratio = rp["pairs_per_sec"] * naive_pair_s
    rec["factory"] = {"report": {k: v for k, v in rp.items()
                                 if k != "playback_occupancy"},
                      "wall_s": cell_s, "launches": carry, "naive": naive,
                      "naive_pair_s": naive_pair_s, "ratio_to_naive": ratio,
                      "bitwise_references": True}
    log(f"# 11d factory cell {FACTORY_SCENARIO}/{FACTORY_INTENSITY} "
        f"{rp['pairs']} pairs x {rp['steps']} ticks in blocks of "
        f"{rp['block_T']}: {cell_s:.3f} s (gen {rp['gen_s']}, plan "
        f"{rp['plan_s']}, label {rp['label_s']}, collect "
        f"{rp['collect_s']}); {rp['pairs_per_sec']} pairs/s against the "
        f"naive per-pair loop's {1 / naive_pair_s:.4f} ({NAIVE_PAIRS} pair "
        f"of {NAIVE_STEPS} ticks in {naive['wall_s']} s ({naive_s:.3f} s "
        f"fenced), {naive_pair_s:.3f} s for {rp['steps']} ticks; no "
        f"warm-up pair: the planner ran just before): x{ratio:.2f}; CARRY "
        f"launches {carry}; playback and rule column bitwise the unblocked "
        f"references")
    del cell, ref_play, ref_rule

    # 11e: train_flagship end to end through main, saved and loaded back.
    path = "runs/chip_smoke_flagship_multiregion.npz"
    runlog = "runs/chip_smoke_flagship_multiregion.jsonl"
    if os.path.exists(runlog):
        os.remove(runlog)
    zero_counters()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, flag_s = synced(lambda: flagship.main([
            "--preset", "multiregion", "--init-from", "distill:carbon",
            "--refine", "cem", "--cem-engine", "mega",
            "--iterations", str(FLAGSHIP_GENS), "--eval-steps", str(T_DAY),
            "--traces", str(N_SELECT), "--distill-iterations",
            str(FLAGSHIP_DISTILL), "--seed", str(TRAIN_SEED), "--out", path,
            "--runlog", runlog]))
    flag_launches = read_counters()
    saved = json.loads(out.getvalue())
    back, meta = load_params_npz(saved["checkpoint"])   # verifies the digest
    if (rc != 0 or meta["cem_engine"] != "mega"
            or meta[PARAMS_DIGEST_KEY] != params_digest(back)):
        fail(f"11e: train_flagship's checkpoint does not check: rc {rc}, "
             f"meta {meta}")
    for name in ("rollout_profiles_kernel", "rollout_profiles_kernel<CARBON>",
                 "rollout_mlp_kernel"):
        if flag_launches[name] != FLAGSHIP_GENS:
            fail(f"11e: train_flagship launched {name} "
                 f"{flag_launches[name]} times in {FLAGSHIP_GENS} "
                 f"generations")
    # The run log's clock: the init candidate's selection evaluation (a
    # PPOBackend on N_SELECT full days, eager) is the span between the
    # teacher's note and the first "eval" event.
    recs = read_runlog(runlog)
    t_teacher = next(r["elapsed_s"] for r in recs
                     if r["event"] == "note" and r["msg"].startswith(
                         "teacher"))
    t_eval0 = next(r["elapsed_s"] for r in recs if r["event"] == "eval")
    rec["selection_eval_s"] = t_eval0 - t_teacher
    rec["flagship"] = {"wall_s": flag_s, "launches": flag_launches,
                       "selected_iteration": meta["selected_iteration"],
                       "wins_both": meta["wins_both"],
                       "scoreboard": meta["selection_scoreboard"]}
    log(f"# 11e train_flagship (distill:carbon {FLAGSHIP_DISTILL} "
        f"iterations, cem mega {FLAGSHIP_GENS} generations, selection "
        f"{N_SELECT} x {T_DAY}) through main: {flag_s:.3f} s; launches "
        f"{flag_launches}; saved and loaded back, digest "
        f"{meta[PARAMS_DIGEST_KEY][:12]} checks; selected iteration "
        f"{meta['selected_iteration']}, wins_both {meta['wins_both']}; a "
        f"selection evaluation ({N_SELECT} x {T_DAY} ticks, eager) "
        f"{rec['selection_eval_s']:.3f} s by its run log")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"# 11: {rec['seconds']:.1f} s")
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import (RulePolicy, offpeak_action,
                                            peak_action)
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import random as prandom
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            initial_state)
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def clock(phase: str) -> None:
        """The run's clock at the start of a phase: where its time goes."""
        log(f"# clock {time.perf_counter() - t_start:.1f} s: phase {phase}")

    clock("1")
    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    log(f"# card: {smi}")
    log(f"# device: {props.name}, {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.1f} GiB, capability "
        f"{props.major}.{props.minor}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    clock("2")
    # ---- 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    profiles = ProfileBuilds()
    build_s = time.perf_counter() - t0
    log(f"# build: {build_s:.2f} s wall, {len(built)} nvcc processes")
    for unit, (lib, text, secs) in built.items():
        log(f"#   {unit} -> {lib.name} ({secs:.2f} s nvcc)")
        entry = None
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"#   ptxas: {line.strip()}")
            if "Compiling entry function" in line:
                entry = profile_key(line)
            elif entry is not None and "Used" in line and "registers" in line:
                profiles.regs[entry] = int(line.split("Used")[1].split()[0])
        build.library(*unit)
        for fn, counts in build.sass_summary(lib).items():
            log(f"#   sass: {fn}: {counts}")
            key = profile_key(fn)
            if unit[0] == "rollout_mlp.cu" and counts["HMMA"] < 1:
                fail(f"{fn} in {lib.name} runs no tensor-core instruction")
            if key is not None:
                profiles.loop[key] = counts["loop"]
                if counts["SHFL"] < 1:
                    fail(f"{fn} in {lib.name} exchanges nothing between "
                         f"lanes: the pair layout is absent")
    if len(profiles.loop) != 96 or set(profiles.loop) != set(profiles.regs):
        fail(f"phase 2 found {len(profiles.loop)} rollout_profiles_kernel "
             f"instantiations in the SASS and {len(profiles.regs)} in the "
             f"ptxas lines, not 96")

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    clock("3")
    # ---- 3. Philox: the kernel against the torch stream, bitwise. The
    # first grid is one tick of the rule path's draws (B_MAIN x 6 rows).
    def philox_plain(seed, nb, tick0, nt, nr):
        ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
        return prandom.uniforms(seed, ar(nb)[None, None, :],
                                (tick0 + ar(nt))[:, None, None],
                                ar(nr)[None, :, None])

    checks = [(7, B_MAIN, 0, 1, 6), (2**40 + 3, 97, 2**20, 33, 8)]
    prandom.uniform_grid.launches = 0
    philox_abs = 0.0
    for seed, nb, tick0, nt, nr in checks:
        got = prandom.uniform_grid(seed, nb, tick0, nt, nr, dev)
        want = philox_plain(seed, nb, tick0, nt, nr)
        philox_abs = max(philox_abs, float((got - want).abs().max()))
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"philox kernel differs from the torch stream in {bad} of "
                 f"{got.numel()} values (seed {seed})")
        log(f"# philox: {got.numel()} uniforms bitwise equal (seed {seed}, "
            f"{nb} clusters x {nt} ticks from {tick0} x {nr} rows)")
    philox_launches = prandom.uniform_grid.launches
    if philox_launches != len(checks):
        fail(f"philox check launched the kernel {philox_launches} times, "
             f"expected {len(checks)}")
    ph_args = checks[0]
    ph_ms = float(np.median(cuda_ms(
        lambda: prandom.uniform_grid(*ph_args, dev), 20)))
    ph_plain_ms = float(np.median(cuda_ms(
        lambda: philox_plain(*ph_args), 20)))
    ph_n = 3 * ph_args[1] * ph_args[3] * ph_args[4]  # uniforms written
    ph_bound, ph_by, _ = bound(
        ph_n * 4, {"conversion": (2 * ph_n, F32_UNFUSED_OPS_PER_S, "float32")})

    def setup(preset: str, variant: str = ""):
        cfg = PRESETS[preset]()
        src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                    cfg.signals)
        backend, _ = load_flagship_backend(cfg, variant=variant, device=dev)
        return (cfg, src, SimParams.from_config(cfg, device=dev),
                offpeak_action(cfg.cluster, dev),
                peak_action(cfg.cluster, dev),
                None if backend is None else backend.params)

    def plain(cfg, params, traces, seed, stochastic, action_fn):
        B = traces.is_peak.shape[0]
        return batched_rollout_summary(
            params, initial_state(cfg, B, dev), action_fn, traces, seed,
            stochastic=stochastic)[1]

    def rule_fn(cfg):
        return RulePolicy(cfg.cluster, dev).action_fn()

    def carbon_fn(cfg, **constants):
        return CarbonAwarePolicy(cfg.cluster, device=dev,
                                 **constants).action_fn()

    def hold(tag: str, k, p, stochastic: bool) -> tuple[bool, float]:
        """Phase 4's standard for a kernel result against its plain
        version; returns (bitwise, largest absolute difference)."""
        torch.cuda.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        same = bitwise(k, p)
        log(f"# parity {tag}: bitwise {same}; {share * 100:.4f} % "
            f"of clusters within 2e-3 on every field; worst field {worst} "
            f"(rel {worst_rel:.3g}); max abs diff {max_abs:.4g}")
        if stochastic:
            viol = mk.mean_parity_violations(k, p)
            log(f"#   mean_parity_violations: {viol}")
            if viol or share < 0.99:
                fail(f"stochastic parity ({tag})")
        else:
            rel = mean_rel(k, p)
            f_max = max(rel, key=rel.get)
            log(f"#   largest batch-mean rel diff: {f_max} {rel[f_max]:.3g}")
            if rel[f_max] > 1e-4 or share < 0.999:
                fail(f"deterministic parity ({tag})")
        return same, max_abs

    counters = {
        "rollout_profiles_kernel": mk.megakernel_summary_from_packed,
        "rollout_profiles_kernel<CARBON>":
            mk.carbon_megakernel_summary_from_packed,
        "rollout_mlp_kernel": mk.neural_megakernel_summary_from_packed,
        "plan entry": mk.plan_megakernel_summary_from_packed,
        "philox_uniform_kernel": prandom.uniform_grid,
    }

    def zero_counters() -> None:
        for entry in counters.values():
            entry.launches = 0

    def read_counters() -> dict:
        return {name: entry.launches for name, entry in counters.items()}

    clock("4")
    # ---- 4. rule and carbon kernels against their plain versions
    def parity(preset: str, B: int, modes, T: int = T_DAY) -> None:
        cfg, src, params, off, peak, _ = setup(preset)
        traces = src.batch_trace_device(T, gen(23), B, device=dev)
        for stochastic in modes:
            tag = (f"{preset} B={B} T={T} "
                   f"{'stochastic' if stochastic else 'deterministic'}")
            hold(f"rule {tag}",
                 mk.megakernel_rollout_summary(
                     params, off, peak, traces, seed=9,
                     stochastic=stochastic, device=dev),
                 plain(cfg, params, traces, 9, stochastic, rule_fn(cfg)),
                 stochastic)
            hold(f"carbon {tag}",
                 mk.carbon_megakernel_rollout_summary(
                     params, off, peak, traces, seed=9,
                     stochastic=stochastic, device=dev),
                 plain(cfg, params, traces, 9, stochastic, carbon_fn(cfg)),
                 stochastic)
        del traces
        torch.cuda.empty_cache()

    parity("default", B_PARITY, (False, True), T_PARITY)
    parity("multiregion", B_MULTI, (False, True), T_PARITY)

    clock("4b")
    # ---- 4b. the plan kernel: see plan_phase.
    plan_rec = plan_phase(dev, setup, hold, profiles)

    # The carbon constants reach the kernel, each in its place.
    cfg, src, params, off, peak, _ = setup("multiregion")
    traces = src.batch_trace_device(T_DAY // 10, gen(29), B_MULTI,
                                    device=dev)
    base = mk.carbon_megakernel_rollout_summary(
        params, off, peak, traces, seed=9, stochastic=False, device=dev)
    other = mk.carbon_megakernel_rollout_summary(
        params, off, peak, traces, seed=9, stochastic=False, device=dev,
        **CARBON_OTHER)
    hold(f"carbon {CARBON_OTHER} multiregion B={B_MULTI} T={T_DAY // 10}",
         other, plain(cfg, params, traces, 9, False,
                      carbon_fn(cfg, **CARBON_OTHER)), False)
    moved = float((base.carbon_kg - other.carbon_kg).abs().max())
    log(f"#   the constants change carbon_kg by up to {moved:.4g} kg")
    if moved <= 0:
        fail("the carbon constants do not reach the kernel")

    clock("5")
    # ---- 5. the MLP kernel against its plain version
    def mlp_plain(cfg, params, net, traces, seed, stochastic):
        return plain(cfg, params, traces, seed, stochastic,
                     mk.kernel_numerics_action_fn(net, cfg.cluster, params))

    def mlp_short(preset: str, variant: str) -> None:
        cfg, src, params, _, _, net = setup(preset, variant)
        traces = src.batch_trace_device(T_SHORT, gen(41), B_MULTI, device=dev)
        k = mk.neural_megakernel_rollout_summary(
            params, cfg.cluster, net, traces, seed=9, stochastic=False,
            device=dev)
        p = mlp_plain(cfg, params, net, traces, 9, False)
        rel = field_rel(k, p)
        bad = {f: r for f, r in rel.items()
               if r > (SHORT_LOOSE_TOL if f in SHORT_LOOSE else SHORT_TOL)}
        worst = max(rel, key=rel.get)
        log(f"# mlp parity {preset} ({variant or 'flagship'}) B={B_MULTI} "
            f"T={T_SHORT} deterministic: bitwise {bitwise(k, p)}; largest "
            f"per-cluster rel diff {worst} {rel[worst]:.3g}")
        if bad:
            fail(f"mlp short-horizon parity ({preset}): {bad}")

    mlp_short("multiregion", "")
    mlp_short("default", "replay")

    cfg, src, params, off, peak, net = setup("multiregion")
    traces = src.batch_trace_device(T_PARITY, gen(43), B_PARITY, device=dev)
    for stochastic in (False, True):
        k = mk.neural_megakernel_rollout_summary(
            params, cfg.cluster, net, traces, seed=9, stochastic=stochastic,
            device=dev)
        p = mlp_plain(cfg, params, net, traces, 9, stochastic)
        torch.cuda.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        viol = mk.mean_parity_violations(k, p,
                                         mk.NEURAL_MEAN_PARITY_TOLERANCES)
        log(f"# mlp parity multiregion B={B_PARITY} T={T_PARITY} "
            f"{'stochastic' if stochastic else 'deterministic'}: bitwise "
            f"{bitwise(k, p)}; {share * 100:.4f} % of clusters within 2e-3; "
            f"worst field {worst} (rel {worst_rel:.3g}); max abs diff "
            f"{max_abs:.4g}; mean_parity_violations {viol}")
        if viol:
            fail("mlp full-day mean parity")
    del traces, k, p
    torch.cuda.empty_cache()

    traces = src.batch_trace_device(T_DAY // 10, gen(47), B_MULTI, device=dev)
    stacked = mk._tree_map(lambda x: np.stack([x, 0.5 * np.asarray(x)]), net)
    single = mk.neural_megakernel_rollout_summary(
        params, cfg.cluster, net, traces, seed=9, stochastic=True, device=dev)
    pop = mk.neural_megakernel_rollout_summary(
        params, cfg.cluster, stacked, traces, seed=9, stochastic=True,
        device=dev)
    if tuple(pop.cost_usd.shape) != (2, B_MULTI) \
            or tuple(single.cost_usd.shape) != (B_MULTI,):
        fail("population axis: wrong field shapes")
    if not all(torch.equal(getattr(pop, f)[0], getattr(single, f))
               for f in single._fields):
        fail("population axis: member 0 is not the single run")
    other_member = float((pop.cost_usd[1] - pop.cost_usd[0]).abs().max())
    log(f"# mlp population axis: fields [2, {B_MULTI}], member 0 bitwise "
        f"the single run, member 1 differs in cost_usd by up to "
        f"{other_member:.4g}")
    if other_member <= 0:
        fail("population axis: member 1 equals member 0")
    del traces, single, pop
    torch.cuda.empty_cache()

    clock("5b")
    # ---- 5b. the zero gates, 5c. the widened kernels: see lane_phases.
    lanes_found = lane_phases(dev, setup, hold)

    clock("5e")
    # ---- 5e. the MLP kernel's forward layer by layer: see forward_phase.
    forward_rec = forward_phase(dev, setup)

    clock("6")
    # ---- 6. the rule path at full size
    cfg, src, params, off, peak, _ = setup("default")
    Z = cfg.cluster.n_zones
    ops_tick = {s: float_ops_per_cluster_tick(cfg, s) for s in (False, True)}

    def rule_bound(B: int, ops: int):
        return bound(rollout_bytes(Z, B, T_DAY),
                     {"tick": (ops * B * T_DAY, F32_UNFUSED_OPS_PER_S,
                               "float32")})

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    zero_counters()
    events[0].record()
    traces = src.batch_trace_device(T_DAY, gen(31), B_MAIN, device=dev)
    events[1].record()
    k_main = mk.megakernel_rollout_summary(params, off, peak, traces,
                                           seed=5, stochastic=True,
                                           device=dev)
    events[2].record()
    events[2].synchronize()
    rule_launches = read_counters()
    synth_ms = events[0].elapsed_time(events[1])
    path_ms = events[1].elapsed_time(events[2])
    log(f"# rule path default B={B_MAIN} T={T_DAY} stochastic: launches "
        f"{rule_launches}; batch_trace_device {synth_ms:.4f} ms, "
        f"megakernel_rollout_summary {path_ms:.4f} ms")
    if rule_launches["rollout_profiles_kernel"] < 1:
        fail("the rule path never launched rollout_profiles_kernel")

    p_main = plain(cfg, params, traces, 5, True, rule_fn(cfg))
    events[3].record()
    events[3].synchronize()
    plain_ms = events[2].elapsed_time(events[3])
    share, worst, worst_rel, main_abs = per_cluster_share(k_main, p_main)
    viol = mk.mean_parity_violations(k_main, p_main)
    log(f"#   kernel vs plain ({plain_ms:.4f} ms): bitwise "
        f"{bitwise(k_main, p_main)}; {share * 100:.4f} % of clusters within "
        f"2e-3; worst {worst} (rel {worst_rel:.3g}); max abs diff "
        f"{main_abs:.4g}; mean_parity_violations {viol}")
    if viol or share < 0.99:
        fail("rule-path kernel and plain version disagree")
    for f in ("cost_usd", "usd_per_slo_hour", "slo_attainment"):
        v = getattr(k_main, f)
        if v.shape != (B_MAIN,) or not torch.isfinite(v).all():
            fail(f"rule-path field {f} malformed")
    log(f"#   fleet means: $/SLO-hr "
        f"{k_main.usd_per_slo_hour.mean().item():.6f}, gCO2/kreq "
        f"{k_main.g_co2_per_kreq.mean().item():.6f}, SLO attainment "
        f"{k_main.slo_attainment.mean().item():.6f}")

    def rule_ms(exo, stochastic: bool) -> float:
        return median_ms(lambda: mk.megakernel_summary_from_packed(
            params, off, peak, exo, T_DAY, seed=5, stochastic=stochastic))

    packed = []
    pack_ms = cuda_ms(lambda: packed.append(mk._pack_exo(traces, T_DAY)))[0]
    exo = packed.pop()
    del traces, p_main
    torch.cuda.empty_cache()
    k_ms = rule_ms(exo, True)
    k_bound, k_by, k_terms = rule_bound(B_MAIN, ops_tick[True])

    def rule_floor(B: int, exo, stochastic: bool) -> float:
        return profiles.issue_floor_ms(
            ("rule", Z, stochastic, False, 0, False), B, T_DAY,
            lambda: mk.megakernel_summary_from_packed(
                params, off, peak, exo, T_DAY, seed=5,
                stochastic=stochastic))

    k_floor = rule_floor(B_MAIN, exo, True)
    log(f"#   _pack_exo {pack_ms:.4f} ms; kernel {k_ms:.4f} ms median of "
        f"{N_TIMED}; bound {k_bound:.4f} ms ({k_by}; terms in ms {k_terms}; "
        f"{rollout_bytes(Z, B_MAIN, T_DAY)} bytes, {ops_tick[True]} float "
        f"ops per cluster-tick); issue floor {k_floor:.4f} ms "
        f"({profiles.loop[('rule', Z, True, False, 0, False)]} SASS "
        f"instructions a tick, {PAIR} lanes a cluster); "
        f"{B_MAIN / (k_ms / 1e3):.1f} cluster-days/s")
    del exo
    torch.cuda.empty_cache()

    clock("7")
    # ---- 7. the three-policy path at full size
    cfg, src, params, off, peak, net = setup("multiregion")
    Zm = cfg.cluster.n_zones
    F, H, A = mk._mlp_dims(net, P=cfg.cluster.n_pools, Z=Zm)[0]
    tick_ops = {name: float_ops_per_cluster_tick(cfg, True, name, net)
                for name in ("rule", "carbon", "mlp")}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    torch.cuda.synchronize()
    events[0].record()
    traces = src.batch_trace_device(T_DAY, gen(53), B_MAIN, device=dev)
    events[1].record()
    exo = mk._pack_exo(traces, T_DAY)
    events[2].record()
    del traces
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    zero_counters()
    events[3].record()
    board = {"rule": mk.megakernel_summary_from_packed(
        params, off, peak, exo, T_DAY, seed=5, stochastic=True)}
    events[4].record()
    board["carbon"] = mk.carbon_megakernel_summary_from_packed(
        params, off, peak, exo, T_DAY, seed=5, stochastic=True)
    events[5].record()
    board["flagship"] = mk.neural_megakernel_summary_from_packed(
        params, cfg.cluster, net, exo, T_DAY, seed=5, stochastic=True)
    events[6].record()
    events[6].synchronize()
    launches = read_counters()
    entry_ms = [events[i].elapsed_time(events[i + 1]) for i in range(3, 6)]
    log(f"# three-policy path multiregion B={B_MAIN} T={T_DAY} stochastic: "
        f"launches {launches}; batch_trace_device "
        f"{events[0].elapsed_time(events[1]):.4f} ms, _pack_exo "
        f"{events[1].elapsed_time(events[2]):.4f} ms; the entries (pack "
        f"of params and weights, launch, finalize) rule {entry_ms[0]:.4f} "
        f"ms, carbon {entry_ms[1]:.4f} ms, flagship {entry_ms[2]:.4f} ms")
    for name in ("rollout_profiles_kernel", "rollout_profiles_kernel<CARBON>",
                 "rollout_mlp_kernel"):
        if launches[name] < 1:
            fail(f"the three-policy path never launched {name}")
    for name, s in board.items():
        for f in ("usd_per_slo_hour", "g_co2_per_kreq", "slo_attainment"):
            v = getattr(s, f)
            if v.shape != (B_MAIN,) or not torch.isfinite(v).all():
                fail(f"three-policy field {name}.{f} malformed")
        log(f"#   {name}: $/SLO-hr {s.usd_per_slo_hour.mean().item():.6f}, "
            f"gCO2/kreq {s.g_co2_per_kreq.mean().item():.6f}, SLO "
            f"attainment {s.slo_attainment.mean().item():.6f}")

    # The plain versions on the stream's first T_PARITY ticks, against the
    # kernels re-run there.
    views = mk.unpack_exo(exo, T_PARITY, Zm)
    short = {
        "rule": mk.megakernel_summary_from_packed(
            params, off, peak, exo, T_PARITY, seed=5, stochastic=True),
        "carbon": mk.carbon_megakernel_summary_from_packed(
            params, off, peak, exo, T_PARITY, seed=5, stochastic=True),
        "flagship": mk.neural_megakernel_summary_from_packed(
            params, cfg.cluster, net, exo, T_PARITY, seed=5,
            stochastic=True)}
    checks7 = {}
    for name, action_fn, tol in (
            ("rule", rule_fn(cfg), None),
            ("carbon", carbon_fn(cfg), None),
            ("flagship", mk.kernel_numerics_action_fn(net, cfg.cluster,
                                                      params),
             mk.NEURAL_MEAN_PARITY_TOLERANCES)):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        p = plain(cfg, params, views, 5, True, action_fn)
        t1.record()
        t1.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(short[name], p)
        viol = mk.mean_parity_violations(short[name], p, tol)
        checks7[name] = (t0.elapsed_time(t1), max_abs)
        log(f"#   {name} kernel vs plain at T={T_PARITY} "
            f"({checks7[name][0]:.4f} ms): "
            f"bitwise {bitwise(short[name], p)}; {share * 100:.4f} % of "
            f"clusters within 2e-3; worst {worst} (rel {worst_rel:.3g}); "
            f"max abs diff {max_abs:.4g}; mean_parity_violations {viol}")
        if viol:
            fail(f"three-policy path: {name} kernel and plain version "
                 f"disagree")
        del p
    del views, short

    weight_bytes = (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4
    timed = {
        "rule": (
            lambda: mk.megakernel_summary_from_packed(
                params, off, peak, exo, T_DAY, seed=5, stochastic=True),
            bound(rollout_bytes(Zm, B_MAIN, T_DAY),
                  {"tick": (tick_ops["rule"] * B_MAIN * T_DAY,
                            F32_UNFUSED_OPS_PER_S, "float32")})),
        "carbon": (
            lambda: mk.carbon_megakernel_summary_from_packed(
                params, off, peak, exo, T_DAY, seed=5, stochastic=True),
            bound(rollout_bytes(Zm, B_MAIN, T_DAY),
                  {"tick": (tick_ops["carbon"] * B_MAIN * T_DAY,
                            F32_UNFUSED_OPS_PER_S, "float32")})),
        "flagship": (
            lambda: mk.neural_megakernel_summary_from_packed(
                params, cfg.cluster, net, exo, T_DAY, seed=5,
                stochastic=True),
            bound(rollout_bytes(Zm, B_MAIN, T_DAY,
                                weight_bytes=weight_bytes),
                  {"tick": (tick_ops["mlp"] * B_MAIN * T_DAY,
                            F32_UNFUSED_OPS_PER_S, "float32"),
                   "torso": (2 * (F * H + H * H) * B_MAIN * T_DAY,
                             BF16_TENSOR_OPS_PER_S, "tensor cores"),
                   "head": (2 * H * A * B_MAIN * T_DAY, F32_OPS_PER_S,
                            "float32")})),
    }
    main_ms, floors = {}, {}
    for name, (fn, (b_ms, b_by, terms)) in timed.items():
        main_ms[name] = (median_ms(fn), b_ms, b_by)
        floor = ""
        if name != "flagship":
            floors[name] = profiles.issue_floor_ms(
                (name, Zm, True, False, 0, False), B_MAIN, T_DAY, fn)
            floor = f"; issue floor {floors[name]:.4f} ms"
        log(f"#   {name} kernel {main_ms[name][0]:.4f} ms median of "
            f"{N_TIMED}; bound {b_ms:.4f} ms ({b_by}; terms in ms {terms}; "
            f"{tick_ops['mlp' if name == 'flagship' else name]} float ops "
            f"per cluster-tick outside the products){floor}; "
            f"{B_MAIN / (main_ms[name][0] / 1e3):.1f} cluster-days/s")
    del exo, board
    torch.cuda.empty_cache()

    clock("8")
    # ---- 8. the rule kernel across fleet sizes, on prefixes of one stream
    cfg, src, params, off, peak, _ = setup("default")
    traces = src.batch_trace_device(T_DAY, gen(37), max(SWEEP), device=dev)
    exo_all = mk._pack_exo(traces, T_DAY)
    del traces
    torch.cuda.empty_cache()
    for B in SWEEP:
        exo = exo_all[:, :, :B].contiguous()
        for stochastic in (False, True):
            ms = rule_ms(exo, stochastic)
            b_ms, b_by, _ = rule_bound(B, ops_tick[stochastic])
            key = ("rule", Z, stochastic, False, 0, False)
            log("# sweep " + json.dumps({
                "B": B, "T": T_DAY, "stochastic": stochastic, "ms": ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                "issue_floor_ms": rule_floor(B, exo, stochastic),
                "cluster_days_per_s": B / (ms / 1e3),
                "threads_per_cluster": PAIR,
                "warps_per_sm": PAIR * B / 32 / props.multi_processor_count,
                "resident_warps_per_sm": profiles.resident_warps_per_sm(
                    key, B),
                "registers": profiles.regs[key]}))
        del exo
    del exo_all
    torch.cuda.empty_cache()

    clock("9")
    # ---- 9. the fault and workload boards at full size: see board_phase.
    boards = board_phase(dev, setup, zero_counters, read_counters)
    torch.cuda.empty_cache()

    clock("10")
    # ---- 10. carried-state streaming: see carry_phase, streaming_phase.
    carry_found = carry_phase(dev, setup)
    stream_rec = streaming_phase(dev, setup, carry_found)

    clock("11")
    # ---- 11. the training path: see training_phase.
    train_rec = training_phase(dev, setup, hold, plain, rule_fn, carbon_fn,
                               zero_counters, read_counters)

    clock("12")
    # ---- 12. the kernels, the card, the result
    def train_paths(name: str) -> dict:
        return {"CEM generations (phase 11b)":
                    train_rec["cem"]["launches"][name],
                "train_flagship (phase 11e)":
                    train_rec["flagship"]["launches"][name]}

    kernels = [
        {"name": "rollout_profiles_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:1010",
         "launches": rule_launches["rollout_profiles_kernel"],
         "launches_by_path": {
             "rule path (phase 6)": rule_launches["rollout_profiles_kernel"],
             "three-policy path (phase 7)":
                 launches["rollout_profiles_kernel"],
             **train_paths("rollout_profiles_kernel")},
         "max_abs_err": main_abs, "ms": k_ms, "plain_ms": plain_ms,
         "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "issue_floor_ms": k_floor,
         "shape": f"default B={B_MAIN} T={T_DAY} stochastic (phase 6): "
                  f"launches, max_abs_err, ms, plain_ms and bound_ms are "
                  f"all of that path",
         "three_policy_path": {
             "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic "
                      f"(phase 7)",
             "launches": launches["rollout_profiles_kernel"],
             "max_abs_err": checks7["rule"][1], "ms": main_ms["rule"][0],
                 "plain_ms": checks7["rule"][0],
             "plain_shape": f"multiregion B={B_MAIN} T={T_PARITY}",
             "bound_ms": main_ms["rule"][1],
             "bound_by": main_ms["rule"][2],
             "issue_floor_ms": floors["rule"]}},
        {"name": "philox_uniform_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:228",
         "launches": philox_launches,
         "launches_from": "phase 3, the bitwise check: the kernel is on no "
                          "rollout path (0 launches in phases 6 and 7)",
         "launches_by_path": {
             "rule path (phase 6)": rule_launches["philox_uniform_kernel"],
             "three-policy path (phase 7)":
                 launches["philox_uniform_kernel"]},
         "max_abs_err": philox_abs, "ms": ph_ms, "plain_ms": ph_plain_ms,
         "bound_ms": ph_bound, "bound_by": ph_by, "library_ms": None},
        {"name": "rollout_profiles_kernel<CARBON>", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:456",
         "launches": launches["rollout_profiles_kernel<CARBON>"],
         "launches_by_path": {
             "three-policy path (phase 7)":
                 launches["rollout_profiles_kernel<CARBON>"],
             **train_paths("rollout_profiles_kernel<CARBON>")},
         "max_abs_err": checks7["carbon"][1], "ms": main_ms["carbon"][0],
         "plain_ms": checks7["carbon"][0], "bound_ms": main_ms["carbon"][1],
         "bound_by": main_ms["carbon"][2], "library_ms": None,
         "issue_floor_ms": floors["carbon"],
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic (phase 7)",
         "plain_shape": f"multiregion B={B_MAIN} T={T_PARITY}"},
        {"name": "rollout_mlp_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_mlp.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:1144",
         "launches": launches["rollout_mlp_kernel"],
         "launches_by_path": {
             "three-policy path (phase 7)": launches["rollout_mlp_kernel"],
             **train_paths("rollout_mlp_kernel")},
         "population_launch": {
             "shape": f"multiregion NP={TRAIN_POP} members x G={TRAIN_G} "
                      f"traces x T={T_DAY} stochastic, a CEM generation "
                      f"(phase 11b)",
             "launches": train_rec["cem"]["launches"]["rollout_mlp_kernel"],
             "ms": train_rec["cem"]["population_ms"],
             "bound_ms": train_rec["cem"]["population_bound_ms"],
             "bound_by": train_rec["cem"]["population_bound_by"],
             "plain_ms": train_rec["cem"]["population_plain_s"] * 1e3,
             "plain_shape": f"NP={TRAIN_POP} x G={TRAIN_G} x T={T_POP}",
             "max_abs_err": train_rec["cem"]["population_max_abs_err"]},
         "max_abs_err": checks7["flagship"][1],
         "ms": main_ms["flagship"][0], "plain_ms": checks7["flagship"][0],
         "bound_ms": main_ms["flagship"][1],
         "bound_by": main_ms["flagship"][2], "library_ms": None,
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic, F={F} "
                  f"H={H} A={A}, one member (phase 7)",
         "plain_shape": f"multiregion B={B_MAIN} T={T_PARITY}"},
        forward_rec,
        {"name": "rollout_profiles_kernel<PLAN>", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": PLAN_REPLACES,
         "launches": plan_rec["launches"],
         "launches_from": "phase 4b, its checks: the boards' streams carry "
                          "lanes, so their mpc rows run the lane "
                          "instantiations below, and the factory's "
                          "playback (phase 11d) the CARRY ones",
         "launches_by_path": {
             "factory playback (phase 11d), by instantiation":
                 {k: v for k, v in train_rec["factory"]["launches"].items()
                  if "PLAN" in k}},
         "max_abs_err": plan_rec["max_abs_err"], "ms": plan_rec["ms"],
         "plain_ms": plan_rec["plain_ms"], "bound_ms": plan_rec["bound_ms"],
         "bound_by": plan_rec["bound_by"], "library_ms": None,
         "issue_floor_ms": plan_rec["issue_floor_ms"],
         "bitwise": plan_rec["bitwise"],
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic, a random "
                  f"per-cluster plan (phase 4b)",
         "plain_shape": f"multiregion B={B_MULTI} T={T_PARITY} stochastic"},
    ] + lane_kernel_rows(boards, lanes_found) + carry_kernel_rows(
        carry_found, stream_rec)
    log(f"# build {build_s:.2f} s; total {time.perf_counter() - t_start:.1f}"
        f" s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
