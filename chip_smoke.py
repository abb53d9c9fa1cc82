"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Two main paths. The rule-profile fleet rollout: a batch of clusters gets
one simulated day (T = 2880 ticks of 30 s) of synthetic price, carbon and
demand signals, is stepped under the Peak/Off-Peak rule, and is folded
into one EpisodeSummary per cluster. The three-policy scoreboard: the
rule, the carbon teacher and the shipped learned flagship scored on one
packed multiregion fleet-day, paired world for world. Phases, in order;
any failure ends the run with a nonzero exit code:

1. the card: nvidia-smi's name and power limit, device properties;
2. build every CUDA source with nvcc (all started together);
3. philox_uniform_kernel against `sim/random.uniforms`, bitwise. This
   kernel is on no rollout path (the rollout kernels inline the same
   device function); its launch count is this phase's;
4. default preset, B = 8192 x T = 2880, deterministic and stochastic, and
   multiregion preset, B = 1024, deterministic over T = 2880 and
   stochastic over T = 720 (phase 7 holds that mode over the whole day):
   the rule kernel and the carbon kernel, each against its plain version (deterministic:
   batch means within 1e-4 relative, at least 99.9 % of clusters within
   2e-3 on every field; stochastic: `mean_parity_violations` empty, at
   least 99 % of clusters within 2e-3), with whether they are bitwise
   equal; then the carbon kernel with other constants (sharpness 40,
   min_weight 0.2, stickiness 0) against the plain version under the same
   constants, and that they change `carbon_kg`;
5. the MLP kernel against `kernel_numerics_action_fn`: (a) the shipped
   multiregion flagship, B = 1024 x T = 32, deterministic, every field's
   largest per-cluster relative difference within 1e-3 (five near-zero-
   denominator fields 2e-2); (d) the same with the replay checkpoint on
   the default preset; (b) multiregion B = 8192 x T = 2880, both modes,
   `mean_parity_violations(..., NEURAL_MEAN_PARITY_TOLERANCES)` empty;
   (c) two stacked members: member 0 bitwise the single run, member 1
   (weights halved) another policy;
6. the rule path at default B = 32768 x T = 2880, stochastic: trace
   synthesis and `megakernel_rollout_summary`, with the launch counters
   zeroed just before and read just after; then the plain version on the
   same traces, held against it; the pack's and the kernel's time;
7. the three-policy path at multiregion B = 32768 x T = 2880, stochastic:
   trace synthesis, one `_pack_exo`, then the rule, carbon and neural
   `*_summary_from_packed` entries on that stream and seed, with all
   launch counters zeroed just before and read just after, before any
   plain version runs; then all three results held against their plain
   versions on the same stream; the three policies' fleet means;
   each kernel's median time of 5 launches, its bound and cluster-days/s;
8. the rule kernel's time across fleet sizes B = 8192 ... 65536, both
   modes, against its bound and the warps per SM the launch gives;
9. one JSON line listing every kernel, the card's line, and the result.

The bound of a call is the larger of its bytes (each input row the kernel
reads, once, its weights and its output) over HBM's rate and its
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


def rollout_bytes(Z: int, B: int, T: int, weight_bytes: int = 0) -> int:
    """Bytes a rollout kernel must move: the 3Z+3 stream rows it reads
    (spot, od, carbon per zone, two demands, is_peak; not the padding
    rows) once per tick, its weights, and its [24, B] output."""
    return ((3 * Z + 3) * T + OUT_ROWS) * B * 4 + weight_bytes


def float_ops_per_cluster_tick(cfg, stochastic: bool, policy: str = "rule",
                               net_params=None) -> int:
    """Floating-point pointwise operations of one tick of the plain step
    for one cluster under ``policy`` (with its uniforms' conversion in
    stochastic mode), counted by dispatching it on the CPU. The MLP's
    chained products (`addcmul`) are left out: the bound counts them from
    the layer widths."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.dynamics import ExoStep, step
    from ccka_tpu_torch.sim.random import uniforms
    from ccka_tpu_torch.sim.rollout import initial_state
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

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
    }[policy]()
    Count.n = 0
    with Count():
        u3 = (uniforms(0, torch.zeros((1, 1), dtype=torch.int64), 0,
                       torch.arange(P * Z)[None, :]).reshape(3, 1, P, Z)
              if stochastic else None)
        action = action_fn(state, exo, 0)
        step(params, state, action, exo, u3, stochastic=stochastic)
    return Count.n


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

    # ---- 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"# build: {time.perf_counter() - t0:.2f} s wall")
    for src, (lib, text, secs) in built.items():
        log(f"#   {src} -> {lib.name} ({secs:.2f} s nvcc)")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"#   ptxas: {line.strip()}")
        build.library(src)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

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

    def hold(tag: str, k, p, stochastic: bool) -> None:
        """Phase 4's standard for a kernel result against its plain
        version."""
        torch.cuda.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        log(f"# parity {tag}: bitwise {bitwise(k, p)}; {share * 100:.4f} % "
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

    parity("default", B_PARITY, (False, True))
    parity("multiregion", B_MULTI, (False,))
    parity("multiregion", B_MULTI, (True,), T_DAY // 4)

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
    traces = src.batch_trace_device(T_DAY, gen(43), B_PARITY, device=dev)
    for stochastic in (False, True):
        k = mk.neural_megakernel_rollout_summary(
            params, cfg.cluster, net, traces, seed=9, stochastic=stochastic,
            device=dev)
        p = mlp_plain(cfg, params, net, traces, 9, stochastic)
        torch.cuda.synchronize()
        share, worst, worst_rel, max_abs = per_cluster_share(k, p)
        viol = mk.mean_parity_violations(k, p,
                                         mk.NEURAL_MEAN_PARITY_TOLERANCES)
        log(f"# mlp parity multiregion B={B_PARITY} T={T_DAY} "
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

    counters = {
        "rollout_profiles_kernel": mk.megakernel_summary_from_packed,
        "rollout_profiles_kernel<CARBON>":
            mk.carbon_megakernel_summary_from_packed,
        "rollout_mlp_kernel": mk.neural_megakernel_summary_from_packed,
        "philox_uniform_kernel": prandom.uniform_grid,
    }

    def zero_counters() -> None:
        for entry in counters.values():
            entry.launches = 0

    def read_counters() -> dict:
        return {name: entry.launches for name, entry in counters.items()}

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
    log(f"#   _pack_exo {pack_ms:.4f} ms; kernel {k_ms:.4f} ms median of "
        f"{N_TIMED}; bound {k_bound:.4f} ms ({k_by}; terms in ms {k_terms}; "
        f"{rollout_bytes(Z, B_MAIN, T_DAY)} bytes, {ops_tick[True]} float "
        f"ops per cluster-tick); {B_MAIN / (k_ms / 1e3):.1f} cluster-days/s")
    del exo
    torch.cuda.empty_cache()

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

    views = mk.unpack_exo(exo, T_DAY, Zm)
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
        share, worst, worst_rel, max_abs = per_cluster_share(board[name], p)
        viol = mk.mean_parity_violations(board[name], p, tol)
        checks7[name] = (t0.elapsed_time(t1), max_abs)
        log(f"#   {name} kernel vs plain ({checks7[name][0]:.4f} ms): "
            f"bitwise {bitwise(board[name], p)}; {share * 100:.4f} % of "
            f"clusters within 2e-3; worst {worst} (rel {worst_rel:.3g}); "
            f"max abs diff {max_abs:.4g}; mean_parity_violations {viol}")
        if viol:
            fail(f"three-policy path: {name} kernel and plain version "
                 f"disagree")
        del p
    del views

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
    main_ms = {}
    for name, (fn, (b_ms, b_by, terms)) in timed.items():
        main_ms[name] = (median_ms(fn), b_ms, b_by)
        log(f"#   {name} kernel {main_ms[name][0]:.4f} ms median of "
            f"{N_TIMED}; bound {b_ms:.4f} ms ({b_by}; terms in ms {terms}; "
            f"{tick_ops['mlp' if name == 'flagship' else name]} float ops "
            f"per cluster-tick outside the products); "
            f"{B_MAIN / (main_ms[name][0] / 1e3):.1f} cluster-days/s")
    del exo, board
    torch.cuda.empty_cache()

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
            log("# sweep " + json.dumps({
                "B": B, "T": T_DAY, "stochastic": stochastic, "ms": ms,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                "cluster_days_per_s": B / (ms / 1e3),
                "warps_per_sm": B / 32 / props.multi_processor_count}))
        del exo
    del exo_all
    torch.cuda.empty_cache()

    # ---- 9. the kernels, the card, the result
    kernels = [
        {"name": "rollout_profiles_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_profiles.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:1010",
         "launches": rule_launches["rollout_profiles_kernel"],
         "launches_by_path": {
             "rule path (phase 6)": rule_launches["rollout_profiles_kernel"],
             "three-policy path (phase 7)":
                 launches["rollout_profiles_kernel"]},
         "max_abs_err": main_abs, "ms": k_ms, "plain_ms": plain_ms,
         "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "shape": f"default B={B_MAIN} T={T_DAY} stochastic (phase 6): "
                  f"launches, max_abs_err, ms, plain_ms and bound_ms are "
                  f"all of that path",
         "three_policy_path": {
             "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic "
                      f"(phase 7)",
             "launches": launches["rollout_profiles_kernel"],
             "max_abs_err": checks7["rule"][1], "ms": main_ms["rule"][0],
             "plain_ms": checks7["rule"][0], "bound_ms": main_ms["rule"][1],
             "bound_by": main_ms["rule"][2]}},
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
         "max_abs_err": checks7["carbon"][1], "ms": main_ms["carbon"][0],
         "plain_ms": checks7["carbon"][0], "bound_ms": main_ms["carbon"][1],
         "bound_by": main_ms["carbon"][2], "library_ms": None,
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic (phase 7)"},
        {"name": "rollout_mlp_kernel", "route": "cuda",
         "source": "ccka_tpu_torch/csrc/rollout_mlp.cu",
         "replaces": "ccka_tpu/sim/megakernel.py:1144",
         "launches": launches["rollout_mlp_kernel"],
         "max_abs_err": checks7["flagship"][1],
         "ms": main_ms["flagship"][0], "plain_ms": checks7["flagship"][0],
         "bound_ms": main_ms["flagship"][1],
         "bound_by": main_ms["flagship"][2], "library_ms": None,
         "shape": f"multiregion B={B_MAIN} T={T_DAY} stochastic, F={F} "
                  f"H={H} A={A}, one member (phase 7)"},
    ]
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
