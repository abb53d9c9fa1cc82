"""Cost attribution: what a program on the card costs, counted from its
shapes, and what share of the card's roofline a measured run reached.

The PyTorch form of `ccka_tpu/obs/costmodel.py`. The JAX module reads
what XLA's ``cost_analysis()`` says a compiled program costs; the port
compiles nothing at run time and launches hand-written kernels, so the
counts here are analytic (the bytes and operations the work needs, from
its shapes), and the memory is measured:

- :func:`rollout_cost` — a rollout kernel's count at ``B`` x ``T``: the
  stream rows it reads once, a plan's rows, its weights and its output
  (bytes); the plain tick's floating-point pointwise operations, counted
  by dispatching one tick on the CPU (:func:`tick_ops`); for the MLP
  the torso's products on the tensor cores and the head's in float32.
  With a card's rates (:data:`DEVICE_RATES`, :func:`device_rates`) it
  gives every term's least time, each execution unit's sum, the bound
  and the unit that sets it (:func:`roofline_bound`).
- :func:`attribute` — call a program once (outside any timed window),
  record its peak device memory (the arguments' bytes plus the rise of
  the allocator's peak over the call) and its count under a registry
  name. A program without a count is an "unavailable" row; a program
  whose call fails raises (a swallowed launch failure would be a
  fallback the port may not have).
- :func:`program_table` / :func:`render_program_table` — the registry
  joined with `obs/compile.py`'s dispatch counters, `perf`'s table.
- :func:`achieved_roofline_fraction` and :func:`crosscheck_bytes` — the
  JAX module's roofline arithmetic and its hand-count cross-check,
  unchanged; :meth:`RolloutCost.achieved_fraction` — a measured kernel's
  share of its bound, unit by unit.
- :func:`measured_stream_bandwidth` — the JAX module's streaming probe
  (2^25 float32, best of 5 distinct scalars), timed with CUDA events on
  the card.
- :func:`total_dispatches`, :func:`publish_pipeline_snapshot` /
  :func:`pipeline_snapshot` — the observatory's bridge to the exporter
  gauges (``ccka_program_dispatches_total``,
  ``ccka_pipeline_occupancy``, ``ccka_shard_imbalance``,
  ``ccka_achieved_roofline_fraction``; absent = series skipped, never a
  fake 0).

A card missing from the rates table gets no bound and no fraction (None),
never another card's numbers. The gauge reads are dict lookups: a
service tick reads them every tick.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable, Mapping

import torch

from ccka_tpu_torch.obs.compile import compile_report, stats_for

_REGISTRY: dict[str, "ProgramRecord"] = {}
_LOCK = threading.Lock()

# The observatory's latest pipeline measurement (occupancy fractions,
# shard imbalance, achieved fraction), published by whoever measured it.
_PIPELINE_SNAPSHOT: dict = {}

# The rollout kernels' [24, B] output block.
OUT_ROWS = 24
# The workload lanes' batch-deadline depth the kernels are built with
# (`kernels/build.py::VARIANTS`, ``WL_D = 16``).
WL_DEPTH = 16


# ---- the card's rates ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceRates:
    """A card's published peaks. ``f32_ops_per_s`` counts a fused
    multiply-add as two operations; the rollout kernels are built with
    ``-fmad=false``, so each multiply and add of their tick issues alone,
    at half of it (:attr:`f32_unfused_ops_per_s`)."""

    hbm_bytes_per_s: float
    f32_ops_per_s: float
    bf16_tensor_ops_per_s: float

    @property
    def f32_unfused_ops_per_s(self) -> float:
        return self.f32_ops_per_s / 2


# Keyed by `torch.cuda.get_device_name()`. NVIDIA H100 Tensor Core GPU
# datasheet, SXM5 part, dense rates without sparsity, at the full 700 W
# power limit: 3.35 TB/s HBM3, 67 TFLOP/s float32, 989 TFLOP/s bf16 on the
# tensor cores.
DEVICE_RATES: dict[str, DeviceRates] = {
    "NVIDIA H100 80GB HBM3": DeviceRates(hbm_bytes_per_s=3.35e12,
                                         f32_ops_per_s=67e12,
                                         bf16_tensor_ops_per_s=989e12),
}


def device_rates(device=None) -> DeviceRates | None:
    """The rates of the card ``device`` names (default: the current CUDA
    device), or None for the CPU and for a card not in
    :data:`DEVICE_RATES`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return DEVICE_RATES.get(torch.cuda.get_device_name(dev))


def roofline_bound(nbytes: float, op_terms: Mapping,
                   rates: DeviceRates) -> tuple[float, str, dict]:
    """(least time in ms, "bytes" or "operations", every term in ms) of a
    call that moves ``nbytes`` and does ``op_terms``: name ->
    (operations, the name of ``rates``' rate for their type, the unit that
    executes them). Terms of one unit add up; the units (HBM, the float32
    pipes, the tensor cores) run side by side, so the bound is the
    slowest unit's time. The dict also gives each unit's sum under
    ``unit:<name>`` and the unit that sets the bound under ``set_by``."""
    terms = {"bytes": nbytes / rates.hbm_bytes_per_s * 1e3}
    units: dict = {}
    for name, (ops, rate, unit) in op_terms.items():
        terms[name] = ops / getattr(rates, rate) * 1e3
        units[unit] = units.get(unit, 0.0) + terms[name]
    slowest = max(units, key=units.get)
    by_bytes = terms["bytes"] >= units[slowest]
    terms.update({f"unit:{u}": ms for u, ms in units.items()})
    terms["set_by"] = "hbm" if by_bytes else slowest
    return (max(terms["bytes"], units[slowest]),
            "bytes" if by_bytes else "operations", terms)


# ---- analytic counts -------------------------------------------------------


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


def pointwise_ops(fn: Callable[[], object]) -> int:
    """Elements written by the floating-point pointwise operations that
    ``fn()`` dispatches (on the CPU), the chained products' ``addcmul``s
    left out: a count takes those from the layer widths."""
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


def tick_ops(cfg, mode: str, *, stochastic: bool, net_params=None,
             faults: bool = False, workloads: bool = False) -> int:
    """Floating-point pointwise operations of one tick of the plain step
    for one cluster under ``mode`` ("rule", "carbon", "neural", "plan";
    with its uniforms' conversion when ``stochastic``; with ``faults`` the
    fault branch and the held observation, with ``workloads`` the
    D = 16 queues), counted by dispatching it on the CPU. The MLP's
    chained products are left out: :func:`rollout_cost` counts them from
    the layer widths. A plan's action is loaded, not computed."""
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
    makers = {
        "rule": lambda: RulePolicy(cfg.cluster, device="cpu").action_fn(),
        "carbon": lambda: CarbonAwarePolicy(cfg.cluster,
                                            device="cpu").action_fn(),
        "neural": lambda: mk.kernel_numerics_action_fn(
            net_params, cfg.cluster, params),
        "plan": lambda: (lambda s, e, t, a=RulePolicy(
            cfg.cluster, device="cpu").off: a),
    }
    if mode not in makers:
        raise ValueError(f"unknown packed mode {mode!r} — have "
                         f"{tuple(makers)}")
    action_fn = makers[mode]()
    one = torch.ones((1,))
    fault = (FaultStep(torch.full((1, Z), 2.0), 0.5 * one, 0.5 * one, one)
             if faults else None)
    lanes = (dict(workload=WorkloadStep(one, one, one),
                  wl_state=WorkloadState.zero(WL_DEPTH, 1, "cpu"))
             if workloads else {})

    def one_tick():
        u3 = (uniforms(0, torch.zeros((1, 1), dtype=torch.int64), 0,
                       torch.arange(P * Z)[None, :]).reshape(3, 1, P, Z)
              if stochastic else None)
        obs = (observed_exo(exo, exo, fault.signal_stale)
               if faults and mode in ("carbon", "neural") else exo)
        action = action_fn(state, obs, 0)
        step(params, state, action, exo, u3, stochastic=stochastic,
             fault=fault, **lanes)

    return pointwise_ops(one_tick)


@dataclasses.dataclass(frozen=True)
class RolloutCost:
    """A rollout kernel's analytic count (see :func:`rollout_cost`), and
    with ``rates`` its roofline bound."""

    bytes_accessed: int
    tick_ops: int                # per cluster-tick, outside the products
    op_terms: dict               # name -> (operations, rate name, unit)
    rates: DeviceRates | None = None

    @property
    def flops(self) -> float:
        return float(sum(ops for ops, _, _ in self.op_terms.values()))

    def _bound(self):
        if self.rates is None:
            return None, None, None
        return roofline_bound(self.bytes_accessed, self.op_terms,
                              self.rates)

    @property
    def bound_ms(self) -> float | None:
        return self._bound()[0]

    @property
    def bound_by(self) -> str | None:
        """"bytes" or "operations"."""
        return self._bound()[1]

    @property
    def terms(self) -> dict | None:
        """Every term's least time in ms, each unit's sum (``unit:<u>``)
        and the unit that sets the bound (``set_by``)."""
        return self._bound()[2]

    @property
    def set_by(self) -> str | None:
        terms = self.terms
        return None if terms is None else terms["set_by"]

    def achieved_fraction(self, seconds: float,
                          bandwidth_bytes_per_s: float | None = None
                          ) -> float | None:
        """A measured run's share of its roofline: for each unit, the
        unit's least time over ``seconds``, the bytes' at
        ``bandwidth_bytes_per_s`` (default: the card's stated rate), the
        largest. None without rates (a card not in the table, the CPU)
        or without a positive time."""
        terms = self.terms
        if terms is None or seconds <= 0.0:
            return None
        bw = bandwidth_bytes_per_s or self.rates.hbm_bytes_per_s
        fracs = [self.bytes_accessed / bw / seconds]
        fracs += [ms / 1e3 / seconds for k, ms in terms.items()
                  if k.startswith("unit:")]
        return max(fracs)


def rollout_cost(cfg, mode: str, B: int, T: int, *, stochastic: bool,
                 net_params=None, faults: bool = False,
                 workloads: bool = False, plan_broadcast: bool = False,
                 rates: DeviceRates | None = None) -> RolloutCost:
    """The count of one ``mode`` rollout kernel over ``B`` clusters x
    ``T`` ticks of ``cfg``'s topology: bytes (:func:`rollout_bytes` with
    a plan's used rows for "plan", one plan for every cluster when
    ``plan_broadcast``, the net's weights for "neural"); the plain tick's
    pointwise operations (:func:`tick_ops`) x B x T at the unfused
    float32 rate; for "neural" the torso's 2(F.H + H.H) a cluster-tick on
    the tensor cores and the head's 2.H.A at the float32 rate."""
    from ccka_tpu_torch.sim import megakernel as mk

    P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
    ops = tick_ops(cfg, mode, stochastic=stochastic, net_params=net_params,
                   faults=faults, workloads=workloads)
    op_terms = {"tick": (ops * B * T, "f32_unfused_ops_per_s", "float32")}
    weight_bytes, plan_rows = 0, 0
    if mode == "plan":
        if plan_broadcast:
            weight_bytes += mk._act_rows(P, Z) * T * 4
        else:
            plan_rows = mk._act_rows(P, Z)
    if mode == "neural":
        F, H, A = mk._mlp_dims(net_params, P=P, Z=Z)[0]
        weight_bytes += (F * H + H * H + 2 * H) * 2 + (H * A + A) * 4
        op_terms["torso"] = (2 * (F * H + H * H) * B * T,
                             "bf16_tensor_ops_per_s", "tensor cores")
        op_terms["head"] = (2 * H * A * B * T, "f32_ops_per_s", "float32")
    return RolloutCost(
        bytes_accessed=rollout_bytes(Z, B, T, weight_bytes, faults,
                                     workloads, plan_rows),
        tick_ops=ops, op_terms=op_terms, rates=rates)


@dataclasses.dataclass(frozen=True)
class Cost:
    """A count given by hand (e.g. a stream's bytes); either may be
    None."""

    flops: float | None = None
    bytes_accessed: float | None = None


# ---- attribution -----------------------------------------------------------


@dataclasses.dataclass
class ProgramRecord:
    """One attributed program (see module docstring)."""

    name: str
    flops: float | None = None
    bytes_accessed: float | None = None
    peak_memory_bytes: float | None = None
    # "analytic" when a count was given; "unavailable" when not (the row
    # still exists — an absent row and an uncounted program are
    # different facts).
    analysis: str = "unavailable"
    error: str | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, Mapping):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def attribute(name: str, fn: Callable, *args, cost=None,
              **kwargs) -> ProgramRecord:
    """Call ``fn(*args, **kwargs)`` once and register what it costs under
    ``name`` (the `watch_jit` registry name, so :func:`program_table` can
    join dispatch counts; the call is a real dispatch and a watched
    ``fn`` counts it). Where the arguments or the result are on a CUDA
    device, the peak memory is the arguments' bytes plus the rise of
    ``torch.cuda.max_memory_allocated`` over the call; on the CPU it is
    None. ``flops`` and ``bytes_accessed`` come from ``cost`` (a
    :class:`RolloutCost` or a :class:`Cost`), ``analysis="analytic"``;
    without one they are None, ``"unavailable"``. A failing ``fn``
    raises."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    rec = ProgramRecord(name=name)
    arg_tensors = _tensors(list(args) + list(kwargs.values()))
    if cuda and any(t.is_cuda for t in arg_tensors + _tensors(out)):
        torch.cuda.synchronize()
        rec.peak_memory_bytes = float(
            sum(t.nbytes for t in arg_tensors if t.is_cuda)
            + torch.cuda.max_memory_allocated() - base)
    if cost is not None:
        rec.flops = None if cost.flops is None else float(cost.flops)
        rec.bytes_accessed = (None if cost.bytes_accessed is None
                              else float(cost.bytes_accessed))
    if rec.flops is not None or rec.bytes_accessed is not None:
        rec.analysis = "analytic"
    with _LOCK:
        _REGISTRY[name] = rec
    return rec


def registered(name: str) -> ProgramRecord | None:
    with _LOCK:
        return _REGISTRY.get(name)


def clear_registry() -> None:
    """Tests only — the registry is process-global like obs/compile's."""
    with _LOCK:
        _REGISTRY.clear()
        _PIPELINE_SNAPSHOT.clear()


def program_table() -> list[dict]:
    """One row per known program: the attribution registry joined with
    the compile watch's dispatch counters. Programs that were watched
    but never attributed still appear (flops=None, "unattributed") —
    the table answers "what ran", not only "what was analyzed"."""
    with _LOCK:
        attributed = dict(_REGISTRY)
    names = sorted(set(attributed) | set(compile_report()))
    rows = []
    for name in names:
        rec = attributed.get(name)
        stats = stats_for(name)
        rows.append({
            "name": name,
            "dispatches": stats.calls if stats is not None else None,
            "compiles": stats.compiles if stats is not None else None,
            "flops": rec.flops if rec else None,
            "bytes_accessed": rec.bytes_accessed if rec else None,
            "peak_memory_bytes": rec.peak_memory_bytes if rec else None,
            "analysis": rec.analysis if rec else "unattributed",
            **({"error": rec.error} if rec and rec.error else {}),
        })
    return rows


def total_dispatches() -> int:
    """Sum of calls across every watched entry point this session (the
    ``ccka_program_dispatches_total`` gauge)."""
    return sum(s.get("calls", 0) for s in compile_report().values())


def render_program_table(rows: list[dict]) -> str:
    """The `perf` table: fixed columns, ``-`` for unavailable."""

    def num(v, unit=""):
        if v is None:
            return "-"
        if abs(v) >= 1e12:
            return f"{v / 1e12:.2f}T{unit}"
        if abs(v) >= 1e9:
            return f"{v / 1e9:.2f}G{unit}"
        if abs(v) >= 1e6:
            return f"{v / 1e6:.2f}M{unit}"
        if abs(v) >= 1e3:
            return f"{v / 1e3:.1f}k{unit}"
        return f"{v:.3g}{unit}" if isinstance(v, float) else f"{v}{unit}"

    header = (f"{'program':44s} {'disp':>6s} {'flops':>9s} "
              f"{'bytes':>9s} {'peak mem':>9s} {'achieved':>9s}  analysis")
    lines = [header, "-" * len(header)]
    for r in rows:
        ach = r.get("achieved_roofline_fraction")
        lines.append(
            f"{r['name'][:44]:44s} "
            f"{r['dispatches'] if r['dispatches'] is not None else '-':>6} "
            f"{num(r['flops']):>9s} {num(r['bytes_accessed']):>9s} "
            f"{num(r['peak_memory_bytes']):>9s} "
            f"{(f'{ach:.4f}' if ach is not None else '-'):>9s}  "
            f"{r['analysis']}")
    return "\n".join(lines)


# ---- roofline arithmetic ---------------------------------------------------


_BW_CACHE: dict = {}
# Best times below this are implausible where no peak is known.
_IMPLAUSIBLE_S = 1e-4


def measured_stream_bandwidth(device=None) -> float:
    """Achievable streaming bandwidth (bytes/s) of ``device`` (default:
    the card): ``y = x + c`` over 2^25 float32 (128 MB read, 128 MB
    written), the best of 5 calls with distinct scalars after a warm-up,
    cached per device. On a CUDA device each call is timed with CUDA
    events. A reading above 1.05 x the card's stated HBM rate
    (:func:`device_rates`) is a broken measurement and raises. Where no
    rate is known (the CPU, a card not in the table), a best time under
    100 us is implausible, as in the JAX package: 2 TB/s stands in."""
    from ccka_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev in _BW_CACHE:
        return _BW_CACHE[dev]
    n = 1 << 25
    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    y = x + 0.0
    best = float("inf")
    for i in range(5):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = x + float(i + 1)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            y = x + float(i + 1)
            dt = time.perf_counter() - t0
        best = min(best, dt)
    del x, y
    bw = 2.0 * 4.0 * n / max(best, 1e-9)
    rates = device_rates(dev)
    if rates is not None:
        if bw > 1.05 * rates.hbm_bytes_per_s:
            raise RuntimeError(
                f"bandwidth probe read {bw / 1e12:.3f} TB/s on {dev}, "
                f"above 1.05 x its "
                f"stated {rates.hbm_bytes_per_s / 1e12:.2f} TB/s: the "
                "probe is broken")
    elif best < _IMPLAUSIBLE_S:
        print("# [obs] bandwidth probe implausible — using 2 TB/s "
              "ceiling", file=sys.stderr)
        bw = 2e12
    _BW_CACHE[dev] = bw
    return bw


def achieved_roofline_fraction(seconds: float, *,
                               bytes_accessed: float | None,
                               bandwidth_bytes_per_s: float | None = None,
                               flops: float | None = None,
                               peak_flops_per_s: float | None = None
                               ) -> float | None:
    """Fraction of the roofline a measured span achieved: the max of
    the memory fraction (``bytes/s over streaming bandwidth``) and the
    compute fraction (``flops/s over peak``, when a peak is stated).
    None when neither resource is quantified — an unknowable fraction
    is not 0."""
    if seconds <= 0.0:
        return None
    fracs = []
    if bytes_accessed is not None and bytes_accessed > 0:
        bw = bandwidth_bytes_per_s or measured_stream_bandwidth()
        fracs.append((bytes_accessed / seconds) / max(bw, 1e-9))
    if flops is not None and flops > 0 and peak_flops_per_s:
        fracs.append((flops / seconds) / max(peak_flops_per_s, 1e-9))
    return max(fracs) if fracs else None


def crosscheck_bytes(name: str, hand_bytes: float,
                     xla_bytes: float | None, *,
                     tolerance: float = 2.0,
                     warn: Callable[[str], None] | None = None) -> dict:
    """A hand-counted byte floor vs another count of the same program's
    bytes (the JAX package's XLA-reported bytes; here any second count).
    Both land on the record; a ratio outside [1/tolerance, tolerance]
    warns — the hand count is the program's irreducible traffic, so the
    other reporting LESS means one model is wrong, and >2x more means the
    floor badly understates real traffic."""
    out = {"hand_bytes": float(hand_bytes), "xla_bytes": xla_bytes,
           "ratio": None, "agree": None}
    if xla_bytes is None or hand_bytes <= 0:
        return out
    ratio = xla_bytes / hand_bytes
    out["ratio"] = round(ratio, 4)
    out["agree"] = bool(1.0 / tolerance <= ratio <= tolerance)
    if not out["agree"]:
        (warn or (lambda m: print(m, file=sys.stderr)))(
            f"# [obs] byte-count disagreement for {name!r}: hand-counted "
            f"{hand_bytes:.3g} vs XLA-reported {xla_bytes:.3g} "
            f"({ratio:.2f}x — outside the {tolerance:.0f}x band); "
            "recording both")
    return out


# ---- pipeline snapshot (promexport bridge) ---------------------------------


def publish_pipeline_snapshot(*, occupancy: Mapping[str, float],
                              shard_imbalance: float | None = None,
                              achieved_fraction: float | None = None
                              ) -> None:
    """Publish the observatory's latest pipeline measurement for the
    exporter gauges. Occupancy is the stage-fraction dict (generation/
    kernel/host, summing to ~1)."""
    with _LOCK:
        _PIPELINE_SNAPSHOT.clear()
        _PIPELINE_SNAPSHOT.update({
            "occupancy": {k: float(v) for k, v in occupancy.items()},
            "shard_imbalance": (float(shard_imbalance)
                                if shard_imbalance is not None else None),
            "achieved_fraction": (float(achieved_fraction)
                                  if achieved_fraction is not None
                                  else None),
        })


def pipeline_snapshot() -> dict | None:
    """The latest published measurement, or None (gauges then skip)."""
    with _LOCK:
        return dict(_PIPELINE_SNAPSHOT) if _PIPELINE_SNAPSHOT else None
