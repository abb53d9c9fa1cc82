"""Host side of the rollout kernels: pack, launch, finalize.

The PyTorch form of `ccka_tpu/sim/megakernel.py`'s profiles, carbon and
mlp paths. One kernel launch steps a whole fleet through the whole horizon
and emits the per-cluster accumulators as an [24, B] block;
:func:`_finalize` turns that block into an EpisodeSummary with the same
reduction code the plain rollout uses. Three policies, one entry pair
each (from [B, T, ...] traces, or from an already packed stream):

- the Peak/Off-Peak rule (`csrc/rollout_profiles.cu`):
  :func:`megakernel_rollout_summary`;
- the carbon-aware re-rank of the rule's zone weights (the same kernel's
  carbon instantiation): :func:`carbon_megakernel_rollout_summary`;
- a learned ActorCritic policy, or a population of them
  (`csrc/rollout_mlp.cu`): :func:`neural_megakernel_rollout_summary`;
- plan playback, a precomputed action per cluster and tick (the profile
  kernel's plan instantiation): :func:`plan_megakernel_rollout_summary`.

Contract: each is the same function as ``batched_rollout_summary(params,
initial_state(...), action_fn, traces, seed, stochastic=...)``
(`sim/rollout.py`) under ``RulePolicy``, ``CarbonAwarePolicy`` or
:func:`kernel_numerics_action_fn`, or ``rollout_actions`` under the plan
(:func:`plan_action_fn`). All draw their spot interruptions from
the one Philox stream of `sim/random.py`, addressed by (seed, cluster,
tick, spot row) and never by the policy: runs of different policies on one
seed and stream are paired world for world, and a kernel agrees with its
plain version per cluster in both modes, up to float rounding that a
threshold gate (or, for the learned policy, the feedback through a bf16
net) may amplify.

Widened streams: a packed stream may carry the fault block, the
workload block or both after its exo rows (`sim/lanes.py`); each
``*_summary_from_packed`` entry reads the layout from the row count. The
kernels then take their ``FAULTS`` / ``WL_D`` instantiations, and the
plain version threads the unpacked lanes through the rollout
(`faults/process.py::unpack_fault_lanes`,
`workloads/process.py::unpack_workload_lanes`).

Carried state: :func:`packed_mode_block_summary_fn` runs a rollout one
time block at a time (the kernels' CARRY instantiations), the state that
crosses a block boundary packed as `sim/rollout.py::CarryLayout` rows:
the streaming pipeline's unit (`sim/streaming.py`).

Policy modes: "rule", "carbon", "neural" and "plan" register here in the
mode registry of `sim/lanes.py`, each with its whole-stream entry and its
carried-state closures; :func:`packed_mode_summary`,
:func:`packed_mode_block_summary_fn` and :func:`packed_mode_summary_fn`
dispatch through it, and an unknown mode is refused with the registered
names.

Device rule: a stream on a CUDA device launches the kernel (or raises); a
stream on the CPU runs the plain version. Each ``*_summary_from_packed``
entry counts its kernel launches in its ``launches`` attribute; the
launch wrappers of `kernels/build.py` count every launch by
instantiation.

As in the JAX package, workload class c consumes capacity type c
(``SimParams.class_ct`` is the identity by construction).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import ClusterConfig
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim import lanes as _lanes
from ccka_tpu_torch.sim.lanes import exo_rows, resolve_layout
from ccka_tpu_torch.sim.metrics import EpisodeSummary, SummaryAcc
from ccka_tpu_torch.sim.types import Action, ClusterState, SimParams

# Packed scalar params, in the kernel's order.
_PARAM_NAMES = (
    "dt_s", "ppn", "base_od", "maxn0", "maxn1",
    "sa00", "sa01", "sa10", "sa11",           # static_ct_allow[p, ct]
    "interrupt_p", "pdb", "frag", "underutil",
    "watts_idle", "watts_full", "rps", "slo_frac", "tau_s",
    "lat_base", "lat_slo",
    "wl_inf_qmax", "wl_inf_slo",              # workload families
)

# Output block rows: 16 accumulators + 5 workload-family ones (zero
# without workload lanes), padded to a multiple of 8.
_OUT_ROWS = 24

# Topologies (P, Z, K) the kernel is instantiated for: the default and
# multiregion presets.
KERNEL_TOPOLOGIES = ((2, 3, 3), (2, 4, 3))
# Batch-deadline depths D the workload instantiations are built for:
# every scenario of the library has batch_deadline_ticks = 16.
KERNEL_WL_DEPTHS = (16,)


def _pack_params(params: SimParams) -> torch.Tensor:
    """[1, 22] float32 scalar params in `_PARAM_NAMES` order."""
    sa = params.static_ct_allow
    vals = [params.dt_s, params.pods_per_node, params.base_od_nodes,
            params.max_nodes[0], params.max_nodes[1],
            sa[0, 0], sa[0, 1], sa[1, 0], sa[1, 1],
            params.interrupt_p_step, params.pdb_min_available,
            params.fragmentation, params.underutil_threshold,
            params.watts_idle, params.watts_full, params.rps_per_pod,
            params.slo_served_fraction, params.consolidate_tau_s,
            params.latency_base_ms, params.latency_slo_ms,
            params.wl_inference_queue_max, params.wl_inference_slo_ms]
    return torch.stack([torch.as_tensor(v, dtype=torch.float32)
                        for v in vals]).reshape(1, -1)


def _pack_action(a: Action) -> torch.Tensor:
    """One profile's Action -> [P*Z + 4P + 2] coordinate vector: zone
    weights, capacity types, aggressiveness, consolidate-after, HPA."""
    return torch.cat([a.zone_weight.reshape(-1), a.ct_allow.reshape(-1),
                      a.consolidation_aggr.reshape(-1),
                      a.consolidate_after_s.reshape(-1),
                      a.hpa_scale.reshape(-1)]).to(torch.float32)


def _pack_exo(traces: ExogenousTrace, T_pad: int) -> torch.Tensor:
    """[B, T, ...] traces -> [T_pad, exo_rows(Z), B] feature-first stream
    (rows: spot, od, carbon, demand, is_peak; zero padding), the batch
    innermost so a warp's reads coalesce."""
    B, T = traces.is_peak.shape
    Z = traces.spot_price_hr.shape[-1]
    out = torch.zeros((T_pad, exo_rows(Z), B), dtype=torch.float32,
                      device=traces.is_peak.device)
    out[:T, 0:Z] = traces.spot_price_hr.permute(1, 2, 0)
    out[:T, Z:2 * Z] = traces.od_price_hr.permute(1, 2, 0)
    out[:T, 2 * Z:3 * Z] = traces.carbon_g_kwh.permute(1, 2, 0)
    out[:T, 3 * Z:3 * Z + 2] = traces.demand_pods.permute(1, 2, 0)
    out[:T, 3 * Z + 2] = traces.is_peak.permute(1, 0)
    return out


def unpack_exo(exo_packed: torch.Tensor, T: int, Z: int) -> ExogenousTrace:
    """Inverse of `_pack_exo` as views: [T_pad, rows, B] -> [B, T, ...]."""
    x = exo_packed[:T]

    def bt(a):  # [T, k, B] -> [B, T, k]
        return a.permute(2, 0, 1)

    return ExogenousTrace(
        spot_price_hr=bt(x[:, 0:Z]), od_price_hr=bt(x[:, Z:2 * Z]),
        carbon_g_kwh=bt(x[:, 2 * Z:3 * Z]),
        demand_pods=bt(x[:, 3 * Z:3 * Z + 2]),
        is_peak=x[:, 3 * Z + 2].permute(1, 0))


def _finalize(params: SimParams, out: torch.Tensor, T: int) -> EpisodeSummary:
    """Kernel output rows [OUT_ROWS, B] -> EpisodeSummary batch, through
    the plain rollout's own `finalize_summary`."""
    from ccka_tpu_torch.sim.metrics import finalize_summary

    (cost, carbon, requests, slo_s, evict, nct_spot, nct_od, served,
     capacity, waste, lat_sum, lat_max, queue, interrupts, denied,
     stale) = out[:16]
    inf_viol, inf_q, inf_drop, b_miss, b_bl = out[16:21]
    zeros = torch.zeros_like(cost)

    def mk_state(c, g, r, s, e):
        return ClusterState(
            nodes=zeros, pipeline=zeros, running=zeros,
            consol_timer_s=zeros, time_s=zeros, acc_cost_usd=c,
            acc_carbon_g=g, acc_requests=r, acc_slo_ok_s=s, acc_evictions=e)

    acc = SummaryAcc(
        nodes_ct_sum=torch.stack([nct_spot, nct_od], dim=-1),
        served_sum=served, capacity_sum=capacity, waste_sum=waste,
        latency_sum=lat_sum, latency_max=lat_max, queue_sum=queue,
        interrupts_sum=interrupts, denied_sum=denied, stale_sum=stale,
        inf_viol_sum=inf_viol, inf_queue_sum=inf_q, inf_drop_sum=inf_drop,
        batch_miss_sum=b_miss, batch_bl_sum=b_bl)
    return finalize_summary(params, mk_state(zeros, zeros, zeros, zeros,
                                             zeros),
                            mk_state(cost, carbon, requests, slo_s, evict),
                            acc, T)


# Batch-mean parity tolerances (the JAX package's table): core KPIs tight;
# rare-event counters and threshold-gated SLO fields looser.
MEAN_PARITY_TOLERANCES = {
    "interruptions": 0.03, "evictions": 0.05, "queue_depth_mean": 0.05,
    "slo_hours": 0.01, "slo_attainment": 0.01, "usd_per_slo_hour": 0.01,
    "latency_p95_ms_max": 0.02,
    "denials": 0.05, "stale_ticks": 0.01,
    "inf_slo_violations": 0.02, "inf_queue_mean": 0.05,
    "inf_dropped": 0.05, "batch_deadline_misses": 0.05,
    "batch_backlog_mean": 0.05,
}
DEFAULT_MEAN_PARITY_TOL = 0.005

# The learned policy's extra latitude, on top of the shared table: a bf16
# feedback policy amplifies rounding differences in the net forward into a
# small systematic fleet-size offset. The scoreboard fields stay under the
# shared tolerances; only the two fleet-shape diagnostics widen.
NEURAL_MEAN_PARITY_TOLERANCES = {
    "mean_nodes": 0.02, "waste_frac": 0.02,
}


def mean_parity_violations(kernel_summary, lax_summary,
                           overrides: dict | None = None) -> dict:
    """{field: batch-mean rel diff} for every field whose diff exceeds its
    tolerance AND is significant (paired z > 4); empty == parity. Takes
    summaries of tensors or arrays (either package's)."""
    tol = dict(MEAN_PARITY_TOLERANCES, **(overrides or {}))
    bad = {}
    for f in kernel_summary._fields:
        ka = _as_f64(getattr(kernel_summary, f))
        la = _as_f64(getattr(lax_summary, f))
        b = la.mean()
        d = ka - la
        rel = abs(d.mean()) / (abs(b) + 1e-9)
        if rel <= tol.get(f, DEFAULT_MEAN_PARITY_TOL):
            continue
        if d.size < 2:
            bad[f] = round(rel, 5)
            continue
        se = d.std(ddof=1) / math.sqrt(d.size)
        z = abs(d.mean()) / (se + 1e-12)
        if z > 4.0:
            bad[f] = round(rel, 5)
    return bad


def _as_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64).ravel()


def megakernel_rollout_summary(params: SimParams, off_action: Action,
                               peak_action: Action, traces: ExogenousTrace,
                               seed: int = 0, *, stochastic: bool = True,
                               device=None) -> EpisodeSummary:
    """EpisodeSummary batch for a fresh-state rule-profile rollout of
    [B, T, ...] ``traces``: packs the stream on ``device`` (the card
    unless the caller names another) and hands it to
    :func:`megakernel_summary_from_packed`."""
    dev = resolve_device(device)
    traces = traces.to(dev)
    T = traces.is_peak.shape[1]
    return megakernel_summary_from_packed(
        _to(params, dev), _to(off_action, dev), _to(peak_action, dev),
        _pack_exo(traces, T), T, seed, stochastic=stochastic)


def _to(tup, dev):
    return type(tup)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                       for x in tup))


def megakernel_summary_from_packed(params: SimParams, off_action: Action,
                                   peak_action: Action,
                                   exo_packed: torch.Tensor, T: int,
                                   seed: int = 0, *,
                                   stochastic: bool = True,
                                   cluster0: int = 0) -> EpisodeSummary:
    """Rule-profile EpisodeSummary from a packed ``[T_pad, exo_rows, B]``
    stream (``T`` is the true horizon). A CUDA stream launches the kernel;
    a CPU stream runs the plain rollout on the unpacked views.
    ``cluster0``: the global index of the stream's first cluster, when
    the stream is one shard of a fleet (`parallel/sharded_kernel.py`):
    its clusters then draw the fleet's interruptions."""
    return _profiles_summary(megakernel_summary_from_packed, params,
                             off_action, peak_action, exo_packed, T, seed,
                             stochastic, None, cluster0)


megakernel_summary_from_packed.launches = 0


def carbon_megakernel_rollout_summary(params: SimParams, off_action: Action,
                                      peak_action: Action,
                                      traces: ExogenousTrace, seed: int = 0,
                                      *, sharpness: float = 10.0,
                                      min_weight: float = 0.05,
                                      stickiness: float = 1.0,
                                      stochastic: bool = True,
                                      device=None) -> EpisodeSummary:
    """EpisodeSummary batch for a fresh-state CarbonAwarePolicy rollout
    (`policy/carbon.py`) of [B, T, ...] ``traces``: the carbon teacher at
    kernel speed. Keyword defaults mirror CarbonAwarePolicy's. Same-seed
    runs are paired with the other kernel entries."""
    dev = resolve_device(device)
    traces = traces.to(dev)
    T = traces.is_peak.shape[1]
    return carbon_megakernel_summary_from_packed(
        _to(params, dev), _to(off_action, dev), _to(peak_action, dev),
        _pack_exo(traces, T), T, seed, sharpness=sharpness,
        min_weight=min_weight, stickiness=stickiness, stochastic=stochastic)


def carbon_megakernel_summary_from_packed(params: SimParams,
                                          off_action: Action,
                                          peak_action: Action,
                                          exo_packed: torch.Tensor, T: int,
                                          seed: int = 0, *,
                                          sharpness: float = 10.0,
                                          min_weight: float = 0.05,
                                          stickiness: float = 1.0,
                                          stochastic: bool = True,
                                          cluster0: int = 0
                                          ) -> EpisodeSummary:
    """CarbonAwarePolicy EpisodeSummary from a packed stream: the packed
    analog of :func:`carbon_megakernel_rollout_summary` (``cluster0`` as
    for :func:`megakernel_summary_from_packed`)."""
    return _profiles_summary(
        carbon_megakernel_summary_from_packed, params, off_action,
        peak_action, exo_packed, T, seed, stochastic,
        (float(sharpness), float(min_weight), float(stickiness)), cluster0)


carbon_megakernel_summary_from_packed.launches = 0


class _Lanes:
    """What a checked packed stream carries: the row offsets of its fault
    and workload blocks (-1 when absent) and the batch-deadline depth its
    workload queues need (0 without workloads)."""

    def __init__(self, layout, params):
        self.fault_base = (layout.block("faults")[0]
                           if layout.has("faults") else -1)
        self.wl_base = (layout.block("workloads")[0]
                        if layout.has("workloads") else -1)
        self.wl_depth = (int(params.wl_batch_deadline_ticks)
                         if self.wl_base >= 0 else 0)


def _check_packed(exo_packed: torch.Tensor, T: int, P: int, Z: int,
                  K: int, params: SimParams) -> _Lanes:
    """The stream's lanes. Refuses a stream whose row count names no
    layout or that does not fit the horizon, a device that is neither CPU
    nor CUDA, and on CUDA a topology or batch-deadline depth the kernels
    are not built for."""
    T_pad, rows, B = exo_packed.shape
    if T_pad < T or B < 1:
        raise ValueError(f"packed stream {tuple(exo_packed.shape)} does not "
                         f"fit T={T}")
    try:
        layout = resolve_layout(rows, Z)
    except ValueError as err:
        raise ValueError(f"packed stream {tuple(exo_packed.shape)} does not "
                         f"fit Z={Z}: {err}") from None
    if exo_packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {exo_packed.device}")
    lanes = _Lanes(layout, params)
    if exo_packed.device.type == "cuda":
        if (P, Z, K) not in KERNEL_TOPOLOGIES:
            raise ValueError(f"the rollout kernel is built for (P, Z, K) in "
                             f"{KERNEL_TOPOLOGIES}, not {(P, Z, K)}")
        if lanes.wl_depth and lanes.wl_depth not in KERNEL_WL_DEPTHS:
            raise ValueError(f"the rollout kernel is built for batch "
                             f"deadlines D in {KERNEL_WL_DEPTHS}, not "
                             f"{lanes.wl_depth}")
    return lanes


def _unpack_lanes(exo_packed: torch.Tensor, T: int, Z: int,
                  lanes: _Lanes) -> dict:
    """The ``faults=``/``workloads=`` arguments of the plain rollout."""
    from ccka_tpu_torch.faults.process import unpack_fault_lanes
    from ccka_tpu_torch.workloads.process import unpack_workload_lanes

    return dict(
        faults=(unpack_fault_lanes(exo_packed, T, Z)
                if lanes.fault_base >= 0 else None),
        workloads=(unpack_workload_lanes(exo_packed, T, Z)
                   if lanes.wl_base >= 0 else None))


def _profiles_summary(entry, params, off_action, peak_action, exo_packed, T,
                      seed, stochastic, carbon,
                      cluster0: int = 0) -> EpisodeSummary:
    """The rule (``carbon`` None) or carbon-aware rollout on a packed
    stream; a kernel launch is counted on ``entry``."""
    from ccka_tpu_torch.sim.random import seed_key

    P, Z = off_action.zone_weight.shape
    K = int(params.provision_pipeline_k)
    lanes = _check_packed(exo_packed, T, P, Z, K, params)
    seed_key(seed)  # range check: the kernel keys Philox by its 64 bits
    _check_cluster0(cluster0)
    if exo_packed.device.type == "cpu":
        return _plain_summary(params, off_action, peak_action,
                              unpack_exo(exo_packed, T, Z), seed, stochastic,
                              carbon, cluster0=cluster0,
                              **_unpack_lanes(exo_packed, T, Z, lanes))
    from ccka_tpu_torch.kernels import build

    acts = torch.stack([_pack_action(off_action), _pack_action(peak_action)])
    out = torch.empty((_OUT_ROWS, exo_packed.shape[2]), dtype=torch.float32,
                      device=exo_packed.device)
    build.launch_rollout_profiles(
        out, exo_packed,
        _pack_params(params).cpu().numpy().ravel(),
        acts.cpu().numpy(), P=P, Z=Z, K=K, T=int(T), seed=int(seed),
        stochastic=bool(stochastic), carbon=carbon,
        fault_base=lanes.fault_base, wl_base=lanes.wl_base,
        wl_depth=lanes.wl_depth, b0=int(cluster0))
    entry.launches += 1
    return _finalize(params, out, T)


def _check_cluster0(cluster0) -> None:
    if int(cluster0) < 0:
        raise ValueError(f"cluster0={cluster0} must be non-negative")


def _plain_rollout(params, P, Z, action_fn, traces, seed, stochastic,
                   faults=None, workloads=None, cluster0: int = 0):
    """`sim/rollout.py`'s rollout of fresh clusters under ``action_fn``,
    with the stream's lanes when it has them; the first cluster's global
    index is ``cluster0``."""
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            fresh_state)

    states0 = fresh_state(P, Z, int(params.provision_pipeline_k),
                          traces.is_peak.shape[0], traces.is_peak.device)
    return batched_rollout_summary(params, states0, action_fn, traces, seed,
                                   stochastic=stochastic, faults=faults,
                                   workloads=workloads,
                                   cluster0=int(cluster0))[1]


def _profile_action_fn(off, peak, carbon):
    """The profile kernel's policy as an ``action_fn``: the rule's select
    of two profiles on is_peak, or with ``carbon`` = (sharpness,
    min_weight, stickiness) the CarbonAwarePolicy's zone weights over the
    same two profiles."""
    from ccka_tpu_torch.policy.carbon import carbon_aware_action
    from ccka_tpu_torch.policy.rule import select_profile

    if carbon is None:
        return lambda s, e, t: select_profile(e.is_peak, off, peak)
    return lambda s, e, t: carbon_aware_action(
        off, peak, s, e, sharpness=carbon[0], min_weight=carbon[1],
        stickiness=carbon[2])


def _plain_summary(params, off, peak, traces, seed, stochastic, carbon=None,
                   faults=None, workloads=None, cluster0: int = 0):
    """The profile kernel's plain version: the rule-policy rollout from
    fresh clusters, or with ``carbon`` the CarbonAwarePolicy's."""
    P, Z = off.zone_weight.shape
    return _plain_rollout(params, P, Z, _profile_action_fn(off, peak, carbon),
                          traces, seed, stochastic, faults, workloads,
                          cluster0)


# ---------------------------------------------------------------------------
# The learned policy: an ActorCritic's mean action, fused into the rollout.


def _act_rows(P: int, Z: int) -> int:
    """Action coordinates (= the latent width): P*Z + 4P + 2."""
    return P * Z + 4 * P + 2


def _obs_dim(P: int, Z: int) -> int:
    """`observe(...).flatten()` length: nodes P*Z*2 + pipeline_ct 2 +
    running 2 + demand 2 + 3 price/carbon vectors [Z] + is_peak + tod."""
    return 2 * P * Z + 3 * Z + 8


def _mlp_dims(net_params: dict, *, P: int, Z: int):
    """Validate an ActorCritic params tree against the topology; returns
    ``((F, H, A), was_single)``: observation, hidden and latent widths,
    and whether the leaves lack the leading population axis."""
    pp = net_params["params"]
    extra = sorted(k for k in pp
                   if k.startswith("Dense_") and k not in ("Dense_0",
                                                           "Dense_1"))
    if extra:
        # Truncating a deeper torso would score a different policy than
        # PPOBackend runs.
        raise ValueError(f"kernel supports exactly two torso layers; net "
                         f"has extra {extra}")
    w1 = pp["Dense_0"]["kernel"]
    was_single = w1.ndim == 2
    F, H = w1.shape[-2:]
    A = pp["actor_mean"]["kernel"].shape[-1]
    if F != _obs_dim(P, Z):
        raise ValueError(f"net expects obs dim {F}, topology gives "
                         f"{_obs_dim(P, Z)}")
    if A != _act_rows(P, Z):
        raise ValueError(f"net emits latent dim {A}, topology needs "
                         f"{_act_rows(P, Z)}")
    return (int(F), int(H), int(A)), was_single


def _pack_mlp_tensors(net_params: dict, device) -> tuple:
    """Stacked ActorCritic params -> the kernel's weight tensors on
    ``device``: (w1 [NP, F, H], b1 [NP, H], w2 [NP, H, H], b2 [NP, H])
    bfloat16 and (w3 [NP, H, A], b3 [NP, A]) float32, contiguous. Weights
    keep the tree's [in, out] layout; a single tree gets NP = 1. Leaves
    may be numpy arrays or tensors on any device."""
    pp = net_params["params"]

    def leaf(layer, name, dtype):
        x = pp[layer][name]
        x = (x.to(device, torch.float32) if isinstance(x, torch.Tensor)
             else torch.as_tensor(np.asarray(x, np.float32), device=device))
        if x.dim() == (1 if name == "bias" else 2):
            x = x[None]
        return x.to(dtype).contiguous()

    bf16, f32 = torch.bfloat16, torch.float32
    return (leaf("Dense_0", "kernel", bf16), leaf("Dense_0", "bias", bf16),
            leaf("Dense_1", "kernel", bf16), leaf("Dense_1", "bias", bf16),
            leaf("actor_mean", "kernel", f32), leaf("actor_mean", "bias", f32))


def _chained_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, IN] x [IN, OUT] in float32 as one chain over k in ascending
    order, ``acc = acc + x[:, k] * w[k]`` from zero: the order in which the
    CUDA kernel's head adds, and the torso sums whose rounding to bfloat16
    the kernel's tensor-core sums reproduce. A leading member axis on both
    ([NP, B, IN] x [NP, IN, OUT]) gives each member its own chain."""
    acc = torch.zeros((*x.shape[:-1], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[-2]):
        acc = torch.addcmul(acc, x[..., k:k + 1], w[..., k:k + 1, :])
    return acc


class MlpStages(NamedTuple):
    """One forward of the MLP kernel's numerics, layer by layer, for N
    observations: ``x`` [N, F] bfloat16 (the normalized observation),
    ``pre1`` [N, H] float32 (the first layer's sum before rounding),
    ``h1`` [N, H] bfloat16, ``pre2`` and ``h2`` likewise for the second
    layer, and the latent ``u`` [N, A] float32."""

    x: torch.Tensor
    pre1: torch.Tensor
    h1: torch.Tensor
    pre2: torch.Tensor
    h2: torch.Tensor
    u: torch.Tensor


def _gelu_layer(pre: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu(bf16(bf16(pre) + b))``: a torso layer's epilogue."""
    from ccka_tpu_torch.models.nets import gelu_tanh

    return gelu_tanh(pre.to(torch.bfloat16) + b)


def mlp_stages(obs: torch.Tensor, weights: tuple) -> MlpStages:
    """The MLP kernel's forward in plain PyTorch on observations ``obs``
    [N, F] float32, for one net's ``weights`` = (w1 [F, H], b1 [H],
    w2 [H, H], b2 [H]) bfloat16 and (w3 [H, A], b3 [A]) float32: the
    log1p-normalized observation in bfloat16; two torso layers whose
    float32 sums (:func:`_chained_product`) are rounded once to bfloat16,
    the bias added in bfloat16 and the tanh-form GELU computed operation
    by operation in bfloat16 (`models/nets.py::gelu_tanh`); a float32
    head (the same chain)."""
    from ccka_tpu_torch.models.nets import _normalize_obs

    w1, b1, w2, b2, w3, b3 = weights
    x = _normalize_obs(obs).to(torch.bfloat16)
    pre1 = _chained_product(x.to(torch.float32), w1.to(torch.float32))
    h1 = _gelu_layer(pre1, b1)
    pre2 = _chained_product(h1.to(torch.float32), w2.to(torch.float32))
    h2 = _gelu_layer(pre2, b2)
    u = _chained_product(h2.to(torch.float32), w3) + b3
    return MlpStages(x, pre1, h1, pre2, h2, u)


def mlp_forward(obs: torch.Tensor, weights: tuple) -> MlpStages:
    """The MLP rollout kernel's forward on given observations ``obs``
    [N, F] float32, layer by layer: on a CUDA tensor one launch of the
    kernel's own device functions (`csrc/rollout_mlp.cu::ccka_mlp_forward`,
    observation tile -> torso -> head), on a CPU tensor its plain version
    :func:`mlp_stages`. ``weights``: :func:`_pack_mlp_tensors`' tuple;
    member 0 is used."""
    member = tuple(w[0] for w in weights)
    if obs.device.type == "cpu":
        return mlp_stages(obs, member)
    from ccka_tpu_torch.kernels import build

    N, F = obs.shape
    H, A = member[2].shape[0], member[4].shape[1]

    def empty(width, dtype):
        return torch.empty((N, width), dtype=dtype, device=obs.device)

    bf16, f32 = torch.bfloat16, torch.float32
    out = MlpStages(empty(F, bf16), empty(H, f32), empty(H, bf16),
                    empty(H, f32), empty(H, bf16), empty(A, f32))
    build.launch_mlp_forward(out, obs, weights)
    return out


# The summation bound of :func:`check_mlp_forward`: two float32 sums of
# n <= 128 terms in any two orders differ by at most 2 (n - 1) 2^-24
# times the sum of the terms' magnitudes, under 2^-16 of it.
MLP_SUM_BOUND = 2.0 ** -16
# `csrc/rollout_mlp.cu::kNearTie`: the kernel sums a hidden unit again as
# the plain chain when a bf16 rounding boundary lies within this share of
# its terms' magnitudes.
MLP_NEAR_TIE = 2.0 ** -20


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_mlp_forward(got: MlpStages, obs: torch.Tensor,
                      weights: tuple) -> dict:
    """The MLP kernel's forward (``got``, from :func:`mlp_forward`) held
    layer by layer against its plain version, each layer given the
    kernel's own input to it: ``x`` bitwise the plain normalization; each
    pre-activation within ``MLP_SUM_BOUND * sum_k |w[k][j] * in[k]|`` of
    the plain float32 chain (the tensor cores add in another order); each
    ``h`` bitwise ``gelu(bf16(bf16(pre) + b))`` of the kernel's own
    ``pre``; ``u`` bitwise the plain head on the kernel's ``h2``.
    ``weights`` as for :func:`mlp_forward`. Returns ``violations`` (check
    -> elements that fail it; all zero when the kernel holds), the share
    of ``h1``, ``h2`` and ``u`` bitwise the plain end-to-end forward,
    ``u``'s largest absolute difference from it, how much of the sum
    bound each layer uses at most, and the share of each layer's units
    within ``MLP_NEAR_TIE`` of a bf16 rounding boundary (the units the
    kernel sums again as the plain chain)."""
    w1, b1, w2, b2, w3, b3 = (w[0] for w in weights)
    plain = mlp_stages(obs, (w1, b1, w2, b2, w3, b3))
    violations = {"x": int((_bits(got.x) != _bits(plain.x)).sum())}
    bound_use, near_tie = {}, {}
    for name, inp, w, b, h_name in (("pre1", got.x, w1, b1, "h1"),
                                    ("pre2", got.h1, w2, b2, "h2")):
        pre = getattr(got, name)
        ref = _chained_product(inp.to(torch.float32), w.to(torch.float32))
        mag = inp.double().abs() @ w.double().abs()
        bound = MLP_SUM_BOUND * mag
        diff = (pre.double() - ref.double()).abs()
        violations[name] = int((diff > bound).sum())
        bound_use[name] = float((diff / bound.clamp_min(1e-300)).max())
        edges = [(pre.double() + s * MLP_NEAR_TIE * mag).to(torch.float32)
                 .to(torch.bfloat16) for s in (-1, 1)]
        near_tie[name] = float((_bits(edges[0]) != _bits(edges[1]))
                               .double().mean())
        violations[h_name] = int((_bits(getattr(got, h_name))
                                  != _bits(_gelu_layer(pre, b))).sum())
    head = _chained_product(got.h2.to(torch.float32), w3) + b3
    violations["u"] = int((_bits(got.u) != _bits(head)).sum())
    share = {f: float((_bits(getattr(got, f)) == _bits(getattr(plain, f)))
                      .double().mean())
             for f in ("h1", "h2", "u")}
    return {"violations": violations, "bitwise_share": share,
            "u_max_abs_diff": float((got.u - plain.u).abs().max()),
            "sum_bound_use": bound_use, "near_tie_share": near_tie}


def mlp_forward_departures(rep: dict) -> dict:
    """What a :func:`check_mlp_forward` report shows against the MLP
    kernel being bitwise its plain version: each layer whose sums differ
    from the plain chain by more than the kernel's near-tie window
    (``sum_bound_use`` above ``MLP_NEAR_TIE / MLP_SUM_BOUND``, where
    summing the near-tie units again no longer makes every unit round as
    the chain does), and each of ``h1``, ``h2``, ``u`` not wholly bitwise
    the plain end-to-end forward. Empty when the kernel was bitwise on
    these observations with its premise met."""
    limit = MLP_NEAR_TIE / MLP_SUM_BOUND
    out = {f"sum_bound_use_{k}": v for k, v in rep["sum_bound_use"].items()
           if v > limit}
    out.update({f"bitwise_share_{k}": v
                for k, v in rep["bitwise_share"].items() if v < 1.0})
    return out


def kernel_numerics_action_fn(net_params: dict, cluster: ClusterConfig,
                              params_sim: SimParams):
    """The MLP kernel's plain version: an ``action_fn`` for
    `sim/rollout.py` with the kernel's numerics, :func:`mlp_stages` on the
    observation, then the latent codec. It differs from
    `train/ppo.py::PPOBackend` only in where bfloat16 rounds.

    Every product is a chained float32 sum over k in ascending order
    (:func:`_chained_product`), not ``torch.matmul``, so the result does
    not depend on the device or the TF32 settings. The kernel's head adds
    in this order too (its float32 products round once each in a fused
    multiply-add on the card, as ``addcmul``'s do there). Its torso sums
    come from the tensor cores in their own order; it sums the chain again
    where a bfloat16 rounding boundary lies close, so each unit rounds to
    the side this version's chain rounds to while the two sums differ by
    less than that window (:func:`check_mlp_forward` holds each layer and
    :func:`mlp_forward_departures` names where the premise or the
    bitwise result fails)."""
    from ccka_tpu_torch.models.nets import latent_to_action
    from ccka_tpu_torch.policy.base import observe

    (_, _, _), was_single = _mlp_dims(
        net_params, P=cluster.n_pools, Z=cluster.n_zones)
    if not was_single:
        raise ValueError("kernel_numerics_action_fn takes one net, not a "
                         "population")
    dev = params_sim.dt_s.device
    weights = tuple(x[0] for x in _pack_mlp_tensors(net_params, dev))

    def action_fn(state, exo, t):
        obs = observe(params_sim, state, exo).flatten()
        return latent_to_action(mlp_stages(obs, weights).u, cluster)

    return action_fn


def population_plain_summary(params: SimParams, cluster: ClusterConfig,
                             net_params: dict, exo_packed: torch.Tensor,
                             T: int, seed: int = 0, *,
                             stochastic: bool = True,
                             cluster0: int = 0) -> EpisodeSummary:
    """The population MLP launch's plain version in one rollout: the NP
    members' B clusters as NP x B rows (member-major) of `sim/rollout.py`'s
    loop on the stream's worlds repeated per member, row ``m * B + b``
    drawing cluster ``cluster0 + b``'s interruptions, so every member sees
    the worlds it sees in the kernel. Fields come back [NP, B] (a single tree is a
    population of one). It runs the operations of
    :func:`kernel_numerics_action_fn` member by member at the cost of one
    member's loop."""
    from ccka_tpu_torch.models.nets import latent_to_action
    from ccka_tpu_torch.policy.base import observe
    from ccka_tpu_torch.sim.metrics import finalize_summary
    from ccka_tpu_torch.sim.rollout import (Carry, fresh_state,
                                            resume_rollout_summary)

    P, Z = cluster.n_pools, cluster.n_zones
    K = int(params.provision_pipeline_k)
    lanes = _check_packed(exo_packed, T, P, Z, K, params)
    (_, _, _), was_single = _mlp_dims(net_params, P=P, Z=Z)
    stacked = net_params if not was_single else _tree_map(
        lambda x: x[None], net_params)
    n_members = stacked["params"]["Dense_0"]["kernel"].shape[0]
    B = exo_packed.shape[2]
    dev = exo_packed.device

    def rep(tup):
        return None if tup is None else type(tup)(*(
            x.repeat(n_members, *([1] * (x.dim() - 1))) for x in tup))

    w1, b1, w2, b2, w3, b3 = _pack_mlp_tensors(stacked, dev)
    weights = (w1, b1[:, None], w2, b2[:, None], w3, b3[:, None])

    def action_fn(state, exo, t):
        # Each member's chains over its own B rows.
        obs = observe(params, state, exo).flatten()
        u = mlp_stages(obs.reshape(n_members, B, -1), weights).u
        return latent_to_action(u.reshape(n_members * B, -1), cluster)

    extra = {k: rep(v) for k, v in _unpack_lanes(exo_packed, T, Z,
                                                 lanes).items()}
    states0 = fresh_state(P, Z, K, n_members * B, dev)
    carry = resume_rollout_summary(
        params, Carry(states0, SummaryAcc.zero(n_members * B, dev), None,
                      None),
        action_fn, rep(unpack_exo(exo_packed, T, Z)), seed, tick0=0,
        cluster0=(int(cluster0) + torch.arange(B, device=dev)).repeat(
            n_members),
        stochastic=stochastic, **extra)
    summary = finalize_summary(params, states0, carry.state, carry.acc, T)
    return EpisodeSummary(*(x.reshape(n_members, B) for x in summary))


def neural_megakernel_rollout_summary(params: SimParams,
                                      cluster: ClusterConfig,
                                      net_params: dict,
                                      traces: ExogenousTrace, seed: int = 0,
                                      *, stochastic: bool = True,
                                      device=None) -> EpisodeSummary:
    """EpisodeSummary batch for fresh-state rollouts of the deterministic
    learned policy ``latent_to_action(actor_mean(obs))`` (PPOBackend's
    decide) fused into the kernel.

    ``net_params``: an ActorCritic params tree (the checkpoints' layout);
    a leading population axis on every leaf makes this one launch over
    (member, cluster) returning fields ``[NP, B]`` (a single tree gives
    ``[B]``). All members see the same world randomness, and the same seed
    pairs them with the rule and carbon kernels. ``cluster`` gives the
    SLO-pool mask of the fused feasibility projection."""
    dev = resolve_device(device)
    traces = traces.to(dev)
    T = traces.is_peak.shape[1]
    return neural_megakernel_summary_from_packed(
        _to(params, dev), cluster, net_params, _pack_exo(traces, T), T, seed,
        stochastic=stochastic)


def neural_megakernel_summary_from_packed(params: SimParams,
                                          cluster: ClusterConfig,
                                          net_params: dict,
                                          exo_packed: torch.Tensor, T: int,
                                          seed: int = 0, *,
                                          stochastic: bool = True,
                                          cluster0: int = 0
                                          ) -> EpisodeSummary:
    """Population-MLP EpisodeSummary from a packed stream: the packed
    analog of :func:`neural_megakernel_rollout_summary`. A CUDA stream
    launches the kernel once for the whole population and horizon; a CPU
    stream runs its plain version, :func:`population_plain_summary`.
    ``cluster0`` as for :func:`megakernel_summary_from_packed`."""
    from ccka_tpu_torch.models.nets import (AFTER_MAX_S, HPA_BIAS, HPA_HI,
                                            HPA_LO)
    from ccka_tpu_torch.policy.constraints import slo_pool_mask
    from ccka_tpu_torch.sim.random import seed_key

    P, Z = cluster.n_pools, cluster.n_zones
    K = int(params.provision_pipeline_k)
    lanes = _check_packed(exo_packed, T, P, Z, K, params)
    seed_key(seed)
    _check_cluster0(cluster0)
    (_, H, _), was_single = _mlp_dims(net_params, P=P, Z=Z)
    dev = exo_packed.device
    B = exo_packed.shape[2]
    if dev.type == "cpu":
        summary = population_plain_summary(params, cluster, net_params,
                                           exo_packed, T, seed,
                                           stochastic=stochastic,
                                           cluster0=cluster0)
    else:
        if H != 128:
            raise ValueError(f"the MLP rollout kernel is built for hidden "
                             f"width 128, not {H}")
        from ccka_tpu_torch.kernels import build

        weights = _pack_mlp_tensors(net_params, dev)
        n_members = weights[0].shape[0]
        out = torch.empty((n_members, _OUT_ROWS, B), dtype=torch.float32,
                          device=dev)
        build.launch_rollout_mlp(
            out, exo_packed, _pack_params(params).cpu().numpy().ravel(),
            slo_pool_mask(cluster, "cpu").numpy(),
            np.array([AFTER_MAX_S, HPA_LO, HPA_HI - HPA_LO, HPA_BIAS],
                     np.float32),
            weights, P=P, Z=Z, K=K, T=int(T), seed=int(seed),
            stochastic=bool(stochastic), fault_base=lanes.fault_base,
            wl_base=lanes.wl_base, wl_depth=lanes.wl_depth,
            b0=int(cluster0))
        neural_megakernel_summary_from_packed.launches += 1
        # Finalize all members at once: [NP, 24, B] -> [24, NP * B].
        flat = _finalize(params, out.permute(1, 0, 2).reshape(_OUT_ROWS, -1),
                         T)
        summary = EpisodeSummary(*(x.reshape(n_members, B) for x in flat))
    if was_single:
        summary = EpisodeSummary(*(x[0] for x in summary))
    return summary


neural_megakernel_summary_from_packed.launches = 0


def _tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Plan playback: a precomputed action per (cluster, tick), no policy.


def _plan_rows(P: int, Z: int) -> int:
    """Rows of a packed plan stream: the action coordinates padded to a
    multiple of 8 (16 on the default preset, 24 on multiregion)."""
    return math.ceil(_act_rows(P, Z) / 8) * 8


def pack_plan(actions: Action, T_pad: int) -> torch.Tensor:
    """An Action with leading [T] axes (one plan for every cluster) ->
    [T_pad, plan_rows]; with leading [B, T] axes (one plan per cluster,
    diff-MPC's receding-horizon output) -> [T_pad, plan_rows, B], the exo
    stream's feature-first layout. Coordinates in `_pack_action`'s order;
    padding rows and ticks beyond T are zero."""
    per_cluster = actions.zone_weight.dim() == 4
    P, Z = actions.zone_weight.shape[-2:]
    lead = tuple(actions.zone_weight.shape[:-2])
    flat = torch.cat([actions.zone_weight.reshape(*lead, -1),
                      actions.ct_allow.reshape(*lead, -1),
                      actions.consolidation_aggr, actions.consolidate_after_s,
                      actions.hpa_scale], dim=-1).to(torch.float32)
    rows, pr = _act_rows(P, Z), _plan_rows(P, Z)
    if per_cluster:
        B, T = lead
        out = torch.zeros((T_pad, pr, B), dtype=torch.float32,
                          device=flat.device)
        out[:T, :rows] = flat.permute(1, 2, 0)
    else:
        out = torch.zeros((T_pad, pr), dtype=torch.float32,
                          device=flat.device)
        out[:lead[0], :rows] = flat
    return out


def unpack_plan(plan_packed: torch.Tensor, T: int, P: int,
                Z: int) -> Action:
    """Inverse of :func:`pack_plan` as views: leaves [B, T, ...] for a
    per-cluster plan, [T, ...] for a broadcast one."""
    x = plan_packed[:T]
    if x.dim() == 3:
        x = x.permute(2, 0, 1)                              # [B, T, rows]
    lead = tuple(x.shape[:-1])
    cuts = np.cumsum([0, P * Z, 2 * P, P, P, 2])
    part = [x[..., a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    return Action(zone_weight=part[0].reshape(*lead, P, Z),
                  ct_allow=part[1].reshape(*lead, P, 2),
                  consolidation_aggr=part[2], consolidate_after_s=part[3],
                  hpa_scale=part[4])


def _check_plan(plan_packed: torch.Tensor, exo_packed: torch.Tensor, P: int,
                Z: int) -> bool:
    """Shape contract of a packed plan against its stream; returns whether
    the plan is per cluster."""
    T_pad, _rows, B = exo_packed.shape
    pr = _plan_rows(P, Z)
    if (plan_packed.dim() not in (2, 3) or plan_packed.shape[0] != T_pad
            or plan_packed.shape[1] != pr):
        raise ValueError(
            f"plan stream shape {tuple(plan_packed.shape)} does not match "
            f"the exo stream's T_pad={T_pad} / plan_rows={pr} for this "
            f"topology: pack with pack_plan(actions, T_pad)")
    if plan_packed.dim() == 3 and plan_packed.shape[2] != B:
        raise ValueError(f"per-cluster plan batch {plan_packed.shape[2]} != "
                         f"stream batch {B}")
    if plan_packed.device != exo_packed.device:
        raise ValueError(f"plan on {plan_packed.device}, stream on "
                         f"{exo_packed.device}")
    return plan_packed.dim() == 3


def plan_megakernel_rollout_summary(params: SimParams, plan_actions: Action,
                                    traces: ExogenousTrace, seed: int = 0,
                                    *, stochastic: bool = True,
                                    device=None) -> EpisodeSummary:
    """EpisodeSummary batch for fresh-state plan-playback rollouts: the
    action of every tick is read from ``plan_actions`` (leaves [T, ...],
    one plan for every cluster, or [B, T, ...], one per cluster), not
    chosen by a policy. The same function as `sim/rollout.py::
    rollout_actions` from fresh clusters, folded into its summary; the
    same ``seed`` pairs it with the rule, carbon and MLP kernels (one
    Philox stream, addressed by cluster and tick)."""
    dev = resolve_device(device)
    traces = traces.to(dev)
    B, T = traces.is_peak.shape
    per_cluster = plan_actions.zone_weight.dim() == 4
    t_axis = plan_actions.zone_weight.shape[1 if per_cluster else 0]
    if t_axis != T:
        raise ValueError(f"plan covers {t_axis} ticks, traces cover {T}: "
                         f"plan playback needs one action per tick")
    if per_cluster and plan_actions.zone_weight.shape[0] != B:
        raise ValueError(f"per-cluster plan batch "
                         f"{plan_actions.zone_weight.shape[0]} != trace "
                         f"batch {B}")
    P, Z = plan_actions.zone_weight.shape[-2:]
    return _plan_summary(_to(params, dev), P, Z,
                         pack_plan(_to(plan_actions, dev), T),
                         _pack_exo(traces, T), T, seed, stochastic)


def plan_megakernel_summary_from_packed(params: SimParams,
                                        cluster: ClusterConfig,
                                        plan_packed: torch.Tensor,
                                        exo_packed: torch.Tensor, T: int,
                                        seed: int = 0, *,
                                        stochastic: bool = True,
                                        cluster0: int = 0
                                        ) -> EpisodeSummary:
    """Plan-playback EpisodeSummary from already packed plan and exo
    streams (:func:`pack_plan`, `packed_trace_device`); ``cluster`` gives
    the topology. The stream may carry fault and workload lanes; a plan
    observes nothing, so only their dynamics apply. ``cluster0`` as for
    :func:`megakernel_summary_from_packed`."""
    return _plan_summary(params, cluster.n_pools, cluster.n_zones,
                         plan_packed, exo_packed, T, seed, stochastic,
                         cluster0)


plan_megakernel_summary_from_packed.launches = 0


def _plan_summary(params, P, Z, plan_packed, exo_packed, T, seed,
                  stochastic, cluster0: int = 0) -> EpisodeSummary:
    """The plan-playback rollout on packed streams: the kernel on a CUDA
    stream (a launch counted on `plan_megakernel_summary_from_packed`),
    the plain rollout on a CPU one."""
    from ccka_tpu_torch.sim.random import seed_key

    K = int(params.provision_pipeline_k)
    lanes = _check_packed(exo_packed, T, P, Z, K, params)
    batched = _check_plan(plan_packed, exo_packed, P, Z)
    seed_key(seed)
    _check_cluster0(cluster0)
    if exo_packed.device.type == "cpu":
        return _plain_rollout(params, P, Z, plan_action_fn(
            unpack_plan(plan_packed, T, P, Z), batched),
            unpack_exo(exo_packed, T, Z), seed, stochastic,
            cluster0=cluster0, **_unpack_lanes(exo_packed, T, Z, lanes))
    from ccka_tpu_torch.kernels import build

    out = torch.empty((_OUT_ROWS, exo_packed.shape[2]), dtype=torch.float32,
                      device=exo_packed.device)
    build.launch_rollout_plan(
        out, exo_packed, _pack_params(params).cpu().numpy().ravel(),
        plan_packed.contiguous(), P=P, Z=Z, K=K, T=int(T), seed=int(seed),
        stochastic=bool(stochastic), fault_base=lanes.fault_base,
        wl_base=lanes.wl_base, wl_depth=lanes.wl_depth, b0=int(cluster0))
    plan_megakernel_summary_from_packed.launches += 1
    return _finalize(params, out, T)


def plan_action_fn(plan: Action, per_cluster: bool):
    """The plan kernel's plain version as an ``action_fn``: tick t's row of
    ``plan`` (leaves [B, T, ...] per cluster, or [T, ...])."""
    if per_cluster:
        return lambda s, e, t: Action(*(x[:, t] for x in plan))
    return lambda s, e, t: Action(*(x[t] for x in plan))


# ---------------------------------------------------------------------------
# Carried state: one time block of a longer rollout (the CARRY
# instantiations), for the streaming pipeline (`sim/streaming.py`).

BLOCK_MODES = ("rule", "carbon", "neural", "plan")
# CarbonAwarePolicy's constants, the carbon mode's default.
_CARBON_DEFAULTS = (10.0, 0.05, 1.0)


class BlockSummaryFns(NamedTuple):
    """A rollout resumable across time blocks
    (:func:`packed_mode_block_summary_fn`)."""

    step: object
    init_state: object
    finalize: object
    n_blocks: int
    T_pad: int
    plain_step: object


def _carry_layout(params: SimParams, cluster: ClusterConfig, mode: str,
                  stream_rows: int):
    """The carried state's layout for ``mode`` on a stream of
    ``stream_rows`` rows: a policy that observes signals (carbon, neural)
    carries its held observation under fault lanes, and workload lanes
    carry the queues."""
    from ccka_tpu_torch.sim.lanes import stream_layout
    from ccka_tpu_torch.sim.rollout import CarryLayout

    _lanes.resolve_mode(mode)
    P, Z = cluster.n_pools, cluster.n_zones
    faults, wl = stream_layout(stream_rows, Z)
    return CarryLayout(P, Z, int(params.provision_pipeline_k),
                       held=faults and mode in ("carbon", "neural"),
                       wl_depth=int(params.wl_batch_deadline_ticks)
                       if wl else 0)


def block_state_rows(params: SimParams, cluster: ClusterConfig, mode: str,
                     stream_rows: int) -> int:
    """Rows of the carried state for ``mode`` on a stream with
    ``stream_rows`` rows (`sim/rollout.py::CarryLayout`, padded to a
    multiple of 8): the lanes the stream carries decide the layout."""
    return _carry_layout(params, cluster, mode, stream_rows).rows


def init_block_state(params: SimParams, cluster: ClusterConfig, mode: str,
                     stream_rows: int, batch: int, *,
                     n_pop: int | None = None,
                     device=None) -> torch.Tensor:
    """The carried state of fresh clusters (all zeros: what the non-carry
    kernels start from): ``[rows, B]``, or ``[NP, rows, B]`` for the
    population ("neural") kernel."""
    rows = block_state_rows(params, cluster, mode, stream_rows)
    shape = (rows, batch) if n_pop is None else (n_pop, rows, batch)
    return torch.zeros(shape, dtype=torch.float32,
                       device=resolve_device(device))


def packed_mode_block_summary_fn(params: SimParams, cluster: ClusterConfig,
                                 mode: str, *, T: int, block_T: int,
                                 t_chunk: int = 64, stochastic: bool = True,
                                 net_params=None, plan_packed=None
                                 ) -> BlockSummaryFns:
    """The carried-state closures of ``mode`` ("rule", "carbon",
    "neural", "plan") for a rollout of ``T`` ticks in ``block_T``-tick
    blocks (`sim/lanes.py::block_layout`):

    - ``step(stream_block, state, j, seed, *, state_out, cluster0=0) ->
      (out, state_out)`` runs block ``j`` ([block_T, rows, B], global
      ticks ``j * block_T`` on, the ticks before ``T``) from the carried
      ``state`` and writes the state after it into ``state_out``, a
      buffer of the caller's of the same shape (a drive alternates two).
      On a CUDA stream it launches the CARRY instantiation of the mode's
      kernel; on a CPU stream it runs the kernel's plain version,
      `sim/rollout.py::resume_rollout_summary`, between `unpack_carry`
      and `pack_carry`. ``out`` is a view of the accumulator rows of
      ``state_out``, meaningful after the last block. ``cluster0`` is the
      global index of the block's first cluster (a chunk of a larger
      fleet).
    - ``plain_step``: ``step`` with the plain version on any device (the
      CARRY kernels' oracle on the card; nothing on the streaming path
      calls it there).
    - ``init_state(stream_rows, batch, device=None)``: the fresh carried
      state for the stream's lanes.
    - ``finalize(out)``: the EpisodeSummary batch (`_finalize` with the
      global ``T``; fields [NP, B] for a population, [B] for one net).

    Blocked equals unblocked bitwise: the same tick arithmetic, the
    global tick and the global cluster in the Philox counter and the
    clocks, and a state that crosses blocks as float32 rows. The JAX
    package's ``block_chunk_seed`` has no counterpart: the port's Philox
    stream is addressed by the global tick and cluster, so no seed
    arithmetic is needed.

    ``params`` lies on the streams' device. ``plan_packed`` (mode "plan"):
    the whole horizon's packed plan, ``pack_plan(actions, T_pad)``; None
    plays the neutral profile broadcast to every cluster. Mode "carbon"
    runs CarbonAwarePolicy's constants. ``net_params`` (mode "neural"):
    an ActorCritic params tree, a leading population axis allowed.
    """
    return _lanes.mode_engine(mode, "block_summary")(
        params, cluster, T=T, block_T=block_T, t_chunk=t_chunk,
        stochastic=stochastic, net_params=net_params,
        plan_packed=plan_packed)


def _block_summary_fns(mode: str, params: SimParams, cluster: ClusterConfig,
                       *, T: int, block_T: int, t_chunk: int = 64,
                       stochastic: bool = True, net_params=None,
                       plan_packed=None) -> BlockSummaryFns:
    """The "block_summary" engine of the four built-in modes (the
    registry's entry behind :func:`packed_mode_block_summary_fn`)."""
    from ccka_tpu_torch.kernels import build
    from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
    from ccka_tpu_torch.sim.lanes import block_layout
    from ccka_tpu_torch.sim.random import seed_key
    from ccka_tpu_torch.sim.rollout import (N_ACC_ROWS, pack_carry,
                                            resume_rollout_summary,
                                            unpack_carry)

    n_blocks, T_pad = block_layout(T, block_T, t_chunk)
    P, Z = cluster.n_pools, cluster.n_zones
    K = int(params.provision_pipeline_k)
    dev = params.dt_s.device
    params_np = _pack_params(params).cpu().numpy().ravel()
    off, peak = offpeak_action(cluster, dev), peak_action(cluster, dev)
    cstat = _CARBON_DEFAULTS if mode == "carbon" else None
    acts_np = torch.stack([_pack_action(off),
                           _pack_action(peak)]).cpu().numpy()
    n_pop, members, H, was_single = None, None, None, False
    if mode == "neural":
        if net_params is None:
            raise ValueError("packed_mode_block_summary_fn: mode 'neural' "
                             "needs net_params")
        (_, H, _), was_single = _mlp_dims(net_params, P=P, Z=Z)
        stacked = net_params if not was_single else _tree_map(
            lambda x: np.asarray(x)[None], net_params)
        n_pop = int(stacked["params"]["Dense_0"]["kernel"].shape[0])
        members = [_tree_map(lambda x: np.asarray(x)[i], stacked)
                   for i in range(n_pop)]
    if mode == "plan":
        if plan_packed is None:
            plan_packed = _neutral_plan(cluster, T_pad, dev)
        if (plan_packed.dim() not in (2, 3) or plan_packed.shape[0] != T_pad
                or plan_packed.shape[1] != _plan_rows(P, Z)):
            raise ValueError(
                f"plan stream shape {tuple(plan_packed.shape)} does not "
                f"match T_pad={T_pad} / plan_rows={_plan_rows(P, Z)} — pack "
                f"with pack_plan(actions, T_pad)")
        plan_packed = plan_packed.contiguous()
    cache = {}   # per device: the MLP's kernel tensors

    def checked(stream_block, state, state_out, j, seed):
        """(t0, ticks, lanes, layout) of block ``j``, or raise."""
        if stream_block.shape[0] != block_T:
            raise ValueError(
                f"stream block covers {stream_block.shape[0]} ticks, the "
                f"blocked layout needs exactly block_T={block_T} — "
                f"generate with packed_block_trace_device(block_T, ...)")
        if not 0 <= j < n_blocks:
            raise ValueError(f"block {j} is outside the {n_blocks} blocks")
        t0 = j * block_T
        n = min(block_T, T - t0)
        lanes = _check_packed(stream_block, n, P, Z, K, params)
        layout = _carry_layout(params, cluster, mode, stream_block.shape[1])
        want = ((layout.rows, stream_block.shape[2]) if n_pop is None
                else (n_pop, layout.rows, stream_block.shape[2]))
        for name, s in (("carried state", state), ("state_out", state_out)):
            if (tuple(s.shape) != want or s.device != stream_block.device
                    or s.dtype != torch.float32):
                raise ValueError(f"{name} {list(s.shape)} on {s.device} "
                                 f"does not fit this stream: want float32 "
                                 f"{list(want)} on {stream_block.device} "
                                 f"(init_state)")
        if state.data_ptr() == state_out.data_ptr():
            raise ValueError("state_out must be another buffer than the "
                             "carried state")
        seed_key(seed)
        return t0, n, lanes, layout

    def plain_step(stream_block, state, j, seed, *, state_out,
                   cluster0: int = 0):
        t0, n, lanes, layout = checked(stream_block, state, state_out, j,
                                       seed)
        traces = unpack_exo(stream_block, n, Z)
        extra = _unpack_lanes(stream_block, n, Z, lanes)
        for m in range(1 if n_pop is None else n_pop):
            if mode == "neural":
                fn = kernel_numerics_action_fn(members[m], cluster, params)
            elif mode == "plan":
                blk = plan_packed[t0:t0 + n]
                fn = plan_action_fn(unpack_plan(blk, n, P, Z),
                                    blk.dim() == 3)
            else:
                fn = _profile_action_fn(off, peak, cstat)
            s_in = state if n_pop is None else state[m]
            carry = resume_rollout_summary(
                params, unpack_carry(s_in, layout, params, t0), fn, traces,
                seed, tick0=t0, cluster0=cluster0, stochastic=stochastic,
                observe=mode != "plan", **extra)
            pack_carry(carry, layout,
                       state_out if n_pop is None else state_out[m])
        return state_out[..., :N_ACC_ROWS, :], state_out

    def step(stream_block, state, j, seed, *, state_out, cluster0: int = 0):
        if stream_block.device.type == "cpu":
            return plain_step(stream_block, state, j, seed,
                              state_out=state_out, cluster0=cluster0)
        t0, n, lanes, layout = checked(stream_block, state, state_out, j,
                                       seed)
        bc = build.BlockCarry(state, state_out, t0, cluster0)
        kw = dict(P=P, Z=Z, K=K, T=n, seed=int(seed),
                  stochastic=bool(stochastic),
                  fault_base=lanes.fault_base, wl_base=lanes.wl_base,
                  wl_depth=lanes.wl_depth, carry=bc)
        if mode == "neural":
            from ccka_tpu_torch.models.nets import (AFTER_MAX_S,
                                                    HPA_BIAS, HPA_HI,
                                                    HPA_LO)
            from ccka_tpu_torch.policy.constraints import slo_pool_mask

            if H != 128:
                raise ValueError(f"the MLP rollout kernel is built for "
                                 f"hidden width 128, not {H}")
            key = stream_block.device
            if key not in cache:
                cache[key] = _pack_mlp_tensors(net_params, key)
            build.launch_rollout_mlp(
                None, stream_block, params_np,
                slo_pool_mask(cluster, "cpu").numpy(),
                np.array([AFTER_MAX_S, HPA_LO, HPA_HI - HPA_LO,
                          HPA_BIAS], np.float32), cache[key], **kw)
        elif mode == "plan":
            build.launch_rollout_plan(None, stream_block, params_np,
                                      plan_packed[t0:t0 + block_T], **kw)
        else:
            build.launch_rollout_profiles(None, stream_block, params_np,
                                          acts_np, carbon=cstat, **kw)
        return state_out[..., :N_ACC_ROWS, :], state_out

    def init_state(stream_rows, batch, device=None):
        return init_block_state(params, cluster, mode, stream_rows, batch,
                                n_pop=n_pop, device=device)

    def finalize(out):
        if n_pop is None:
            return _finalize(params, out, T)
        flat = _finalize(params, out.permute(1, 0, 2).reshape(
            out.shape[1], -1), T)
        summary = EpisodeSummary(*(x.reshape(n_pop, out.shape[2])
                                   for x in flat))
        if was_single:
            summary = EpisodeSummary(*(x[0] for x in summary))
        return summary

    return BlockSummaryFns(step, init_state, finalize, n_blocks, T_pad,
                           plain_step)


def _neutral_plan(cluster: ClusterConfig, T_pad: int, device) -> torch.Tensor:
    """The neutral profile broadcast to every cluster and tick, packed."""
    from ccka_tpu_torch.policy.rule import neutral_action

    base = neutral_action(cluster, device)
    return pack_plan(Action(*(x.expand((T_pad,) + tuple(x.shape))
                              for x in base)), T_pad)


def packed_mode_summary(params: SimParams, cluster: ClusterConfig, mode: str,
                        exo_packed: torch.Tensor, T: int, seed: int = 0, *,
                        stochastic: bool = True, net_params=None,
                        plan_packed=None,
                        cluster0: int = 0) -> EpisodeSummary:
    """The non-carry entry of ``mode`` on a whole packed stream (the
    kernel on a CUDA stream, the plain version on a CPU one): the
    unblocked side of the blocked == unblocked comparison. Arguments as
    for :func:`packed_mode_block_summary_fn`; ``cluster0`` the global
    index of the stream's first cluster."""
    extra = {"cluster0": cluster0} if cluster0 else {}
    return _lanes.mode_engine(mode, "packed_summary")(
        params, cluster, exo_packed, T, seed, stochastic=stochastic,
        net_params=net_params, plan_packed=plan_packed, **extra)


def packed_mode_summary_fn(params: SimParams, cluster: ClusterConfig,
                           mode: str, *, T: int, stochastic: bool = True,
                           net_params=None, plan_packed=None):
    """``(stream, seed) -> EpisodeSummary``: :func:`packed_mode_summary`
    of ``mode`` closed over its arguments, the unit the scenario search
    scores with (`search/adversarial.py`). The mode is resolved here, so
    an unknown one is refused before any stream is made. (The JAX
    package's ``b_block`` and ``t_chunk`` set its kernel grid; the port's
    kernels take a whole stream in one launch.)"""
    engine = _lanes.mode_engine(mode, "packed_summary")

    def fn(stream: torch.Tensor, seed: int) -> EpisodeSummary:
        return engine(params, cluster, stream, T, seed,
                      stochastic=stochastic, net_params=net_params,
                      plan_packed=plan_packed)

    return fn


def _packed_summary(mode: str, params: SimParams, cluster: ClusterConfig,
                    exo_packed: torch.Tensor, T: int, seed: int = 0, *,
                    stochastic: bool = True, net_params=None,
                    plan_packed=None, cluster0: int = 0) -> EpisodeSummary:
    """The "packed_summary" engine of the four built-in modes (the
    registry's entry behind :func:`packed_mode_summary`)."""
    from ccka_tpu_torch.policy.rule import offpeak_action, peak_action

    dev = exo_packed.device
    kw = dict(seed=seed, stochastic=stochastic, cluster0=cluster0)
    if mode in ("rule", "carbon"):
        off, peak = offpeak_action(cluster, dev), peak_action(cluster, dev)
        if mode == "rule":
            return megakernel_summary_from_packed(params, off, peak,
                                                  exo_packed, T, **kw)
        sharp, floor, stick = _CARBON_DEFAULTS
        return carbon_megakernel_summary_from_packed(
            params, off, peak, exo_packed, T, sharpness=sharp,
            min_weight=floor, stickiness=stick, **kw)
    if mode == "neural":
        return neural_megakernel_summary_from_packed(
            params, cluster, net_params, exo_packed, T, **kw)
    if mode == "plan":
        if plan_packed is None:
            plan_packed = _neutral_plan(cluster, exo_packed.shape[0], dev)
        return plan_megakernel_summary_from_packed(
            params, cluster, plan_packed.contiguous(), exo_packed, T, **kw)
    raise ValueError(f"unknown packed mode {mode!r} — have {BLOCK_MODES}")


# The four built-in modes, registered once (`sim/lanes.py` mode registry).
for _mode in BLOCK_MODES:
    _lanes.register_mode(
        _mode, packed_summary=functools.partial(_packed_summary, _mode),
        block_summary=functools.partial(_block_summary_fns, _mode))
del _mode
