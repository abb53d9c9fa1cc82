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
  (`csrc/rollout_mlp.cu`): :func:`neural_megakernel_rollout_summary`.

Contract: each is the same function as ``batched_rollout_summary(params,
initial_state(...), action_fn, traces, seed, stochastic=...)``
(`sim/rollout.py`) under ``RulePolicy``, ``CarbonAwarePolicy`` or
:func:`kernel_numerics_action_fn`. All draw their spot interruptions from
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

Device rule: a stream on a CUDA device launches the kernel (or raises); a
stream on the CPU runs the plain version. Each ``*_summary_from_packed``
entry counts its kernel launches in its ``launches`` attribute.

As in the JAX package, workload class c consumes capacity type c
(``SimParams.class_ct`` is the identity by construction).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import ClusterConfig
from ccka_tpu_torch.signals.base import ExogenousTrace
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
                                   stochastic: bool = True) -> EpisodeSummary:
    """Rule-profile EpisodeSummary from a packed ``[T_pad, exo_rows, B]``
    stream (``T`` is the true horizon). A CUDA stream launches the kernel;
    a CPU stream runs the plain rollout on the unpacked views."""
    return _profiles_summary(megakernel_summary_from_packed, params,
                             off_action, peak_action, exo_packed, T, seed,
                             stochastic, None)


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
                                          stochastic: bool = True
                                          ) -> EpisodeSummary:
    """CarbonAwarePolicy EpisodeSummary from a packed stream: the packed
    analog of :func:`carbon_megakernel_rollout_summary`."""
    return _profiles_summary(
        carbon_megakernel_summary_from_packed, params, off_action,
        peak_action, exo_packed, T, seed, stochastic,
        (float(sharpness), float(min_weight), float(stickiness)))


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
                      seed, stochastic, carbon) -> EpisodeSummary:
    """The rule (``carbon`` None) or carbon-aware rollout on a packed
    stream; a kernel launch is counted on ``entry``."""
    from ccka_tpu_torch.sim.random import seed_key

    P, Z = off_action.zone_weight.shape
    K = int(params.provision_pipeline_k)
    lanes = _check_packed(exo_packed, T, P, Z, K, params)
    seed_key(seed)  # range check: the kernel keys Philox by its 64 bits
    if exo_packed.device.type == "cpu":
        return _plain_summary(params, off_action, peak_action,
                              unpack_exo(exo_packed, T, Z), seed, stochastic,
                              carbon, **_unpack_lanes(exo_packed, T, Z,
                                                      lanes))
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
        wl_depth=lanes.wl_depth)
    entry.launches += 1
    return _finalize(params, out, T)


def _plain_rollout(params, P, Z, action_fn, traces, seed, stochastic,
                   faults=None, workloads=None):
    """`sim/rollout.py`'s rollout of fresh clusters under ``action_fn``,
    with the stream's lanes when it has them."""
    from ccka_tpu_torch.sim.rollout import (batched_rollout_summary,
                                            fresh_state)

    states0 = fresh_state(P, Z, int(params.provision_pipeline_k),
                          traces.is_peak.shape[0], traces.is_peak.device)
    return batched_rollout_summary(params, states0, action_fn, traces, seed,
                                   stochastic=stochastic, faults=faults,
                                   workloads=workloads)[1]


def _plain_summary(params, off, peak, traces, seed, stochastic, carbon=None,
                   faults=None, workloads=None):
    """The profile kernel's plain version: the rule-policy rollout from
    fresh clusters, or with ``carbon`` the CarbonAwarePolicy's zone
    weights over the same two profiles."""
    from ccka_tpu_torch.policy.carbon import carbon_aware_action
    from ccka_tpu_torch.policy.rule import select_profile

    def rule(s, e, t):
        return select_profile(e.is_peak, off, peak)

    def carbon_aware(s, e, t):
        return carbon_aware_action(off, peak, s, e, sharpness=carbon[0],
                                   min_weight=carbon[1], stickiness=carbon[2])

    P, Z = off.zone_weight.shape
    return _plain_rollout(params, P, Z, rule if carbon is None
                          else carbon_aware, traces, seed, stochastic,
                          faults, workloads)


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
    keep the tree's [in, out] layout; a single tree gets NP = 1."""
    pp = net_params["params"]

    def leaf(layer, name, dtype):
        x = torch.as_tensor(np.asarray(pp[layer][name], np.float32),
                            device=device)
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
    CUDA kernel's thread adds."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[0]):
        acc = torch.addcmul(acc, x[:, k:k + 1], w[k:k + 1])
    return acc


def kernel_numerics_action_fn(net_params: dict, cluster: ClusterConfig,
                              params_sim: SimParams):
    """The MLP kernel's plain version: an ``action_fn`` for
    `sim/rollout.py` with the kernel's numerics (log1p-normalized
    observation in bfloat16; two torso layers whose float32 sums are
    rounded once to bfloat16, the bias added in bfloat16 and the tanh-form
    GELU computed operation by operation in bfloat16, `models/nets.py
    ::gelu_tanh`; a float32 head; the latent codec). It
    differs from `train/ppo.py::PPOBackend` only in where bfloat16 rounds.

    Every product is a chained float32 sum over k in ascending order
    (:func:`_chained_product`), not ``torch.matmul``: a product of two
    bfloat16 values is exact in float32, so the torso sums equal the
    kernel's bit for bit on any device and whatever the TF32 settings;
    the head's float32 products round once each in a fused multiply-add on
    the card, as the kernel's do."""
    from ccka_tpu_torch.models.nets import (_normalize_obs, gelu_tanh,
                                            latent_to_action)
    from ccka_tpu_torch.policy.base import observe

    (_, _, _), was_single = _mlp_dims(
        net_params, P=cluster.n_pools, Z=cluster.n_zones)
    if not was_single:
        raise ValueError("kernel_numerics_action_fn takes one net, not a "
                         "population")
    dev = params_sim.dt_s.device
    w1, b1, w2, b2, w3, b3 = (x[0] for x in _pack_mlp_tensors(net_params,
                                                               dev))
    w1f, w2f = w1.to(torch.float32), w2.to(torch.float32)

    def action_fn(state, exo, t):
        obs = observe(params_sim, state, exo).flatten()
        x = _normalize_obs(obs).to(torch.bfloat16)
        h = gelu_tanh(_chained_product(x.to(torch.float32), w1f)
                      .to(torch.bfloat16) + b1)
        h = gelu_tanh(_chained_product(h.to(torch.float32), w2f)
                      .to(torch.bfloat16) + b2)
        u = _chained_product(h.to(torch.float32), w3) + b3
        return latent_to_action(u, cluster)

    return action_fn


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
                                          stochastic: bool = True
                                          ) -> EpisodeSummary:
    """Population-MLP EpisodeSummary from a packed stream: the packed
    analog of :func:`neural_megakernel_rollout_summary`. A CUDA stream
    launches the kernel once for the whole population and horizon; a CPU
    stream runs :func:`kernel_numerics_action_fn` member by member."""
    from ccka_tpu_torch.models.nets import (AFTER_MAX_S, HPA_BIAS, HPA_HI,
                                            HPA_LO)
    from ccka_tpu_torch.policy.constraints import slo_pool_mask
    from ccka_tpu_torch.sim.random import seed_key

    P, Z = cluster.n_pools, cluster.n_zones
    K = int(params.provision_pipeline_k)
    lanes = _check_packed(exo_packed, T, P, Z, K, params)
    seed_key(seed)
    (_, H, _), was_single = _mlp_dims(net_params, P=P, Z=Z)
    dev = exo_packed.device
    B = exo_packed.shape[2]
    if dev.type == "cpu":
        stacked = net_params if not was_single else _tree_map(
            lambda x: np.asarray(x)[None], net_params)
        n_members = stacked["params"]["Dense_0"]["kernel"].shape[0]
        traces = unpack_exo(exo_packed, T, Z)
        extra = _unpack_lanes(exo_packed, T, Z, lanes)
        members = [_plain_rollout(
            params, P, Z, kernel_numerics_action_fn(
                _tree_map(lambda x: np.asarray(x)[i], stacked), cluster,
                params), traces, seed, stochastic, **extra)
            for i in range(n_members)]
        summary = EpisodeSummary(*(torch.stack(xs) for xs in zip(*members)))
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
            wl_base=lanes.wl_base, wl_depth=lanes.wl_depth)
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
