"""The cluster dynamics step, batch-first: one 30 s control tick.

The PyTorch form of `ccka_tpu/sim/dynamics.py`: pod scheduling,
provisioning with delay, spot interruption, consolidation, and
cost/carbon/SLO accounting, for a batch of clusters at once (every tensor
leads with B), with the optional fault disturbances and workload-family
queues.

Arithmetic order is part of the contract. Sums over the small pool, zone
and capacity-type axes are written as one left-to-right chain
(:func:`seqsum`), and the softmax is spelled out, so that the CUDA kernels'
tick (`csrc/rollout_tick.cuh`), which steps one cluster per thread in
registers, can add in the same order and round alike. The step is
differentiable in deterministic mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ccka_tpu_torch.config import LATENCY_CURVE_COEF, LATENCY_RHO_CLIP
from ccka_tpu_torch.sim.types import (CT_OD, CT_SPOT, Action, ClusterState,
                                      SimParams, StepMetrics)

_EPS = 1e-6


_BOUNDS: dict = {}


def _bound(value: float, dtype: torch.dtype) -> torch.Tensor:
    """``value`` as a 0-dim CPU tensor of ``dtype``, made once. Beside a
    CUDA tensor a binary operation reads it as a scalar, so a bound costs
    no fill kernel (and a CUDA graph bakes it in)."""
    key = (float(value).hex(), dtype)   # hex keeps -0.0 apart from 0.0
    b = _BOUNDS.get(key)
    if b is None:
        b = _BOUNDS[key] = torch.tensor(value, dtype=dtype)
    return b


def clip(x: torch.Tensor, lo: float | None = None,
         hi: float | None = None) -> torch.Tensor:
    """``jnp.clip``'s form: ``maximum(x, lo)``, then ``minimum(., hi)``.
    The values of ``torch.clamp``, but at a tie each side takes half the
    gradient, as in JAX; ``torch.clamp`` passes all of it to ``x``."""
    if lo is not None:
        x = torch.maximum(x, _bound(lo, x.dtype))
    if hi is not None:
        x = torch.minimum(x, _bound(hi, x.dtype))
    return x


def seqsum(x: torch.Tensor, dims) -> torch.Tensor:
    """Sum over ``dims`` as one left-to-right chain of adds, in row-major
    order of the summed axes: a fixed association on every device."""
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    rest = [d for d in range(nd) if d not in dims]
    y = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    parts = y.unbind(-1)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _poisson_small(u3: torch.Tensor, lam: torch.Tensor,
                   cap: torch.Tensor) -> torch.Tensor:
    """Elementwise Poisson(lam) sample, capped by ``cap``, from three
    uniforms per element (``u3[0]``, ``u3[1]``, ``u3[2]``; see
    `sim/random.py`): truncated CDF inversion over the first five terms
    below lam = 0.5, a rounded moment-matched Box-Muller Gaussian above
    (u1 clamped at 1e-7). The TPU kernel's sampler
    (`ccka_tpu/sim/megakernel.py::_poisson_small_kernel`); rounding is
    half-to-even."""
    u = u3[0]
    t = torch.exp(-lam)
    cdf = t
    count = torch.zeros_like(lam)
    for k in (1, 2, 3, 4):
        count = count + (u > cdf).to(lam.dtype)
        t = t * lam / k
        cdf = cdf + t
    u1 = clip(u3[1], 1e-7)
    normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        2.0 * math.pi * u3[2])
    gauss = torch.round(lam + torch.sqrt(lam) * normal)
    sample = torch.where(lam < 0.5, count, clip(gauss, 0.0))
    return torch.minimum(sample, cap)


class ExoStep(NamedTuple):
    """One tick of exogenous signals for a batch."""

    spot_price_hr: torch.Tensor  # [B, Z]
    od_price_hr: torch.Tensor    # [B, Z]
    carbon_g_kwh: torch.Tensor   # [B, Z]
    demand_pods: torch.Tensor    # [B, C]
    is_peak: torch.Tensor        # [B]


def _softmax_zones(x: torch.Tensor) -> torch.Tensor:
    """Softmax over axis 1 of [B, Z, T_CT], max-shifted, sums chained."""
    parts = x.unbind(1)
    m = parts[0]
    for p in parts[1:]:
        m = torch.maximum(m, p)
    e = torch.exp(x - m[:, None, :])
    return e / seqsum(e, (1,))[:, None, :]


def step(params: SimParams, state: ClusterState, action: Action,
         exo: ExoStep, u3: torch.Tensor | None = None, *,
         stochastic: bool = False, fault=None, workload=None,
         wl_state=None):
    """Advance every cluster of the batch one tick; returns
    ``(state, metrics)``.

    ``action`` leaves are either shared ([P, Z], ...) or per cluster
    ([B, P, Z], ...). ``u3`` ([3, B, P, Z] uniforms, `sim/random.py`) is
    required in stochastic mode and ignored otherwise.

    ``fault``: an optional `faults.types.FaultStep` (leaves shared or per
    cluster): the hazard scales the interruption probability (clipped at
    1), ``delay_frac`` of the arrivals goes back to the pipeline's head,
    ``deny_frac`` of the spot request is denied. Signal staleness is an
    observation effect the rollout applies; this step consumes true
    ``exo``. ``workload``/``wl_state``: optional
    `workloads.types.WorkloadStep` arrivals and `WorkloadState` queues,
    both or neither; the queues drain from the post-step fleet's headroom
    (inference first, then batch earliest deadline first over the
    D-deep age pipeline, then background), and the step returns
    ``(state, metrics, wl_state)``. ``None`` takes the program without
    faults or workloads, bitwise; a neutral FaultStep, or zero arrivals,
    leave the other fields bitwise as well.
    """
    if (workload is None) != (wl_state is None):
        raise ValueError("step: pass both workload= and wl_state=, or "
                         "neither")
    B, P, Z = state.nodes.shape[:3]

    def per_cluster(x, nd):
        return x if x.dim() == nd + 1 else x.expand(B, *x.shape)

    zone_weight = per_cluster(action.zone_weight, 2)         # [B, P, Z]
    ct_allow = per_cluster(action.ct_allow, 2)               # [B, P, CT]
    aggr = per_cluster(action.consolidation_aggr, 1)         # [B, P]
    after = per_cluster(action.consolidate_after_s, 1)       # [B, P]
    hpa = per_cluster(action.hpa_scale, 1)                   # [B, C]

    ppn = params.pods_per_node
    dt_hr = params.dt_s / 3600.0

    # ---- 1. Desired pods: demand scaled by the HPA lever.
    desired = exo.demand_pods * hpa                          # [B, C]

    # ---- 2. Provisioning pipeline arrivals; under a fault, a share of
    # them is held back at the head of the shifted pipeline.
    arrivals = state.pipeline[:, 0]                          # [B, P, Z, CT]
    pipeline = torch.cat([state.pipeline[:, 1:],
                          torch.zeros_like(state.pipeline[:, :1])], dim=1)
    if fault is not None:
        delay = per_cluster(fault.delay_frac, 0)[:, None, None, None]
        held = arrivals * delay
        nodes = state.nodes + (arrivals - held)
        pipeline = torch.cat([(pipeline[:, 0] + held)[:, None],
                              pipeline[:, 1:]], dim=1)
    else:
        nodes = state.nodes + arrivals

    # ---- 3. Spot interruptions; a fault's hazard scales the per-zone
    # probability, clipped at 1.
    spot_nodes = nodes[..., CT_SPOT]                         # [B, P, Z]
    if fault is not None:
        p_z = clip(params.interrupt_p_step
                   * per_cluster(fault.preempt_hazard, 1), hi=1.0)
        mean_int = spot_nodes * p_z[:, None, :]
    else:
        mean_int = spot_nodes * params.interrupt_p_step
    if stochastic:
        if u3 is None:
            raise ValueError("step: stochastic mode needs the uniforms u3")
        interrupted = _poisson_small(u3, mean_int, spot_nodes)
    else:
        interrupted = mean_int
    nodes = torch.stack([spot_nodes - interrupted, nodes[..., CT_OD]], -1)
    interrupted_total = seqsum(interrupted, (1, 2))          # [B]

    # ---- 4. Scheduling; the base nodegroup adds on-demand capacity.
    nodes_ct = seqsum(nodes, (1, 2))                         # [B, CT]
    cap_ct = nodes_ct * ppn
    cap_ct = torch.stack([cap_ct[:, CT_SPOT],
                          cap_ct[:, CT_OD] + params.base_od_nodes * ppn], -1)
    cap_class = cap_ct @ params.class_ct.T                   # [B, C]
    running = torch.minimum(desired, cap_class)
    pending = desired - running

    # ---- 5. Provisioning: pending pods, discounted by capacity in
    # flight, split over (pool, zone, ct) by the action x cheapest-fit.
    incoming_ct = seqsum(pipeline, (1, 2, 3))                # [B, CT]
    shortage_ct = pending @ params.class_ct                  # [B, CT]
    need_nodes_ct = clip(shortage_ct / ppn - incoming_ct, 0.0)

    price_zc = torch.stack([exo.spot_price_hr, exo.od_price_hr], -1)
    price_mean = seqsum(price_zc, (1, 2)) / (2 * Z)          # [B]
    cheap = _softmax_zones(
        -price_zc / (0.1 * price_mean + _EPS)[:, None, None])  # [B, Z, CT]
    allow = ct_allow * params.static_ct_allow                # [B, P, CT]
    w = (zone_weight[:, :, :, None] * allow[:, :, None, :]
         * cheap[:, None, :, :])                             # [B, P, Z, CT]
    wsum = seqsum(w, (1, 2))[:, None, None, :]
    frac = torch.where(wsum > _EPS, w / (wsum + _EPS), 0.0)
    new_nodes = frac * need_nodes_ct[:, None, None, :]

    # Per-pool cap: scale a pool's share down to its headroom.
    pool_now = seqsum(nodes, (2, 3)) + seqsum(pipeline, (1, 3, 4))  # [B, P]
    pool_new = seqsum(new_nodes, (2, 3))
    headroom = clip(params.max_nodes - pool_now, 0.0)
    scale = torch.where(pool_new > _EPS,
                        clip(headroom / (pool_new + _EPS), hi=1.0),
                        1.0)
    new_nodes = new_nodes * scale[:, :, None, None]
    # Insufficient capacity: the spot share of the request is denied and
    # not requested; the pending pods ask again next tick.
    if fault is not None:
        deny = per_cluster(fault.deny_frac, 0)
        spot_new = new_nodes[..., CT_SPOT]
        denied = seqsum(spot_new, (1, 2)) * deny
        new_nodes = torch.stack([spot_new * (1.0 - deny)[:, None, None],
                                 new_nodes[..., CT_OD]], -1)
    pipeline = torch.cat([pipeline[:, :-1],
                          (pipeline[:, -1] + new_nodes)[:, None]], dim=1)

    # ---- 6. Consolidation per disruption policy.
    used_ct = running @ params.class_ct                      # [B, CT]
    used_karp_od = clip(
        used_ct[:, CT_OD] - params.base_od_nodes * ppn, 0.0)
    used_karp = torch.stack([used_ct[:, CT_SPOT], used_karp_od], -1)
    repack = used_karp / ppn
    nodes_ct = seqsum(nodes, (1, 2))
    slack_ct = clip(nodes_ct - repack, 0.0)
    empty_ct = clip(
        nodes_ct - repack * (1.0 + params.fragmentation), 0.0)
    util_karp_ct = used_karp / (nodes_ct * ppn + _EPS)
    under_gate = torch.sigmoid(
        (params.underutil_threshold - util_karp_ct) / 0.05)
    evict_budget_ct = (1.0 - params.pdb_min_available) * used_karp
    aggr_ct = torch.minimum(slack_ct,
                            empty_ct + under_gate * evict_budget_ct / ppn)

    share = nodes / (nodes_ct[:, None, None, :] + _EPS)      # [B, P, Z, CT]
    aggr_p = aggr[:, :, None, None]
    removable = share * (empty_ct[:, None, None, :] * (1.0 - aggr_p)
                         + aggr_ct[:, None, None, :] * aggr_p)
    removable_p = seqsum(removable, (2, 3))                  # [B, P]
    has_slack = removable_p > 1e-3
    timer = torch.where(has_slack, state.consol_timer_s + params.dt_s, 0.0)
    gate = torch.sigmoid((timer - after) / params.consolidate_tau_s)
    removed = removable * gate[:, :, None, None]
    nodes = clip(nodes - removed, 0.0)
    removed_ct = seqsum(removed, (1, 2))
    evicted = seqsum(clip(removed_ct - empty_ct, 0.0),
                     (1,)) * ppn * 0.5
    timer = torch.where(gate > 0.5, 0.0, timer)

    # ---- 7. Accounting on the post-step fleet; base nodes are spread
    # evenly over zones at on-demand price.
    base_z = params.base_od_nodes / Z
    nodes_zc = seqsum(nodes, (1,))                           # [B, Z, CT]
    nodes_zc = torch.stack([nodes_zc[..., CT_SPOT],
                            nodes_zc[..., CT_OD] + base_z], -1)
    cost = seqsum(nodes_zc * price_zc, (1, 2)) * dt_hr

    total_ct = seqsum(nodes_zc, (1,))                        # [B, CT]
    util_ct = torch.where(
        total_ct > _EPS,
        clip(used_ct / (total_ct * ppn + _EPS), hi=1.0), 0.0)
    watts_ct = params.watts_idle + (
        params.watts_full - params.watts_idle) * util_ct
    kwh_zc = nodes_zc * watts_ct[:, None, :] / 1000.0 * dt_hr
    carbon = seqsum(kwh_zc * exo.carbon_g_kwh[:, :, None], (1, 2))

    # Requests exist only where raw demand exists.
    effective = torch.minimum(running, exo.demand_pods)
    requests = seqsum(effective, (1,)) * params.rps_per_pod * params.dt_s

    # Latency proxy: M/M/1-shaped curve over the fleet load factor.
    load = seqsum(exo.demand_pods, (1,)) / (seqsum(cap_ct, (1,)) + _EPS)
    rho = clip(load, 0.0, LATENCY_RHO_CLIP)
    latency_p95_ms = params.latency_base_ms * (
        1.0 + LATENCY_CURVE_COEF * rho * rho / (1.0 - rho))
    queue_depth = seqsum(pending, (1,))

    zero = torch.zeros_like(cost)
    wl_metrics = dict(
        inf_queue_depth=zero, inf_served=zero, inf_dropped=zero,
        inf_slo_violation=zero, batch_backlog=zero, batch_served=zero,
        batch_deadline_miss=zero, bg_backlog=zero)
    if workload is not None:
        wl_state, wl_metrics = _workload_queues(
            params, workload, wl_state,
            seqsum(nodes_zc, (1, 2)) * ppn - seqsum(running, (1,)))

    # SLO per class against raw demand, and the p95 bound when set.
    met_c = running >= params.slo_served_fraction * exo.demand_pods - _EPS
    latency_ok = torch.where(
        params.latency_slo_ms > 0,
        (latency_p95_ms <= params.latency_slo_ms).to(torch.float32), 1.0)
    slo_ok = met_c.all(dim=1).to(torch.float32) * latency_ok

    new_state = ClusterState(
        nodes=nodes,
        pipeline=pipeline,
        running=running,
        consol_timer_s=timer,
        time_s=state.time_s + params.dt_s,
        acc_cost_usd=state.acc_cost_usd + cost,
        acc_carbon_g=state.acc_carbon_g + carbon,
        acc_requests=state.acc_requests + requests,
        acc_slo_ok_s=state.acc_slo_ok_s + slo_ok * params.dt_s,
        acc_evictions=state.acc_evictions + evicted,
    )
    metrics = StepMetrics(
        cost_usd=cost,
        carbon_g=carbon,
        served_pods=running,
        pending_pods=pending,
        desired_pods=desired,
        demand_pods=exo.demand_pods,
        nodes_by_ct=seqsum(nodes, (1, 2)),
        nodes_by_zone=seqsum(nodes, (1, 3)),
        slo_ok=slo_ok,
        interrupted_nodes=interrupted_total,
        evicted_pods=evicted,
        latency_p95_ms=latency_p95_ms,
        queue_depth=queue_depth,
        denied_nodes=zero if fault is None else denied,
        delayed_nodes=zero if fault is None else seqsum(held, (1, 2, 3)),
        signal_stale=(zero if fault is None
                      else per_cluster(fault.signal_stale, 0)),
        **wl_metrics,
    )
    if workload is not None:
        return new_state, metrics, wl_state
    return new_state, metrics


def _workload_queues(params: SimParams, workload, wl_state, slack):
    """The workload families' tick: ``slack`` [B] is the post-step
    fleet's pod capacity (base nodegroup included) minus the primary
    demand's running pods. Returns ``(wl_state, metrics dict)``."""
    B = slack.shape[0]

    def per_cluster(x):
        return x if x.dim() == 1 else x.expand(B)

    headroom = clip(slack, 0.0)
    # Inference: served first; the queue is capped, the excess shed.
    inf_in = per_cluster(wl_state.inf_queue) + per_cluster(
        workload.inf_arrivals)
    inf_served = torch.minimum(inf_in, headroom)
    inf_after = inf_in - inf_served
    inf_dropped = clip(inf_after - params.wl_inference_queue_max,
                       0.0)
    inf_queue = inf_after - inf_dropped
    rem = headroom - inf_served
    inf_rho = clip(inf_in / (headroom + _EPS), 0.0, LATENCY_RHO_CLIP)
    inf_latency = params.latency_base_ms * (
        1.0 + LATENCY_CURVE_COEF * inf_rho * inf_rho / (1.0 - inf_rho))
    inf_viol = torch.maximum(
        (inf_latency > params.wl_inference_slo_ms).to(torch.float32),
        (inf_dropped > 0.0).to(torch.float32))
    # Batch, earliest deadline first over the age pipeline: pool[k] is
    # work that has waited k ticks; the state's last slot is 0, so the
    # shift drops nothing.
    backlog = wl_state.batch_backlog
    if backlog.dim() == 1:
        backlog = backlog.expand(B, -1)
    D = backlog.shape[1]
    pool = [per_cluster(workload.batch_arrivals)] + list(
        backlog[:, :D - 1].unbind(1))
    leftover = [None] * D
    batch_served = None
    for k in range(D - 1, -1, -1):                    # oldest first
        take = torch.minimum(pool[k], rem)
        rem = rem - take
        batch_served = take if batch_served is None else batch_served + take
        leftover[k] = pool[k] - take
    batch_missed = leftover[D - 1]
    batch_backlog = torch.stack(leftover[:D - 1]
                                + [torch.zeros_like(rem)], dim=1)
    # Background: best effort, whatever headroom remains.
    bg_in = per_cluster(wl_state.bg_backlog) + per_cluster(
        workload.bg_arrivals)
    bg_backlog = bg_in - torch.minimum(bg_in, rem)
    state = type(wl_state)(inf_queue=inf_queue, batch_backlog=batch_backlog,
                           bg_backlog=bg_backlog)
    return state, dict(
        inf_queue_depth=inf_queue, inf_served=inf_served,
        inf_dropped=inf_dropped, inf_slo_violation=inf_viol,
        batch_backlog=seqsum(batch_backlog, (1,)), batch_served=batch_served,
        batch_deadline_miss=batch_missed, bg_backlog=bg_backlog)
