"""Episode summaries: the KPIs of a rollout, batch-first.

The PyTorch form of `ccka_tpu/sim/metrics.py`. Every field of a batch's
:class:`EpisodeSummary` is a [B] tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ccka_tpu_torch.sim.dynamics import clip, seqsum
from ccka_tpu_torch.sim.types import (CT_SPOT, N_CT, ClusterState, SimParams,
                                      StepMetrics)

_EPS = 1e-9


class EpisodeSummary(NamedTuple):
    cost_usd: torch.Tensor            # total spend
    carbon_kg: torch.Tensor           # total emissions
    requests: torch.Tensor            # served requests (proxy)
    slo_hours: torch.Tensor           # hours meeting the SLO
    hours: torch.Tensor               # episode length
    usd_per_slo_hour: torch.Tensor    # headline metric 1
    g_co2_per_kreq: torch.Tensor      # headline metric 2
    usd_per_kreq: torch.Tensor        # $/1k req
    slo_attainment: torch.Tensor      # fraction of ticks meeting the SLO
    mean_nodes: torch.Tensor          # average Karpenter-owned fleet size
    spot_exposure: torch.Tensor       # fraction of node-hours on spot
    waste_frac: torch.Tensor          # unused capacity fraction
    evictions: torch.Tensor           # total consolidation evictions
    interruptions: torch.Tensor       # total spot reclaims
    latency_p95_ms_mean: torch.Tensor  # mean p95 proxy
    latency_p95_ms_max: torch.Tensor   # worst tick p95
    queue_depth_mean: torch.Tensor    # mean pending-pod backlog
    denials: torch.Tensor             # fault counters (0 without faults)
    stale_ticks: torch.Tensor
    inf_slo_violations: torch.Tensor  # workload columns (0 without them)
    inf_queue_mean: torch.Tensor
    inf_dropped: torch.Tensor
    batch_deadline_misses: torch.Tensor
    batch_backlog_mean: torch.Tensor


class SummaryAcc(NamedTuple):
    """Sufficient statistics for :class:`EpisodeSummary`, carried through
    the horizon loop so a fleet rollout never stores per-tick metrics."""

    nodes_ct_sum: torch.Tensor    # [B, T_CT] sum_t active nodes per type
    served_sum: torch.Tensor      # [B]
    capacity_sum: torch.Tensor    # [B] whole-fleet pod capacity
    waste_sum: torch.Tensor       # [B] sum_t max(capacity - served, 0)
    latency_sum: torch.Tensor     # [B]
    latency_max: torch.Tensor     # [B]
    queue_sum: torch.Tensor       # [B]
    interrupts_sum: torch.Tensor  # [B]
    denied_sum: torch.Tensor      # [B]
    stale_sum: torch.Tensor       # [B]
    inf_viol_sum: torch.Tensor    # [B]
    inf_queue_sum: torch.Tensor   # [B]
    inf_drop_sum: torch.Tensor    # [B]
    batch_miss_sum: torch.Tensor  # [B]
    batch_bl_sum: torch.Tensor    # [B]

    @classmethod
    def zero(cls, batch: int, device) -> "SummaryAcc":
        def z():
            return torch.zeros((batch,), dtype=torch.float32, device=device)

        return cls(torch.zeros((batch, N_CT), dtype=torch.float32,
                               device=device),
                   *(z() for _ in range(len(cls._fields) - 1)))

    def update(self, params: SimParams, metrics: StepMetrics) -> "SummaryAcc":
        nodes_total = seqsum(metrics.nodes_by_ct, (1,))
        capacity = (nodes_total + params.base_od_nodes) * params.pods_per_node
        served = seqsum(metrics.served_pods, (1,))
        return SummaryAcc(
            nodes_ct_sum=self.nodes_ct_sum + metrics.nodes_by_ct,
            served_sum=self.served_sum + served,
            capacity_sum=self.capacity_sum + capacity,
            waste_sum=self.waste_sum + clip(capacity - served, 0.0),
            latency_sum=self.latency_sum + metrics.latency_p95_ms,
            latency_max=torch.maximum(self.latency_max,
                                      metrics.latency_p95_ms),
            queue_sum=self.queue_sum + metrics.queue_depth,
            interrupts_sum=self.interrupts_sum + metrics.interrupted_nodes,
            denied_sum=self.denied_sum + metrics.denied_nodes,
            stale_sum=self.stale_sum + metrics.signal_stale,
            inf_viol_sum=self.inf_viol_sum + metrics.inf_slo_violation,
            inf_queue_sum=self.inf_queue_sum + metrics.inf_queue_depth,
            inf_drop_sum=self.inf_drop_sum + metrics.inf_dropped,
            batch_miss_sum=self.batch_miss_sum + metrics.batch_deadline_miss,
            batch_bl_sum=self.batch_bl_sum + metrics.batch_backlog,
        )


def finalize_summary(params: SimParams, initial: ClusterState,
                     final: ClusterState, acc: SummaryAcc,
                     n_ticks: int) -> EpisodeSummary:
    """Episode KPIs from the state accumulators (as deltas against
    ``initial``) and the loop-carried sufficient statistics."""
    dt_hr = params.dt_s / 3600.0
    t = float(n_ticks)
    cost = final.acc_cost_usd - initial.acc_cost_usd
    carbon_g = final.acc_carbon_g - initial.acc_carbon_g
    requests = final.acc_requests - initial.acc_requests
    slo_ok_s = final.acc_slo_ok_s - initial.acc_slo_ok_s
    slo_hours = slo_ok_s / 3600.0
    hours = (t * dt_hr).expand(cost.shape)
    node_sum = seqsum(acc.nodes_ct_sum, (1,))
    node_hours = node_sum * dt_hr
    spot_hours = acc.nodes_ct_sum[:, CT_SPOT] * dt_hr
    return EpisodeSummary(
        cost_usd=cost,
        carbon_kg=carbon_g / 1000.0,
        requests=requests,
        slo_hours=slo_hours,
        hours=hours,
        usd_per_slo_hour=cost / (slo_hours + _EPS),
        g_co2_per_kreq=carbon_g / (requests / 1000.0 + _EPS),
        usd_per_kreq=cost / (requests / 1000.0 + _EPS),
        slo_attainment=slo_ok_s / (t * params.dt_s),
        mean_nodes=node_sum / t,
        spot_exposure=spot_hours / (node_hours + _EPS),
        waste_frac=acc.waste_sum / (acc.capacity_sum + _EPS),
        evictions=final.acc_evictions - initial.acc_evictions,
        interruptions=acc.interrupts_sum,
        latency_p95_ms_mean=acc.latency_sum / t,
        latency_p95_ms_max=acc.latency_max,
        queue_depth_mean=acc.queue_sum / t,
        denials=acc.denied_sum,
        stale_ticks=acc.stale_sum,
        inf_slo_violations=acc.inf_viol_sum,
        inf_queue_mean=acc.inf_queue_sum / t,
        inf_dropped=acc.inf_drop_sum,
        batch_deadline_misses=acc.batch_miss_sum,
        batch_backlog_mean=acc.batch_bl_sum / t,
    )


def summarize(params: SimParams, metrics: StepMetrics) -> EpisodeSummary:
    """Reduce per-tick metrics stacked on axis 1 ([B, T, ...]) to episode
    KPIs ([B] per field)."""
    dt_hr = params.dt_s / 3600.0
    cost = metrics.cost_usd.sum(dim=1)
    carbon_g = metrics.carbon_g.sum(dim=1)
    effective = torch.minimum(metrics.served_pods, metrics.demand_pods)
    requests = (effective.sum(dim=-1) * params.rps_per_pod
                * params.dt_s).sum(dim=1)
    slo_ticks = metrics.slo_ok.sum(dim=1)
    n_ticks = float(metrics.slo_ok.shape[1])
    slo_hours = slo_ticks * dt_hr
    hours = (n_ticks * dt_hr).expand(cost.shape)

    nodes_total = metrics.nodes_by_ct.sum(dim=-1)            # [B, T]
    node_hours = nodes_total.sum(dim=1) * dt_hr
    spot_hours = metrics.nodes_by_ct[..., CT_SPOT].sum(dim=1) * dt_hr

    served_total = metrics.served_pods.sum(dim=-1)           # [B, T]
    capacity_proxy = ((nodes_total + params.base_od_nodes)
                      * params.pods_per_node)
    waste = clip(capacity_proxy - served_total, 0.0).sum(dim=1)
    waste_frac = waste / (capacity_proxy.sum(dim=1) + _EPS)

    return EpisodeSummary(
        cost_usd=cost,
        carbon_kg=carbon_g / 1000.0,
        requests=requests,
        slo_hours=slo_hours,
        hours=hours,
        usd_per_slo_hour=cost / (slo_hours + _EPS),
        g_co2_per_kreq=carbon_g / (requests / 1000.0 + _EPS),
        usd_per_kreq=cost / (requests / 1000.0 + _EPS),
        slo_attainment=slo_ticks / n_ticks,
        mean_nodes=nodes_total.mean(dim=1),
        spot_exposure=spot_hours / (node_hours + _EPS),
        waste_frac=waste_frac,
        evictions=metrics.evicted_pods.sum(dim=1),
        interruptions=metrics.interrupted_nodes.sum(dim=1),
        latency_p95_ms_mean=metrics.latency_p95_ms.mean(dim=1),
        latency_p95_ms_max=metrics.latency_p95_ms.amax(dim=1),
        queue_depth_mean=metrics.queue_depth.mean(dim=1),
        denials=metrics.denied_nodes.sum(dim=1),
        stale_ticks=metrics.signal_stale.sum(dim=1),
        inf_slo_violations=metrics.inf_slo_violation.sum(dim=1),
        inf_queue_mean=metrics.inf_queue_depth.mean(dim=1),
        inf_dropped=metrics.inf_dropped.sum(dim=1),
        batch_deadline_misses=metrics.batch_deadline_miss.sum(dim=1),
        batch_backlog_mean=metrics.batch_backlog.mean(dim=1),
    )
