"""Simulator tuples of tensors: parameters, state, actions, per-step metrics.

The PyTorch form of `ccka_tpu/sim/types.py`. Dimensions (static per run):
P pools, Z zones, T_CT = 2 capacity types (spot=0, on-demand=1), C = 2
workload classes, K provisioning-pipeline depth. Where the JAX package
added a batch axis with ``vmap``, these tensors carry it written out in
front: a ``ClusterState`` of a batch has ``nodes`` of shape [B, P, Z, 2].

Node counts are float32 throughout: the simulator is a continuous
relaxation, so autograd flows through provisioning and consolidation
magnitudes in deterministic mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import FrameworkConfig

CT_SPOT = 0
CT_OD = 1
N_CT = 2


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class SimParams(NamedTuple):
    """Static-per-run physical parameters, derived from FrameworkConfig.
    Scalars are 0-d float32 tensors on the run's device."""

    dt_s: torch.Tensor                 # [] seconds per control tick
    pods_per_node: torch.Tensor        # [] schedulable pods per node
    base_od_nodes: torch.Tensor        # [] managed-nodegroup floor
    max_nodes: torch.Tensor            # [P] per-pool node cap
    static_ct_allow: torch.Tensor      # [P, T_CT] pool's intrinsic types
    class_ct: torch.Tensor             # [C, T_CT] one-hot: class c needs ct
    provision_pipeline_k: int          # static: pipeline depth
    interrupt_p_step: torch.Tensor     # [] P(spot node interrupted per step)
    pdb_min_available: torch.Tensor    # [] PDB floor
    fragmentation: torch.Tensor        # [] stranded-capacity factor
    underutil_threshold: torch.Tensor  # [] utilization gate (Underutilized)
    watts_idle: torch.Tensor           # [] per node
    watts_full: torch.Tensor           # [] per node
    rps_per_pod: torch.Tensor          # [] request throughput proxy
    slo_served_fraction: torch.Tensor  # [] served/desired to count SLO-met
    consolidate_tau_s: torch.Tensor    # [] softness of consolidate-after
    latency_base_ms: torch.Tensor      # [] idle p95 of the latency proxy
    latency_slo_ms: torch.Tensor       # [] p95 SLO bound (0 = disabled)
    wl_inference_queue_max: torch.Tensor  # [] workload families: queue
    wl_inference_slo_ms: torch.Tensor     #    cap, latency SLO and the
    wl_batch_deadline_ticks: int          #    static batch deadline D

    @classmethod
    def from_config(cls, cfg: FrameworkConfig, device=None) -> "SimParams":
        dev = resolve_device(device)
        cl, wl, sm = cfg.cluster, cfg.workload, cfg.sim
        nt = cl.node_type
        ppn = float(np.floor(min(
            (nt.vcpu - nt.system_reserved_vcpu) / wl.pod_cpu_request,
            (nt.mem_gib - nt.system_reserved_mem_gib) / wl.pod_mem_request_gib,
        )))
        static_allow = np.zeros((cl.n_pools, N_CT), np.float32)
        for i, pool in enumerate(cl.pools):
            static_allow[i, CT_SPOT] = float("spot" in pool.capacity_types)
            static_allow[i, CT_OD] = float("on-demand" in pool.capacity_types)
        return cls(
            dt_s=_f32(sm.dt_s, dev),
            pods_per_node=_f32(ppn, dev),
            base_od_nodes=_f32(cl.base_nodes, dev),
            max_nodes=_f32([p.max_nodes for p in cl.pools], dev),
            static_ct_allow=_f32(static_allow, dev),
            # class 0 -> spot nodeSelector, class 1 -> on-demand.
            class_ct=_f32(np.eye(N_CT), dev),
            provision_pipeline_k=sm.provision_delay_steps,
            interrupt_p_step=_f32(
                np.float32(sm.spot_interruption_rate_hr * sm.dt_s / 3600.0),
                dev),
            pdb_min_available=_f32(wl.pdb_min_available, dev),
            fragmentation=_f32(sm.fragmentation, dev),
            underutil_threshold=_f32(sm.underutil_threshold, dev),
            watts_idle=_f32(nt.watts_idle, dev),
            watts_full=_f32(nt.watts_full, dev),
            rps_per_pod=_f32(sm.rps_per_pod, dev),
            slo_served_fraction=_f32(sm.slo_served_fraction, dev),
            consolidate_tau_s=_f32(0.25 * sm.dt_s, dev),
            latency_base_ms=_f32(sm.latency_base_ms, dev),
            latency_slo_ms=_f32(sm.latency_slo_ms, dev),
            wl_inference_queue_max=_f32(
                cfg.workloads.inference_queue_max, dev),
            wl_inference_slo_ms=_f32(cfg.workloads.inference_slo_ms, dev),
            wl_batch_deadline_ticks=int(cfg.workloads.batch_deadline_ticks),
        )


class ClusterState(NamedTuple):
    """The evolving clusters; the leading axis is the batch B."""

    nodes: torch.Tensor           # [B, P, Z, T_CT] active Karpenter nodes
    pipeline: torch.Tensor        # [B, K, P, Z, T_CT] provisioning in flight
    running: torch.Tensor         # [B, C] running pods per class
    consol_timer_s: torch.Tensor  # [B, P] seconds of reclaimable slack
    time_s: torch.Tensor          # [B] simulated wall-clock
    acc_cost_usd: torch.Tensor    # [B]
    acc_carbon_g: torch.Tensor    # [B]
    acc_requests: torch.Tensor    # [B] served requests (proxy)
    acc_slo_ok_s: torch.Tensor    # [B] seconds meeting the SLO
    acc_evictions: torch.Tensor   # [B] pods evicted by consolidation


class Action(NamedTuple):
    """Continuous canonical action. Leaves are [P, Z], [P, T_CT], [P], [P],
    [C] for one shared action, or carry a leading batch axis when a
    policy picks one per cluster."""

    zone_weight: torch.Tensor          # [(B,) P, Z] in [0,1]
    ct_allow: torch.Tensor             # [(B,) P, T_CT] in [0,1]
    consolidation_aggr: torch.Tensor   # [(B,) P] 0=WhenEmpty, 1=+Underutil.
    consolidate_after_s: torch.Tensor  # [(B,) P] seconds
    hpa_scale: torch.Tensor            # [(B,) C] multiplier on demand

    @classmethod
    def neutral(cls, n_pools: int, n_zones: int, n_classes: int = 2,
                device=None) -> "Action":
        """The reset profile: all zones, intrinsic capacity types,
        WhenEmpty/30s."""
        dev = resolve_device(device)
        f32 = torch.float32
        return cls(
            zone_weight=torch.ones((n_pools, n_zones), dtype=f32, device=dev),
            ct_allow=torch.ones((n_pools, N_CT), dtype=f32, device=dev),
            consolidation_aggr=torch.zeros((n_pools,), dtype=f32, device=dev),
            consolidate_after_s=torch.full((n_pools,), 30.0, dtype=f32,
                                           device=dev),
            hpa_scale=torch.ones((n_classes,), dtype=f32, device=dev),
        )


class StepMetrics(NamedTuple):
    """Per-tick observables of a batch; every leaf leads with B."""

    cost_usd: torch.Tensor           # [B]
    carbon_g: torch.Tensor           # [B]
    served_pods: torch.Tensor        # [B, C]
    pending_pods: torch.Tensor       # [B, C]
    desired_pods: torch.Tensor       # [B, C]
    demand_pods: torch.Tensor        # [B, C]
    nodes_by_ct: torch.Tensor        # [B, T_CT]
    nodes_by_zone: torch.Tensor      # [B, Z]
    slo_ok: torch.Tensor             # [B] {0,1}
    interrupted_nodes: torch.Tensor  # [B]
    evicted_pods: torch.Tensor       # [B]
    latency_p95_ms: torch.Tensor     # [B]
    queue_depth: torch.Tensor        # [B]
    denied_nodes: torch.Tensor       # [B] fault counters: 0 without faults
    delayed_nodes: torch.Tensor      # [B]
    signal_stale: torch.Tensor       # [B]
    inf_queue_depth: torch.Tensor    # [B] workload counters: 0 without
    inf_served: torch.Tensor         # [B]
    inf_dropped: torch.Tensor        # [B]
    inf_slo_violation: torch.Tensor  # [B]
    batch_backlog: torch.Tensor      # [B]
    batch_served: torch.Tensor       # [B]
    batch_deadline_miss: torch.Tensor  # [B]
    bg_backlog: torch.Tensor         # [B]
