"""Typed, validated configuration system.

Replaces the reference's layered env-var scheme — `.env` file sourced by
`00_common.sh:5`, defaults-if-unset (`00_common.sh:8-10`), hard `require_var`
validation (`00_common.sh:18-20`), per-script tunables
(`demo_30_burst_configure.sh:7-8`), and the demo env with live AWS lookup
(`demo_00_env.sh:13-15`) — with frozen dataclasses, a single validation pass,
`CCKA_*` environment overrides, and dict/JSON round-tripping.

Design notes (TPU-first): everything that reaches the device is resolved here
into *static* shapes and floats — pool/zone counts, horizon lengths, pod/node
capacities — so that downstream `jit`/`scan`/`vmap` traces never see dynamic
shapes. The config is hashable (tuples, not lists) and can be passed as a
static argument to jitted functions.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Mapping, Tuple

ENV_PREFIX = "CCKA_"

# Latency-proxy curve constants — the single source of truth shared by the
# simulator (`sim/dynamics.py` imports these) and the config validation
# below: p95 = base * (1 + COEF*rho^2/(1-rho)) with rho clipped at RHO_CLIP,
# so p95 saturates at base * LATENCY_SATURATION_FACTOR and an SLO bound at
# or above that ceiling can never be violated.
LATENCY_RHO_CLIP = 0.98
LATENCY_CURVE_COEF = 3.0
LATENCY_SATURATION_FACTOR = 1.0 + (
    LATENCY_CURVE_COEF * LATENCY_RHO_CLIP * LATENCY_RHO_CLIP
    / (1.0 - LATENCY_RHO_CLIP))


class ConfigError(ValueError):
    """Raised on invalid configuration — analog of `require_var` hard-fail
    (`00_common.sh:18-20`)."""


# ---------------------------------------------------------------------------
# Leaf specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NodeTypeSpec:
    """An instance-type capacity/price model.

    Defaults model the reference cluster's `m6i.large` (`.env:6`,
    `01_cluster.sh:24-35`): 2 vCPU / 8 GiB, us-east-2 on-demand ≈ $0.096/hr.
    ``watts_idle``/``watts_full`` give a linear power model for carbon
    accounting (the reference never measured power; see BASELINE.md).
    """

    name: str = "m6i.large"
    vcpu: float = 2.0
    mem_gib: float = 8.0
    od_price_hr: float = 0.096
    spot_price_hr_mean: float = 0.035
    watts_idle: float = 40.0
    watts_full: float = 110.0
    # vCPU reserved for system daemons (kubelet/CNI); the schedulable residue
    # is what the bin-packing model sees.
    system_reserved_vcpu: float = 0.2
    system_reserved_mem_gib: float = 0.6

    def validate(self) -> None:
        if self.vcpu <= 0 or self.mem_gib <= 0:
            raise ConfigError(f"node type {self.name}: non-positive capacity")
        if self.system_reserved_vcpu >= self.vcpu:
            raise ConfigError(f"node type {self.name}: reserved >= capacity")
        if self.od_price_hr <= 0 or self.spot_price_hr_mean <= 0:
            raise ConfigError(f"node type {self.name}: non-positive price")


@dataclass(frozen=True)
class PoolSpec:
    """A Karpenter NodePool analog.

    The reference defines two pools, `spot-preferred` and `on-demand-slo`
    (`demo_00_env.sh:18-19`), labeled `autoscale.strategy=cost|slo` and
    `carbon.simulated=low|medium` (`demo_10_setup_configure.sh:59-62`).
    ``capacity_types`` is the allowed `karpenter.sh/capacity-type` set as
    patched by the profiles (`demo_20_offpeak_configure.sh:74-78`).
    """

    name: str
    strategy: str  # "cost" | "slo"
    capacity_types: Tuple[str, ...] = ("spot", "on-demand")
    max_nodes: int = 64

    def validate(self) -> None:
        if self.strategy not in ("cost", "slo"):
            raise ConfigError(f"pool {self.name}: bad strategy {self.strategy!r}")
        for ct in self.capacity_types:
            if ct not in ("spot", "on-demand"):
                raise ConfigError(f"pool {self.name}: bad capacity type {ct!r}")
        if not self.capacity_types:
            raise ConfigError(f"pool {self.name}: empty capacity_types")
        if self.max_nodes <= 0:
            raise ConfigError(f"pool {self.name}: max_nodes must be positive")


@dataclass(frozen=True)
class RegionSpec:
    """One cloud region of a multi-region fleet (BASELINE.json config #4).

    The reference's multi-region story is paper-only ("multi-region ~$450/mo",
    report PDF p.4 §8; GSLB routing + time-shifting, proposal PDF p.5). Here
    each region contributes zones to the flat zone axis with its own grid
    profile — carbon base level, solar-dip depth (the CAISO duck curve is
    deep; MISO's is shallow), local-solar timezone offset, and price level —
    so "carbon-aware node migration" is expressible as zone selection
    spanning regions: the same `topology.kubernetes.io/zone In [...]` lever
    the profiles already patch (`demo_20_offpeak_configure.sh:71`).
    """

    name: str
    zones: Tuple[str, ...]
    carbon_zone: str = ""            # ElectricityMaps zone id, e.g. "US-CAL-CISO"
    # kubeconfig context naming this region's cluster (`kubectl --context`).
    # Required for live multi-region actuation: each region is its own EKS
    # cluster, and patching both regions' NodePools through one context
    # would ping-pong a single cluster between the two zone sets.
    kube_context: str = ""
    carbon_base_g_kwh: float = 0.0   # 0 → signals.carbon_default_g_kwh
    solar_frac: float = 0.45         # depth of the midday solar dip [0,1)
    tz_offset_hr: float = 0.0        # local solar time vs the trace clock
    od_price_scale: float = 1.0
    spot_price_scale: float = 1.0

    def validate(self) -> None:
        if not self.zones:
            raise ConfigError(f"region {self.name}: no zones")
        if self.carbon_base_g_kwh < 0:
            raise ConfigError(f"region {self.name}: negative carbon base")
        if not 0.0 <= self.solar_frac < 1.0:
            raise ConfigError(f"region {self.name}: solar_frac out of [0,1)")
        if self.od_price_scale <= 0 or self.spot_price_scale <= 0:
            raise ConfigError(f"region {self.name}: non-positive price scale")


@dataclass(frozen=True)
class ClusterConfig:
    """Cluster topology: region/zones/pools/instance type.

    Mirrors `.env:1-8` (cluster identity, min/max/desired sizes) and
    `demo_00_env.sh:18-23` (pool names, zone preferences). When ``regions``
    is non-empty the fleet is multi-region: ``zones`` is derived as the
    concatenation of each region's zones (in order), and the signal layer
    gives each zone its region's carbon/price profile.
    """

    name: str = "demo1"
    region: str = "us-east-2"
    zones: Tuple[str, ...] = ("us-east-2a", "us-east-2b", "us-east-2c")
    offpeak_zones: Tuple[str, ...] = ("us-east-2a",)
    peak_zones: Tuple[str, ...] = ("us-east-2c",)
    pools: Tuple[PoolSpec, ...] = (
        PoolSpec(name="spot-preferred", strategy="cost"),
        PoolSpec(name="on-demand-slo", strategy="slo",
                 capacity_types=("on-demand",)),
    )
    node_type: NodeTypeSpec = field(default_factory=NodeTypeSpec)
    # Managed nodegroup floor that Karpenter never touches (`.env:7-8`:
    # min 2 / desired 3 / max 6 m6i.large).
    base_nodes: int = 3
    # Multi-region fleet (empty → classic single-region demo topology).
    regions: Tuple[RegionSpec, ...] = ()

    def __post_init__(self):
        if self.regions:
            derived = tuple(z for r in self.regions for z in r.zones)
            object.__setattr__(self, "zones", derived)

    @property
    def n_zones(self) -> int:
        return len(self.zones)

    @property
    def n_pools(self) -> int:
        return len(self.pools)

    @property
    def n_regions(self) -> int:
        return max(1, len(self.regions))

    @property
    def zone_region_index(self) -> Tuple[int, ...]:
        """Region index per zone (all 0 for the single-region topology)."""
        if not self.regions:
            return (0,) * len(self.zones)
        return tuple(i for i, r in enumerate(self.regions) for _ in r.zones)

    def region_of_zone(self, zone: str) -> str:
        if zone not in self.zones:
            raise ConfigError(f"unknown zone {zone!r}")
        if not self.regions:
            return self.region
        for r in self.regions:
            if zone in r.zones:
                return r.name
        raise ConfigError(f"unknown zone {zone!r}")

    def pool_index(self, name: str) -> int:
        for i, p in enumerate(self.pools):
            if p.name == name:
                return i
        raise ConfigError(f"unknown pool {name!r}")

    def validate(self) -> None:
        if not self.zones:
            raise ConfigError("cluster: no zones")
        for z in self.offpeak_zones + self.peak_zones:
            if z not in self.zones:
                raise ConfigError(f"cluster: preference zone {z!r} not in zones")
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise ConfigError("cluster: duplicate pool names")
        for p in self.pools:
            p.validate()
        if self.regions:
            rnames = [r.name for r in self.regions]
            if len(set(rnames)) != len(rnames):
                raise ConfigError("cluster: duplicate region names")
            for r in self.regions:
                r.validate()
            if len(set(self.zones)) != len(self.zones):
                raise ConfigError("cluster: duplicate zones across regions")
        self.node_type.validate()
        if self.base_nodes < 0:
            raise ConfigError("cluster: negative base_nodes")


@dataclass(frozen=True)
class WorkloadConfig:
    """Burst workload model.

    The reference load generator creates COUNT=12 Deployments × REPLICAS=5 =
    60 pods, odd deployments pinned to spot, even to on-demand, each pod
    requesting 200m CPU / 128Mi (`demo_30_burst_configure.sh:7-8,59-70,135-137`)
    — sized to overflow the 3×m6i.large base capacity and force scale-out.
    """

    deployments: int = 12
    replicas: int = 5
    # Workload namespace (`demo_00_env.sh:9-10`): where burst Deployments,
    # the PDB, HPAs and app-level SLO metrics live.
    namespace: str = "nov-22"
    pod_cpu_request: float = 0.2
    pod_mem_request_gib: float = 0.125
    # Fraction of pods labeled critical=true — these may never tolerate spot
    # (Kyverno ClusterPolicy `critical-no-spot-without-pdb`, `04_kyverno.sh:47-75`).
    critical_fraction: float = 0.0
    # KEDA/SQS queue-driven scaling — realizes the reference's stub
    # (`.env:10-12`: CREATE_SQS=false, SQS_QUEUE_NAME). Both must be set for
    # the controller's --keda path; empty = disabled, like CREATE_SQS=false.
    sqs_queue_name: str = ""
    aws_account_id: str = ""
    # PDB minAvailable=50% on the burst group (`demo_10_setup_configure.sh:46-57`).
    pdb_min_available: float = 0.5

    @property
    def total_pods(self) -> int:
        return self.deployments * self.replicas

    def validate(self) -> None:
        if self.deployments <= 0 or self.replicas <= 0:
            raise ConfigError("workload: non-positive size")
        if not self.namespace:
            raise ConfigError("workload: empty namespace")
        if self.pod_cpu_request <= 0 or self.pod_mem_request_gib <= 0:
            raise ConfigError("workload: non-positive pod request")
        if not 0.0 <= self.critical_fraction <= 1.0:
            raise ConfigError("workload: critical_fraction out of [0,1]")
        if not 0.0 <= self.pdb_min_available <= 1.0:
            raise ConfigError("workload: pdb_min_available out of [0,1]")


@dataclass(frozen=True)
class SimConfig:
    """Cluster-dynamics parameters for the JAX simulator.

    ``dt_s`` matches the reference's control-relevant cadence: the ADOT
    metrics pipeline scrapes every 30s (`06_opencost.sh:323`), and the
    neutral consolidation timer is 30s (`demo_19_reset_policies.sh:22-29`).
    ``provision_delay_s`` models Karpenter's pending→NodeRegistered latency;
    ``spot_interruption_rate_hr`` makes spot reclaims a first-class stochastic
    process — the very thing the reference disabled
    (`settings.interruptionQueue=""`, `05_karpenter.sh:136`).
    """

    dt_s: float = 30.0
    horizon_steps: int = 2880  # one simulated day at 30s ticks
    provision_delay_s: float = 90.0
    spot_interruption_rate_hr: float = 0.05  # per spot node per hour
    # Utilization below which WhenEmptyOrUnderutilized may consolidate a node.
    underutil_threshold: float = 0.5
    # Latency proxy: seconds of pending-pod backlog translated into SLO burn.
    slo_pending_weight: float = 1.0
    max_pending_pods: int = 512
    # Request throughput proxy per running pod (for gCO2/req and $/req):
    # sized so the 60-pod burst serves ~36k req/min, the same order as the
    # reference's 25k req/min productization target (report PDF p.4 §9).
    rps_per_pod: float = 10.0
    # Fraction of demand that must be served for an interval to count as an
    # SLO-met interval (the "$/SLO-hour" denominator).
    slo_served_fraction: float = 0.99
    # Bin-packing fragmentation: WhenEmpty consolidation can only reclaim
    # truly-empty nodes; fragmentation keeps ~this fraction of repack-optimal
    # capacity stranded on partially-filled nodes.
    fragmentation: float = 0.3
    # Latency proxy (the app-level p95 the reference advertised as an SLO
    # input but never collected — README.md:21, SURVEY §2.3): service p95
    # at idle, inflated by a queueing curve as fleet load approaches
    # capacity.
    latency_base_ms: float = 20.0
    # p95 bound for the SLO gate; 0 disables latency gating (SLO is then
    # served-fraction only, the pre-existing behavior). Must sit below the
    # proxy's saturation ceiling (see LATENCY_SATURATION_FACTOR) or the
    # gate could never trip.
    latency_slo_ms: float = 0.0

    @property
    def provision_delay_steps(self) -> int:
        return max(1, int(round(self.provision_delay_s / self.dt_s)))

    def validate(self) -> None:
        if self.dt_s <= 0:
            raise ConfigError("sim: dt_s must be positive")
        if self.horizon_steps <= 0:
            raise ConfigError("sim: horizon_steps must be positive")
        if self.spot_interruption_rate_hr < 0:
            raise ConfigError("sim: negative interruption rate")
        if not 0.0 < self.underutil_threshold <= 1.0:
            raise ConfigError("sim: underutil_threshold out of (0,1]")
        if self.rps_per_pod <= 0:
            raise ConfigError("sim: rps_per_pod must be positive")
        if not 0.0 < self.slo_served_fraction <= 1.0:
            raise ConfigError("sim: slo_served_fraction out of (0,1]")
        if self.fragmentation < 0:
            raise ConfigError("sim: negative fragmentation")
        if self.latency_base_ms <= 0:
            raise ConfigError("sim: latency_base_ms must be positive")
        if self.latency_slo_ms < 0:
            raise ConfigError("sim: negative latency_slo_ms")
        ceiling = self.latency_base_ms * LATENCY_SATURATION_FACTOR
        if self.latency_slo_ms >= ceiling > 0:
            raise ConfigError(
                f"sim: latency_slo_ms={self.latency_slo_ms} is at or above "
                f"the proxy's saturation ceiling ({ceiling:.0f} ms = "
                f"latency_base_ms x {LATENCY_SATURATION_FACTOR:.1f}); the "
                "gate could never trip — lower the bound or raise "
                "latency_base_ms")


@dataclass(frozen=True)
class SignalsConfig:
    """Signal-source configuration.

    ``carbon_default_g_kwh`` reproduces the reference's documented fallback:
    "leave blank to use dummy ~400 g/kWh" (`.env:14-16`). ``carbon_zone`` is
    the ElectricityMaps-style zone id (`.env:15`, `US-CAL-CISO`).
    ``scrape_interval_s`` mirrors the ADOT pipeline (`06_opencost.sh:323`).
    """

    backend: str = "synthetic"  # "synthetic" | "replay" | "live"
    replay_path: str = ""       # .npz trace for the replay backend
    # Live spot-price feed: "" (disabled — synthetic prior passes through,
    # the reference's level of spot awareness) or "aws" (per-AZ
    # `describe-spot-price-history` via the AWS CLI each tick).
    spot_feed: str = ""
    # Live spot-interruption warnings: the EventBridge→SQS queue URL the
    # controller polls each tick for `EC2 Spot Instance Interruption
    # Warning` events — the pipeline the reference disabled with
    # Karpenter's `settings.interruptionQueue=""` (`05_karpenter.sh:136`).
    # "" disables; the simulator's stochastic process still prices
    # interruptions in training either way.
    interruption_queue_url: str = ""
    carbon_api_key: str = ""
    carbon_zone: str = "US-CAL-CISO"
    carbon_default_g_kwh: float = 400.0
    scrape_interval_s: float = 30.0
    prometheus_url: str = "http://localhost:8005/workspaces/local"
    opencost_url: str = "http://localhost:9090"
    carbon_url: str = "https://api.electricitymap.org/v3"
    request_timeout_s: float = 10.0
    # Live-fetch retry budget (`signals/live.RetryingFetch`): transport
    # failures retry up to this many extra attempts with jittered
    # exponential backoff starting at fetch_backoff_s. The budget is
    # PER FETCH CALL, not per tick: sleeps and new attempts are bounded
    # by request_timeout_s, and each in-flight attempt additionally by
    # the transport's own socket timeout, so one call takes at most
    # ~2x request_timeout_s under a hanging endpoint — and a tick makes
    # one call per family (OD, demand, one per carbon zone), so a full
    # outage can stall the scrape stage for several multiples of
    # request_timeout_s before degraded mode reacts. Exhaustion marks
    # the tick's sample stale (degraded-mode input) instead of raising.
    fetch_retries: int = 2
    fetch_backoff_s: float = 0.4

    def validate(self) -> None:
        if self.backend not in ("synthetic", "replay", "live"):
            raise ConfigError(f"signals: unknown backend {self.backend!r}")
        if self.spot_feed not in ("", "aws"):
            raise ConfigError(f"signals: unknown spot_feed {self.spot_feed!r}")
        if self.backend == "replay" and not self.replay_path:
            raise ConfigError("signals: replay backend requires replay_path")
        if self.carbon_default_g_kwh <= 0:
            raise ConfigError("signals: non-positive default carbon intensity")
        if self.scrape_interval_s <= 0:
            raise ConfigError("signals: non-positive scrape interval")
        if self.fetch_retries < 0 or self.fetch_backoff_s < 0:
            raise ConfigError("signals: negative fetch retry budget")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters for the learned PolicyBackends."""

    batch_clusters: int = 256
    unroll_steps: int = 64
    learning_rate: float = 3e-4
    seed: int = 0
    # Synthesize training traces on device (associative-scan AR(1) in jax)
    # instead of host numpy — same signal family, different RNG stream;
    # sources without a device path (replay/live) ignore this.
    device_traces: bool = True
    # Objective weights: J = cost + carbon_weight * gCO2
    #   + slo_weight * pending + slo_violation_weight * (1 - slo_ok).
    # Carbon price: $500/tCO2e — the upper band of published social-cost
    # estimates, deliberately above the $50 central value so the carbon
    # term is *material* against fleet dollars at demo scale (at $50/t the
    # term is ~5% of spend and optimizers ignore zone carbon entirely —
    # the round-2 failure mode). The published gCO2/kreq scoreboard metric
    # is unweighted; this only shapes what learned backends optimize.
    carbon_weight: float = 5e-4  # $ per gCO2
    # Pending-pod price: the smooth gradient carrier for diff-MPC. Sized at
    # ~2.5x an on-demand node-tick ($0.0008) so shedding a pod is never
    # cheaper than the node that would serve it, but one bad tick no longer
    # outweighs hundreds of ticks of fleet spend (round-2 value 0.05 did,
    # and PPO learned 1.5x overprovisioning from it).
    slo_weight: float = 0.002    # $ per pending-pod-step
    # Price of a tick failing the SLO gate — the exact event the scoreboard
    # denominators count (usd_per_slo_hour, slo_attainment). ~7x the
    # per-tick fleet spend of the rule baseline ($0.003): violations must
    # be rare, but buying one with a doubled fleet is a losing trade.
    slo_violation_weight: float = 0.02  # $ per SLO-violated tick
    # PPO-specific.
    # Cosine-decay the learning rate to ~0 over this many iterations
    # (0 = constant LR). Long flagship runs drift at constant LR — the
    # selection loop kept rejecting late checkpoints — while decayed runs
    # anneal into a stable policy.
    lr_decay_iters: int = 0
    # Initial policy stddev (log). -0.5 explores broadly; flagship
    # refinement runs (near-optimal init) use ~-1.5 so exploration noise
    # doesn't destroy the operating point before the critic calibrates.
    init_log_std: float = -0.5
    ppo_clip: float = 0.2
    ppo_epochs: int = 4
    # -- Refinement-from-a-teacher mechanics (VERDICT r3 #1): the levers
    # that let RL improve ON a near-optimal distilled init instead of
    # wrecking it before the critic calibrates.
    # Iterations at the start where the policy-gradient (and entropy) term
    # is zeroed — only the critic (+ torso via the value loss) trains. The
    # distilled critic regressed no-bootstrap window returns; it must
    # re-calibrate on-policy before its advantages steer the actor.
    critic_warmup_iters: int = 0
    # KL-anchor to the init policy: coefficient on ||mean - anchor_mean||^2
    # (the Gaussian KL with shared std, up to scale). Keeps refinement in a
    # trust region around the teacher the init was distilled from. 0 = off;
    # active only when the trainer is given anchor params.
    anchor_coef: float = 0.0
    # Clip *normalized* advantages to +/- this value (0 = off): a single
    # violation-spike tick can contribute at most adv_clip sigmas to the
    # policy gradient instead of dominating the whole batch.
    adv_clip: float = 0.0
    # Scale actor-head updates (mean head + log_std) relative to the
    # shared torso/critic learning rate; <1 slows the actor so the critic
    # stays ahead of the policy it evaluates.
    actor_lr_scale: float = 1.0
    # Adaptive attainment constraint (Lagrangian-PPO style). The
    # scoreboard treats attainment as a CONSTRAINT (>= the rule
    # baseline's), not a reward: attainment above the bar earns nothing,
    # yet a fixed violation price makes buying 0.999 attainment with an
    # oversized fleet reward-optimal (the round-3/4 excursion). With
    # attain_target > 0 the per-tick violation price becomes a
    # multiplier: it decays while measured attainment sits above target
    # (freeing budget to cut cost/carbon) and rises when below. 0 = off
    # (fixed slo_violation_weight).
    attain_target: float = 0.0
    lagrange_lr: float = 2.0        # multiplicative update rate on the gap
    lagrange_min: float = 1e-3      # multiplier floor ($/violated tick)
    lagrange_max: float = 0.2       # multiplier ceiling
    # Early-stop epochs once approx-KL exceeds this (masked inside the
    # jitted epoch scan; prevents destructive late-training updates).
    ppo_target_kl: float = 0.05
    gamma: float = 0.99
    gae_lambda: float = 0.95
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    # Price multiplier on the inter-region migration transfer cost
    # (ccka_tpu/regions): the "migration" objective term is
    # migration_weight x the tick's transfer-cost dollars. 1.0 prices
    # transfers at face value; the term is exactly 0 whenever no
    # migration runs, so the pre-geo objective is bitwise unchanged.
    migration_weight: float = 1.0
    # MPC-specific.
    mpc_horizon: int = 32
    mpc_iters: int = 20
    # Terminal cost: price the end-of-horizon standing fleet at its
    # cost+carbon run-rate for this many further ticks. Node placement
    # pays off over node *lifetimes* (hours), not the 16-minute horizon —
    # without a terminal term the planner is myopic about zone carbon and
    # lingering slack (round-3 finding: MPC's carbon ratio immovable at
    # ~1.005 under any carbon price until this term landed).
    mpc_terminal_ticks: int = 120  # one further hour at 30s ticks

    def validate(self) -> None:
        if self.batch_clusters <= 0 or self.unroll_steps <= 0:
            raise ConfigError("train: non-positive batch/unroll")
        if self.learning_rate <= 0:
            raise ConfigError("train: non-positive learning rate")
        if not 0.0 < self.gamma <= 1.0:
            raise ConfigError("train: gamma out of (0,1]")
        if (self.critic_warmup_iters < 0 or self.anchor_coef < 0
                or self.adv_clip < 0 or self.actor_lr_scale <= 0):
            raise ConfigError("train: refinement knobs out of range "
                              "(warmup/anchor/adv_clip >= 0, "
                              "actor_lr_scale > 0)")
        if not 0.0 <= self.attain_target < 1.0:
            raise ConfigError("train: attain_target out of [0, 1)")
        if self.attain_target > 0 and not (
                0 < self.lagrange_min <= self.lagrange_max):
            raise ConfigError("train: lagrange bounds out of order")
        if self.migration_weight < 0:
            raise ConfigError("train: negative migration_weight")


@dataclass(frozen=True)
class FaultsConfig:
    """Fault-injection disturbance processes (`ccka_tpu/faults`).

    The simulator's only disturbance before this block was the flat
    per-node spot-interruption hazard (`SimConfig.spot_interruption_rate_hr`)
    — none of the failure modes real spot fleets exhibit (correlated
    preemption storms, insufficient-capacity errors, provisioning-delay
    jitter, signal outages) existed anywhere in the pipeline, even though
    pool class 0 *is* the spot class and the Off-Peak mode is a bet on
    spot staying up. All processes are synthesized as extra lanes in the
    packed exo stream (`signals/synthetic.py` → `faults/process.py`),
    keyed by the same ``(seed, shard, block)`` PRNG scheme as the exo
    signals, so a given fault realization is bitwise identical for every
    policy being compared.

    ``enabled=False`` (the default) is a hard gate: generation emits the
    exact pre-fault stream (no lanes, no extra key splits) and every
    consumer takes the exact pre-fault code path — the zero-fault bitwise
    parity contract `tests/test_faults.py` pins.

    Window-shaped processes (storms, ICE, outages) are thresholded
    stationary AR(1) latents: ``*_frac`` sets the stationary fraction of
    time in-window (the Gaussian threshold is computed host-side), and
    ``*_mean_ticks`` sets persistence via ``rho = exp(-1/mean_ticks)`` —
    windows come out geometrically distributed with roughly that mean,
    which doubles as the ICE "cooldown": a denial window decays over
    ~``ice_mean_ticks`` rather than flickering per tick.
    """

    enabled: bool = False
    # -- spot preemption storms: hazard multiplier on the base per-step
    # interruption probability. In-storm hazard = 1 + preempt_storm_hazard;
    # out-of-storm hazard = 1 (the calm baseline process is untouched).
    preempt_storm_hazard: float = 0.0
    preempt_storm_frac: float = 0.05
    preempt_storm_mean_ticks: int = 20
    # Price coupling: hazard is additionally scaled by
    # ``1 + coupling * max(price_anomaly, 0) / 0.04`` per zone — spot
    # capacity tightens exactly when the spot price runs above its
    # diurnal mean (0.04 is the generator's AR(1) sigma, so coupling=1
    # reads "+1x hazard per +1-sigma price anomaly"). 0 decouples.
    preempt_price_coupling: float = 0.0
    # -- insufficient-capacity errors: provisioning requests for SPOT
    # capacity are denied (fully or partially) during ICE windows. The
    # on-demand class is never denied — matching the cloud reality that
    # ICE is a spot-pool phenomenon.
    ice_frac: float = 0.0
    ice_deny_frac: float = 1.0
    ice_mean_ticks: int = 10
    # -- provisioning-delay jitter: this fraction of each tick's pipeline
    # ARRIVALS is held back one more tick (re-queued at pipeline stage 0),
    # modulated by its own AR(1) so delays come in bursts; clipped to 0.9
    # so provisioning always eventually lands.
    delay_jitter_frac: float = 0.0
    # -- signal outage/staleness windows: while active, policies observe
    # the LAST pre-outage signals (prices/carbon/demand held; is_peak is
    # clock-derived and stays true). Dynamics/accounting always use true
    # values — the outage models the metrics-scrape pipeline, not the
    # cloud provider's biller.
    outage_frac: float = 0.0
    outage_mean_ticks: int = 8

    def validate(self) -> None:
        for name in ("preempt_storm_hazard", "preempt_price_coupling",
                     "delay_jitter_frac"):
            if getattr(self, name) < 0:
                raise ConfigError(f"faults: negative {name}")
        for name in ("preempt_storm_frac", "ice_frac", "outage_frac"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ConfigError(f"faults: {name} out of [0, 1)")
        if not 0.0 <= self.ice_deny_frac <= 1.0:
            raise ConfigError("faults: ice_deny_frac out of [0, 1]")
        if self.delay_jitter_frac > 0.9:
            raise ConfigError("faults: delay_jitter_frac > 0.9 would "
                              "strand provisioning forever")
        for name in ("preempt_storm_mean_ticks", "ice_mean_ticks",
                     "outage_mean_ticks"):
            if getattr(self, name) < 1:
                raise ConfigError(f"faults: {name} must be >= 1")


@dataclass(frozen=True)
class WorkloadsConfig:
    """Heterogeneous workload families (`ccka_tpu/workloads`).

    Before round 11 the simulator modeled ONE aggregate demand signal —
    the burst Deployments' pod count — while the ROADMAP north-star
    ("heavy traffic from millions of users") means clusters that mix
    latency-sensitive inference serving with deadline-driven batch jobs.
    This block adds 2–3 workload *families* as extra lanes in the packed
    exo stream (`workloads/process.py`), consumed as per-family queue
    state by `sim/dynamics.step` and all four megakernel modes:

    - **inference**: diurnal request load with flash-crowd spikes,
      served from the fleet's headroom with priority; queueing-curve
      latency + per-tick SLO-violation accounting, drops beyond
      ``inference_queue_max``.
    - **batch**: deadline-driven backfill arriving in bursty waves
      (anti-diurnal — backfill runs when the fleet is slack), drained
      EDF from the headroom left after inference; work still unfinished
      ``batch_deadline_ticks`` after arrival is a deadline miss.
    - **background**: best-effort filler that consumes whatever
      headroom remains; backlog only, no SLO.

    ``enabled=False`` (the default) is a hard gate exactly like
    `FaultsConfig`: generation emits the pre-workload stream (no lanes)
    and every consumer takes the pre-workload code path — the
    zero-workload bitwise contract `tests/test_workloads.py` pins.
    All rates are in pod-equivalents of concurrent work per tick (one
    pod serves one unit per tick); with every rate at 0 the emitted
    lanes are EXACTLY 0, so an enabled-but-neutral stream consumes as a
    bitwise-tight no-op (queues stay empty, counters stay zero).

    Flash-crowd/burst windows reuse the fault subsystem's thresholded
    stationary AR(1) family (`faults/process._window`): ``*_frac`` is
    the stationary in-window fraction, ``*_mean_ticks`` the geometric
    window length.
    """

    enabled: bool = False
    # -- inference serving (KIS-S direction): diurnal concurrent load,
    # multiplied by flash-crowd spikes while a crowd window is active.
    inference_rate_pods: float = 0.0
    inference_flash_frac: float = 0.0
    inference_flash_mult: float = 4.0
    inference_flash_mean_ticks: int = 12
    # Queue cap (work units): arrivals beyond it are dropped (load-shed)
    # and count as an SLO violation tick.
    inference_queue_max: float = 64.0
    # p95 bound on the inference queueing-curve latency proxy; a tick
    # whose proxy exceeds it (or that drops work) is a violation tick.
    inference_slo_ms: float = 120.0
    # -- deadline-driven batch backfill (BatchBench direction).
    batch_rate_pods: float = 0.0
    batch_burst_frac: float = 0.0
    batch_burst_mult: float = 6.0
    batch_burst_mean_ticks: int = 20
    # Ticks a batch work unit has (arrival tick included) to complete;
    # unfinished work past it is a deadline miss (dropped, counted).
    batch_deadline_ticks: int = 16
    # -- best-effort background family.
    background_rate_pods: float = 0.0

    def validate(self) -> None:
        for name in ("inference_rate_pods", "batch_rate_pods",
                     "background_rate_pods"):
            if getattr(self, name) < 0:
                raise ConfigError(f"workloads: negative {name}")
        for name in ("inference_flash_frac", "batch_burst_frac"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ConfigError(f"workloads: {name} out of [0, 1)")
        if self.inference_flash_mult < 1.0 or self.batch_burst_mult < 1.0:
            raise ConfigError("workloads: spike multipliers must be >= 1 "
                              "(1 = no spike)")
        for name in ("inference_flash_mean_ticks", "batch_burst_mean_ticks",
                     "batch_deadline_ticks"):
            if getattr(self, name) < 1:
                raise ConfigError(f"workloads: {name} must be >= 1")
        if self.inference_queue_max <= 0:
            raise ConfigError("workloads: inference_queue_max must be "
                              "positive")
        if self.inference_slo_ms <= 0:
            raise ConfigError("workloads: inference_slo_ms must be "
                              "positive")


@dataclass(frozen=True)
class GeoConfig:
    """Geo-arbitrage subsystem (`ccka_tpu/regions`).

    The multiregion topology (config #4) has carried diverging regional
    carbon/price profiles since the early rounds, but regions stayed
    passive: nothing ever *moved work between them*. This block
    configures the three geo pieces:

    - **per-region exo lanes** (`regions/process.py`): price-deviation,
      carbon-deviation, migratable-capacity and migratable-family
      arrival rows, registered once as the "regions" lane family
      (`sim/lanes.register_lane_family`) so every engine derives them
      with zero per-engine edits. Region values broadcast to each
      region's zones via ``zone_region_index`` (bind it from
      ``ClusterConfig.zone_region_index``; empty = single region).
    - **migration action space** (`regions/migrate.py`): per-region-
      pair, per-workload-family migration rates in [0, 1], sanitized so
      per-source outflow never exceeds the queued mass (the work-
      conservation invariant), priced at
      ``transfer_cost_usd_per_pod`` and landing
      ``transfer_latency_ticks`` later.
    - **expectation dynamics overlay** (`regions/geo.py`): batched
      per-region, per-family queues served from the capacity lanes,
      with cost/carbon priced by the regional lanes and batch-deadline
      misses as the SLO axis — the Pareto scoreboard's three
      objectives.

    ``enabled=False`` (the default) is a hard gate in the established
    idiom: no lanes, no overlay, and the pre-geo stream/objective are
    bitwise unchanged. The neutral contract mirrors `WorkloadsConfig`:
    with every rate/sigma at 0 the emitted lanes are EXACTLY 0, and
    with every migration rate at 0 the migration objective term is
    EXACTLY 0 (the zero-migration parity gate `tests/test_regions.py`
    pins).
    """

    enabled: bool = False
    # -- per-region exo deviations (relative spot-price deviation; g/kWh
    # carbon deviation), each an AR(1) latent per region.
    price_dev_sigma: float = 0.0
    carbon_dev_sigma_g_kwh: float = 0.0
    # Regional spot-price storm windows: in-window the price deviation
    # jumps by (mult - 1) of the regional mean (the DCcluster-Opt-style
    # "spot storm" the geo suite composes).
    price_storm_frac: float = 0.0
    price_storm_mult: float = 3.0
    price_storm_mean_ticks: int = 16
    # Carbon added (g/kWh) inside the SAME storm windows — spot surges
    # ride peaker-plant dispatch, so a storm region is dirty while it
    # is expensive (what makes leaving it a cost AND carbon win).
    price_storm_carbon_g_kwh: float = 0.0
    # -- migratable capacity per region (pod-equivalents served per
    # tick), with capacity-denial windows during which a region's
    # migratable capacity collapses by deny_frac.
    capacity_pods: float = 0.0
    capacity_deny_frac: float = 1.0
    capacity_deny_window_frac: float = 0.0
    capacity_deny_mean_ticks: int = 12
    # -- migratable workload-family arrivals (pod-equivalents per tick,
    # per region; diurnal for inference, anti-diurnal for batch).
    migratable_inference_pods: float = 0.0
    migratable_batch_pods: float = 0.0
    migratable_background_pods: float = 0.0
    # Ticks a migratable batch unit has to complete; unfinished work
    # past it counts as a deadline miss (the SLO axis of the front).
    batch_deadline_ticks: int = 16
    # -- migration pricing: $ per pod-equivalent moved between regions,
    # and the in-transit latency before moved mass lands.
    transfer_cost_usd_per_pod: float = 0.0
    transfer_latency_ticks: int = 1
    # Region index per zone (bind from ClusterConfig.zone_region_index;
    # empty = every zone in region 0). Static so the lane generator
    # stays a pure (config, key, dims) closure.
    zone_region_index: Tuple[int, ...] = ()

    @property
    def n_regions(self) -> int:
        return (max(self.zone_region_index) + 1
                if self.zone_region_index else 1)

    def validate(self) -> None:
        for name in ("price_dev_sigma", "carbon_dev_sigma_g_kwh",
                     "capacity_pods", "migratable_inference_pods",
                     "migratable_batch_pods",
                     "migratable_background_pods",
                     "price_storm_carbon_g_kwh",
                     "transfer_cost_usd_per_pod"):
            if getattr(self, name) < 0:
                raise ConfigError(f"geo: negative {name}")
        for name in ("price_storm_frac", "capacity_deny_window_frac"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ConfigError(f"geo: {name} out of [0, 1)")
        if not 0.0 <= self.capacity_deny_frac <= 1.0:
            raise ConfigError("geo: capacity_deny_frac out of [0, 1]")
        if self.price_storm_mult < 1.0:
            raise ConfigError("geo: price_storm_mult must be >= 1 "
                              "(1 = no storm)")
        for name in ("price_storm_mean_ticks", "capacity_deny_mean_ticks",
                     "batch_deadline_ticks", "transfer_latency_ticks"):
            if getattr(self, name) < 1:
                raise ConfigError(f"geo: {name} must be >= 1")
        if self.zone_region_index:
            idx = self.zone_region_index
            if any(i < 0 for i in idx):
                raise ConfigError("geo: negative zone_region_index entry")
            if set(idx) != set(range(max(idx) + 1)):
                raise ConfigError("geo: zone_region_index must cover "
                                  "0..R-1 with no gaps")

    def bound_to(self, cluster: "ClusterConfig") -> "GeoConfig":
        """This config with ``zone_region_index`` bound from the cluster
        topology — the one hand-off between the cluster section and the
        pure lane generator."""
        return dataclasses.replace(
            self, zone_region_index=cluster.zone_region_index)


@dataclass(frozen=True)
class ChaosConfig:
    """Actuation-edge fault injection (`ccka_tpu/actuation/chaos.py`).

    `FaultsConfig` disturbs the *world* (preemption storms, ICE, signal
    outages); this block disturbs the *kubectl edge* — the failure modes
    the reference's apply-and-verify scripts were written to survive
    (`demo_20_offpeak_configure.sh:84-127`) and that a long-running
    controller daemon meets constantly: command timeouts, transient
    non-zero exits, patches that report success but never land (a lost
    write the read-back catches), and admission-webhook rewrites that
    mutate the patch on its way in. A `ChaosSink` wrapper injects them
    from a seeded host-side RNG, so a given chaos realization is
    identical for every paired run that shares a seed.

    ``enabled=False`` (the default) is a hard gate exactly like
    `FaultsConfig`: the wrapper delegates verbatim, draws nothing from
    its RNG, and a wrapped run is command-for-command identical to the
    bare sink (the zero-injection gate `tests/test_recovery.py` pins).
    """

    enabled: bool = False
    # P(command "hangs" and times out): reported rc!=0, no mutation.
    timeout_prob: float = 0.0
    # P(transient non-zero exit — apiserver pressure): rc!=0, no mutation.
    transient_exit_prob: float = 0.0
    # P(silent drop): the command REPORTS success but the mutation never
    # lands — the partial-apply lie only a skeptical read-back catches.
    drop_prob: float = 0.0
    # P(admission rewrite): a mutating webhook alters the patch before it
    # lands (requirement values trimmed, consolidation settings clamped);
    # the command succeeds, the read-back diverges from intent.
    rewrite_prob: float = 0.0

    def validate(self) -> None:
        for name in ("timeout_prob", "transient_exit_prob", "drop_prob",
                     "rewrite_prob"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ConfigError(f"chaos: {name} out of [0, 1]")
        if (self.timeout_prob + self.transient_exit_prob + self.drop_prob
                + self.rewrite_prob) > 1.0:
            raise ConfigError("chaos: failure probabilities sum past 1 — "
                              "each command draws one fate")


@dataclass(frozen=True)
class ObsConfig:
    """Incident-grade observability layer (`ccka_tpu/obs/`, round 14).

    Rounds 10–13 made the system *survive* chaos (fault lanes,
    crash-safe resume, overload-safe service) but left it unable to
    *explain* an incident: breaker opens, degraded transitions,
    reconcile give-ups and deadline overshoots were scattered across
    RunLog lines and Prometheus gauges with no pre-incident state
    capture and no burn-rate view. This block configures the three
    pieces that close the gap:

    - **flight recorder** (`obs/recorder.py`): a fixed-size per-tenant
      ring buffer (``ring_size`` recent ticks of lane/breaker/scrape/
      apply state) dumped as an atomic, SHA-256-checksummed capture
      (the `harness/snapshot.py` disk discipline) into ``dump_dir``
      when a trigger fires; "" keeps incidents dump-less.
    - **incident triggers** (`obs/incidents.py`): breaker open,
      hold→rule-fallback escalation, reconcile give-up, tick-deadline
      overshoot, and shed-rate spikes (``shed_spike_frac`` of the
      fleet shed in one tick) each stamp ONE structured incident
      record, appended to ``incident_log_path`` ("" = in-memory only).
    - **burn-rate engine** (`obs/burnrate.py`): fast+slow windows
      (``burn_fast_window``/``burn_slow_window`` ticks) over the
      per-tenant SLO-violation/deadline/shed counters, exported as
      `ccka_slo_burn_rate`/`ccka_incident_active` gauges.
    - **decision ledger** (`obs/decisions.py`, round 18): one
      structured row per tick and tenant — the observed (possibly
      stale) exo the policy saw, the state estimate, the chosen
      action, the per-term decomposition of the step objective, and
      the batched RULE SHADOW counterfactual (extra lanes inside the
      same device dispatch — never a second dispatch or compile) with
      its action-divergence and projected $/SLO deltas. Windowed
      divergence over ``decision_window`` ticks (a decide disagrees
      when its max-abs action delta vs the shadow exceeds
      ``divergence_threshold``); the rate crossing
      ``divergence_spike_rate`` from below stamps ONE
      `policy_divergence` incident (edge-triggered, re-armed below
      the bar). Rows append to ``decision_log_path`` ("" = in-memory
      only; `ccka decisions` reads the file);
      ``decisions_enabled=False`` skips the ledger while the rest of
      the obs layer runs (the bench_decisions off-arm).
    - **shadow tournament** (`obs/tournament.py`, round 20): the rule
      shadow generalized to a named K-candidate roster
      (``tournament_roster``) ridden as unconditional lanes of the
      same compiled ticks; a host-side win ledger scores candidates
      per workload class and region over
      ``tournament_window``-tick sliding windows, and a candidate
      sustaining ``tournament_win_rate`` for
      ``tournament_sustain_ticks`` ticks stamps ONE edge-triggered
      `challenger_sustained_win` incident plus a SIGNED promotion
      audit (``tournament_audit_key``) — never an automatic primary
      switch. ``tournament_enabled=False`` skips the ledger only
      (the bench_tournament off-arm); the roster names themselves
      are program-shaping and therefore config, not toggle.

    ``enabled=False`` (the default, preset "off") is a hard gate in
    the established idiom: no recorder, no triggers, no burn engine,
    no decision ledger — and the ENABLED path is proven bitwise
    non-interfering anyway (paired recorder-on/recorder-off runs pin
    identical decisions and patch streams, `tests/test_incidents.py`):
    all of THIS BLOCK's observation is host-side, after the tick's
    decisions. The one deliberate exception to "off costs nothing":
    the round-18 rule-shadow lanes are computed UNCONDITIONALLY by the
    compiled batched ticks, in every posture including off — keying
    them on any obs flag would make obs-on/obs-off runs compile
    DIFFERENT XLA programs and put the round-14 recorder bitwise gate
    at the compiler's mercy (the ~1-ulp separately-compiled-programs
    hazard the streaming round measured). A few ms of elementwise
    device work buys program identity across every posture;
    ARCHITECTURE §20 carries the full cost accounting, and toggling
    the ledger can therefore never select a different program —
    non-interference by construction, re-proven bitwise per record
    (`tests/test_decisions.py`).
    """

    enabled: bool = False
    # Recorder ring entries retained per tenant (and for the fleet
    # loop itself) — the pre-incident state a dump captures.
    ring_size: int = 64
    # Directory for checksummed recorder dumps; "" disables dumping
    # (incidents still stamp, with dump_path null).
    dump_dir: str = ""
    # Structured incident JSONL ("" = in-memory only; `ccka incidents`
    # reads this file).
    incident_log_path: str = ""
    # Multi-window burn rate: violating tenant-ticks per tick over a
    # fast and a slow trailing window (ticks). The classic two-window
    # discipline: fast catches a new fire, slow stops flapping.
    burn_fast_window: int = 8
    burn_slow_window: int = 64
    # Both windows above this rate => the SLO budget is burning
    # (feeds ccka_incident_active alongside fresh incidents).
    burn_threshold: float = 0.5
    # Shed-rate spike trigger: a single tick shedding at least this
    # fraction of the fleet stamps a shed_spike incident.
    shed_spike_frac: float = 0.5
    # Decision-provenance ledger (round 18, obs/decisions.py). The
    # ledger is host-side recording ONLY — the shadow lanes ride the
    # compiled tick whether or not it exists.
    decisions_enabled: bool = True
    # Per-tenant decision JSONL ("" = in-memory only; `ccka decisions
    # list|show|explain` reads this file).
    decision_log_path: str = ""
    # Trailing ticks of the windowed shadow-disagreement rate behind
    # ccka_policy_divergence_rate and the spike trigger.
    decision_window: int = 16
    # A decide "diverges" when max|chosen - rule_shadow| over the flat
    # action exceeds this (action components are O(1): zone weights,
    # ct allows, aggr in [0,1]; consolidate_after in tens of seconds).
    divergence_threshold: float = 1e-6
    # Windowed divergence rate crossing this from below stamps ONE
    # policy_divergence incident (edge-triggered).
    divergence_spike_rate: float = 0.5
    # Shadow tournament (round 20, obs/tournament.py). The roster
    # NAMES are PROGRAM-SHAPING: each one adds candidate lanes to the
    # compiled batched ticks, so they must live on the config the
    # compiled builders are keyed by (cfg.obs) — an obs override passed
    # to FleetService may not disagree with it. Everything else below
    # is host-side only: ``tournament_enabled`` toggles the ledger the
    # way ``decisions_enabled`` toggles the decision ledger, and is
    # never read by the traced function — toggling it cannot select a
    # different XLA program (the round-18 construction, re-proven
    # bitwise by `bench.py --tournament-only`).
    tournament_roster: tuple = ()
    tournament_enabled: bool = True
    # Sliding win-ledger window (ticks) behind the per-class board and
    # ccka_policy_candidate_win_rate.
    tournament_window: int = 16
    # Relative margin a candidate's projected objective must beat the
    # chosen policy's by to count a win (0 = any strict improvement).
    tournament_win_margin: float = 0.0
    # Overall windowed win rate at/above this for
    # tournament_sustain_ticks consecutive ticks stamps ONE
    # edge-triggered challenger_sustained_win incident + a signed
    # promotion audit (re-armed below the bar).
    tournament_win_rate: float = 0.6
    tournament_sustain_ticks: int = 8
    # Board + promotion-audit JSONL ("" = in-memory only; `ccka
    # tournament board|explain` reads this file).
    tournament_log_path: str = ""
    # HMAC key sealing promotion audit records (operator-configured in
    # production; the default keeps dry runs verifiable).
    tournament_audit_key: str = "ccka-tournament"

    def validate(self) -> None:
        if self.ring_size < 1:
            raise ConfigError("obs: ring_size must be >= 1")
        if self.burn_fast_window < 1 or self.burn_slow_window < 1:
            raise ConfigError("obs: burn windows must be >= 1 tick")
        if self.burn_fast_window > self.burn_slow_window:
            raise ConfigError("obs: burn_fast_window must not exceed "
                              "burn_slow_window — the fast window is "
                              "the short fuse, the slow one the "
                              "flap damper")
        if not 0.0 < self.burn_threshold <= 1.0:
            raise ConfigError("obs: burn_threshold out of (0, 1]")
        if not 0.0 < self.shed_spike_frac <= 1.0:
            raise ConfigError("obs: shed_spike_frac out of (0, 1]")
        if self.decision_window < 1:
            raise ConfigError("obs: decision_window must be >= 1 tick")
        if self.divergence_threshold < 0.0:
            raise ConfigError("obs: divergence_threshold must be >= 0")
        if not 0.0 < self.divergence_spike_rate <= 1.0:
            raise ConfigError("obs: divergence_spike_rate out of (0, 1]")
        if not isinstance(self.tournament_roster, tuple):
            raise ConfigError("obs: tournament_roster must be a tuple "
                              "of candidate names (it keys the "
                              "compiled-tick cache)")
        if len(set(self.tournament_roster)) != len(
                self.tournament_roster):
            raise ConfigError("obs: tournament_roster has duplicate "
                              "candidate names — one lane per name")
        if self.tournament_window < 1:
            raise ConfigError("obs: tournament_window must be >= 1 tick")
        if self.tournament_win_margin < 0.0:
            raise ConfigError("obs: tournament_win_margin must be >= 0")
        if not 0.0 < self.tournament_win_rate <= 1.0:
            raise ConfigError("obs: tournament_win_rate out of (0, 1]")
        if self.tournament_sustain_ticks < 1:
            raise ConfigError("obs: tournament_sustain_ticks must be "
                              ">= 1")


# The flight-recorder postures (`bench.py bench_obs`, `ccka fleet
# --obs`): "off" is the hard gate (no recorder/triggers/burn engine);
# "default" is the incident-grade posture the r14 board runs.
OBS_PRESETS: dict[str, ObsConfig] = {
    "off": ObsConfig(),
    "default": ObsConfig(enabled=True),
}


@dataclass(frozen=True)
class ServiceConfig:
    """Multi-tenant fleet service layer (`ccka_tpu/harness/service.py`).

    ROADMAP item 4's host-loop half: `harness/fleet.tick` grown into a
    service that fans in scrapes from many tenant clusters and batches
    every pending decide() into ONE device dispatch per tick — while
    staying responsive when individual tenants misbehave (hung scrapes,
    chaos-injected kubectl edges). The knobs below are the three
    robustness mechanisms:

    - **bounded batched ticks**: per-tick scrape work is budgeted
      (``tick_deadline_ms`` split by ``scrape_budget_frac``); tenants
      whose scrape would run past the budget are DEFERRED to the next
      tick (the straggler is abandoned, never awaited), so one hung
      tenant cannot stall the fleet's dispatch cadence.
    - **per-tenant bulkheads + circuit breakers**: ``breaker_failures``
      consecutive scrape/actuation failures open a tenant's breaker
      (closed→open→half-open, seeded-jitter probe schedule mirroring
      `RetryingFetch`); while open, the tenant's scrape AND fan-out are
      skipped entirely (no tick budget spent on a known-bad edge) and
      it rides a hold/rule-fallback decision lane. After
      ``hold_fallback_after`` open ticks the lane escalates from
      hold-last-action to the rule fallback — the same ok→hold→fallback
      shape as the single-cluster degraded machine.
    - **backpressure + load shedding**: ``admission_queue_cap`` bounds
      how many tenant decides are admitted per tick (0 = fleet size);
      overflow is SHED by explicit priority (stale-tolerant tenants
      first), every shed is counted, and ``shed_backoff_after``
      consecutive saturated ticks degrade stale-tolerant tenants' decide
      cadence (up to ``cadence_backoff_max``x) instead of growing
      unbounded backlog.

    ``enabled=False`` (the default, preset "off") is a hard gate in the
    ChaosSink-"off" idiom: `FleetService` delegates every tick verbatim
    to the pre-service `FleetController` path — byte-identical packed
    actions and command streams, pinned by `tests/test_service.py`.
    """

    enabled: bool = False
    # Admission-queue capacity in tenant decides per tick; 0 = fleet
    # size (bounded by the batch, never unbounded backlog).
    admission_queue_cap: int = 0
    # Hard per-tick budget; 0 disables deadline enforcement. Stragglers
    # past the scrape share of it are deferred, not awaited.
    tick_deadline_ms: float = 0.0
    # Fraction of the deadline granted to the scrape/admission phase;
    # the rest bounds the actuation fan-out.
    scrape_budget_frac: float = 0.5
    # Consecutive per-tenant failures (scrape timeout/stale OR reconcile
    # give-up) that open the tenant's breaker.
    breaker_failures: int = 3
    # Open→half-open probe schedule: base delay in ticks, doubled per
    # consecutive re-open, jittered multiplicatively by U(1-j, 1+j)
    # from a seeded RNG (deterministic for paired runs), capped.
    breaker_probe_ticks: int = 4
    breaker_probe_jitter: float = 0.25
    breaker_max_probe_ticks: int = 64
    # Open ticks after which a tenant's decision lane escalates from
    # hold-last-action to the rule fallback profile.
    hold_fallback_after: int = 6
    # Saturated (shedding) ticks before stale-tolerant tenants' decide
    # cadence degrades; each further saturation streak doubles the
    # cadence divisor up to the cap.
    shed_backoff_after: int = 2
    cadence_backoff_max: int = 8

    def validate(self) -> None:
        if self.admission_queue_cap < 0:
            raise ConfigError("service: negative admission_queue_cap")
        if self.tick_deadline_ms < 0:
            raise ConfigError("service: negative tick_deadline_ms")
        if not 0.0 < self.scrape_budget_frac < 1.0:
            raise ConfigError("service: scrape_budget_frac out of (0,1) "
                              "— both phases need a share of the tick")
        if self.breaker_failures < 1:
            raise ConfigError("service: breaker_failures must be >= 1")
        if self.breaker_probe_ticks < 1:
            raise ConfigError("service: breaker_probe_ticks must be >= 1")
        if not 0.0 <= self.breaker_probe_jitter < 1.0:
            raise ConfigError("service: breaker_probe_jitter out of "
                              "[0, 1)")
        if self.breaker_max_probe_ticks < self.breaker_probe_ticks:
            raise ConfigError("service: breaker_max_probe_ticks below "
                              "breaker_probe_ticks")
        if self.hold_fallback_after < 1:
            raise ConfigError("service: hold_fallback_after must be >= 1")
        if self.shed_backoff_after < 1:
            raise ConfigError("service: shed_backoff_after must be >= 1")
        if self.cadence_backoff_max < 1:
            raise ConfigError("service: cadence_backoff_max must be >= 1")


# The overload scoreboard's named service postures (`bench.py
# bench_overload`, `ccka overload-eval`). "off" is the hard gate the
# byte-identity test pins against the pre-service fleet loop; "default"
# is the bounded posture the scoreboard runs; "strict" tightens the
# deadline and cap for saturation studies.
SERVICE_PRESETS: dict[str, ServiceConfig] = {
    "off": ServiceConfig(enabled=False),
    # The scrape share is deliberately below half: the batched device
    # dispatch between scrape and fan-out is ONE un-preemptible unit
    # (the host cannot abandon it at the deadline the way it abandons a
    # hung scrape), so the posture must leave it structural headroom —
    # deadline - scrape budget - fan-out reserve is the dispatch's
    # allowance, not a hope.
    "default": ServiceConfig(enabled=True, tick_deadline_ms=250.0,
                             scrape_budget_frac=0.4),
    "strict": ServiceConfig(enabled=True, tick_deadline_ms=100.0,
                            scrape_budget_frac=0.4, breaker_failures=2,
                            breaker_probe_ticks=8),
}


# The recovery scoreboard's named actuation intensities (`bench.py
# bench_recovery`, `ccka recover-eval`) — the kubectl-edge mirror of
# FAULT_PRESETS. "off" is enabled-but-neutral: the wrapper is in the
# path but injects nothing, which the zero-injection gate pins as
# command-for-command identical to the bare sink.
CHAOS_PRESETS: dict[str, ChaosConfig] = {
    "off": ChaosConfig(enabled=True),
    "mild": ChaosConfig(
        enabled=True, timeout_prob=0.02, transient_exit_prob=0.03,
        drop_prob=0.02, rewrite_prob=0.01),
    "moderate": ChaosConfig(
        enabled=True, timeout_prob=0.05, transient_exit_prob=0.08,
        drop_prob=0.05, rewrite_prob=0.03),
    "severe": ChaosConfig(
        enabled=True, timeout_prob=0.10, transient_exit_prob=0.15,
        drop_prob=0.12, rewrite_prob=0.08),
}


# The robustness scoreboard's named intensities (`bench.py bench_faults`,
# `ccka chaos-eval`): the same storm/ICE/outage latent processes (same
# key → same storm timing) at rising severities, so the degradation curve
# is a genuine dose-response over one shared realization family. "off"
# is the enabled-but-neutral config — the stream widens with lanes that
# are exactly (hazard=1, deny=0, delay=0, outage=0), which the zero-fault
# bitwise gate pins against the un-widened pipeline.
FAULT_PRESETS: dict[str, FaultsConfig] = {
    "off": FaultsConfig(enabled=True),
    "mild": FaultsConfig(
        enabled=True, preempt_storm_hazard=5.0, preempt_storm_frac=0.02,
        preempt_price_coupling=0.5, ice_frac=0.02, ice_deny_frac=0.7,
        delay_jitter_frac=0.10, outage_frac=0.02),
    "moderate": FaultsConfig(
        enabled=True, preempt_storm_hazard=15.0, preempt_storm_frac=0.05,
        preempt_price_coupling=1.0, ice_frac=0.05, ice_deny_frac=0.9,
        delay_jitter_frac=0.25, outage_frac=0.05),
    "severe": FaultsConfig(
        enabled=True, preempt_storm_hazard=40.0, preempt_storm_frac=0.10,
        preempt_price_coupling=2.0, ice_frac=0.12, ice_deny_frac=1.0,
        delay_jitter_frac=0.40, outage_frac=0.12),
}


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of `parallel/mesh.py::make_mesh`: a
    ``[data, model]`` grid of torch devices driven by one process.

    The cluster batch is split over the ``data`` axis (each shard's work on
    its row's device, results returned per shard); ``model`` splits the
    policy net's Dense kernels by output columns. ``data_parallel`` -1
    means "every available device divided by ``model_parallel``".
    """

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1

    def validate(self) -> None:
        if self.model_parallel <= 0:
            raise ConfigError("mesh: model_parallel must be positive")
        if self.data_parallel != -1 and self.data_parallel <= 0:
            raise ConfigError("mesh: data_parallel must be -1 (all devices) or positive")


# ---------------------------------------------------------------------------
# Root config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FrameworkConfig:
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    signals: SignalsConfig = field(default_factory=SignalsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    faults: FaultsConfig = field(default_factory=FaultsConfig)
    workloads: WorkloadsConfig = field(default_factory=WorkloadsConfig)
    geo: GeoConfig = field(default_factory=GeoConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def validate(self) -> "FrameworkConfig":
        self.cluster.validate()
        self.workload.validate()
        self.sim.validate()
        self.signals.validate()
        self.train.validate()
        self.mesh.validate()
        self.faults.validate()
        self.workloads.validate()
        self.geo.validate()
        if self.geo.zone_region_index and len(
                self.geo.zone_region_index) != self.cluster.n_zones:
            raise ConfigError(
                "geo: zone_region_index length does not match the "
                "cluster's zone count — bind it with GeoConfig.bound_to")
        self.chaos.validate()
        self.service.validate()
        self.obs.validate()
        # Cross-section: a live multi-region fleet must name each region's
        # grid zone — silently falling back to the global carbon_zone would
        # price one region's zones by another region's grid, flattening the
        # very divergence multi-region exists to exploit.
        if self.signals.backend == "live" and self.cluster.regions:
            missing = [r.name for r in self.cluster.regions
                       if not r.carbon_zone]
            if missing:
                raise ConfigError(
                    f"signals: live backend with regions {missing} lacking "
                    "carbon_zone — set RegionSpec.carbon_zone per region")
        return self

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FrameworkConfig":
        return _from_dict(cls, d).validate()

    @classmethod
    def from_json(cls, s: str) -> "FrameworkConfig":
        return cls.from_dict(json.loads(s))

    def with_overrides(self, **dotted: Any) -> "FrameworkConfig":
        """Apply dotted-path overrides, e.g. ``sim__dt_s=15`` or
        ``{"sim.dt_s": 15}`` via ``with_overrides(**{"sim.dt_s": 15})``."""
        d = self.to_dict()
        for key, value in dotted.items():
            path = key.replace("__", ".").split(".")
            node = d
            for part in path[:-1]:
                if not isinstance(node, dict) or part not in node:
                    raise ConfigError(f"override: unknown section {part!r} in {key!r}")
                node = node[part]
            if not isinstance(node, dict) or path[-1] not in node:
                raise ConfigError(f"override: unknown field {path[-1]!r} in {key!r}")
            node[path[-1]] = value
        return FrameworkConfig.from_dict(d)


def default_config() -> FrameworkConfig:
    """The demo-equivalent default config, validated."""
    return FrameworkConfig().validate()


def multi_region_config() -> FrameworkConfig:
    """BASELINE.json config #4: 4 zones spanning two regions with diverging
    grid-carbon profiles, for carbon-aware placement/migration.

    East models a MISO-style grid — high base intensity, shallow solar dip;
    West models CAISO — lower base, deep duck-curve midday dip, 3h-later
    solar peak. The dummy-carbon magnitude anchors to the reference's
    documented ~400 g/kWh fallback (`.env:14-16`).
    """
    cluster = ClusterConfig(
        name="demo-multiregion",
        region="us-east-2",
        regions=(
            RegionSpec(name="us-east-2",
                       zones=("us-east-2a", "us-east-2b"),
                       carbon_zone="US-MIDW-MISO",
                       carbon_base_g_kwh=520.0,
                       solar_frac=0.15,
                       tz_offset_hr=0.0),
            RegionSpec(name="us-west-2",
                       zones=("us-west-2a", "us-west-2b"),
                       carbon_zone="US-CAL-CISO",
                       carbon_base_g_kwh=300.0,
                       solar_frac=0.55,
                       tz_offset_hr=-3.0,
                       od_price_scale=1.04),
        ),
        offpeak_zones=("us-east-2a",),
        peak_zones=("us-east-2b",),
    )
    return FrameworkConfig(cluster=cluster).validate()


PRESETS = {
    "default": default_config,
    "multiregion": multi_region_config,
}


def config_from_env(base: FrameworkConfig | None = None,
                    environ: Mapping[str, str] | None = None) -> FrameworkConfig:
    """Apply ``CCKA_SECTION_FIELD=value`` environment overrides.

    This is the analog of the reference's `.env` + `source` scheme
    (`00_common.sh:5-10`): e.g. ``CCKA_SIM_DT_S=15``,
    ``CCKA_SIGNALS_CARBON_ZONE=DE``. Values are JSON-decoded when possible
    (numbers, booleans, arrays), else taken as strings.
    """
    base = base or default_config()
    environ = os.environ if environ is None else environ
    overrides: dict[str, Any] = {}
    sections = {f.name: f.type for f in fields(FrameworkConfig)}
    for key, raw in environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        rest = key[len(ENV_PREFIX):].lower()
        section = rest.split("_", 1)[0]
        if section not in sections or "_" not in rest:
            continue
        field_name = rest.split("_", 1)[1]
        try:
            value: Any = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            value = raw
        if isinstance(value, list):
            value = tuple(value)
        overrides[f"{section}.{field_name}"] = value
    if not overrides:
        return base
    return base.with_overrides(**overrides)


# ---------------------------------------------------------------------------
# Generic dataclass <-> dict plumbing
# ---------------------------------------------------------------------------


def _asdict(obj: Any) -> Any:
    if is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, tuple):
        return [_asdict(x) for x in obj]
    return obj


_NESTED_TYPES = {
    "node_type": NodeTypeSpec,
    "pools": PoolSpec,
    "regions": RegionSpec,
    "cluster": ClusterConfig,
    "workload": WorkloadConfig,
    "sim": SimConfig,
    "signals": SignalsConfig,
    "train": TrainConfig,
    "mesh": MeshConfig,
    "faults": FaultsConfig,
    "workloads": WorkloadsConfig,
    "geo": GeoConfig,
    "chaos": ChaosConfig,
    "service": ServiceConfig,
    "obs": ObsConfig,
}


def _from_dict(cls: type, d: Mapping[str, Any]) -> Any:
    kwargs: dict[str, Any] = {}
    valid = {f.name for f in fields(cls)}
    for key, value in d.items():
        if key not in valid:
            raise ConfigError(f"{cls.__name__}: unknown field {key!r}")
        nested = _NESTED_TYPES.get(key)
        if nested is not None and isinstance(value, Mapping):
            kwargs[key] = _from_dict(nested, value)
        elif nested is not None and isinstance(value, (list, tuple)):
            kwargs[key] = tuple(
                _from_dict(nested, v) if isinstance(v, Mapping) else v
                for v in value
            )
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def require(condition: bool, message: str) -> None:
    """Hard-fail assertion helper, analog of `require_var` (`00_common.sh:18-20`)."""
    if not condition:
        raise ConfigError(message)
