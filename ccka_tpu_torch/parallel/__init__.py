"""Device-mesh parallelism: the cluster batch split over several devices.

The PyTorch form of `ccka_tpu/parallel/`. One process drives a
``[data, model]`` grid of devices (`mesh.py`): the cluster batch splits
over ``data`` (clusters are independent, so a rollout needs no
cross-shard step), the policy net's Dense kernels over ``model``. The
sharded kernel entries (`sharded_kernel.py`) launch each shard with its
first cluster's global index, bitwise the single launch on the
concatenated batch; the plain rollouts and PPO (`sharded.py`) run per
shard, PPO's batch-mean loss a fixed-order sum over the shards.
"""

from ccka_tpu_torch.parallel.mesh import (  # noqa: F401
    ColumnSharded,
    Mesh,
    Replicated,
    Sharded,
    batch_sharding,
    batch_spec,
    gather,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
)
from ccka_tpu_torch.parallel.sharded import (  # noqa: F401
    shard_ppo_state,
    sharded_batched_rollout,
    sharded_batched_rollout_summary,
)
from ccka_tpu_torch.parallel.sharded_kernel import (  # noqa: F401
    shard_lane_blocks,
    shard_plan_stream,
    shard_seed,
    sharded_block_packed_trace,
    sharded_packed_mode_block_summary_fn,
    sharded_carbon_megakernel_rollout_summary,
    sharded_carbon_summary_from_packed,
    sharded_megakernel_rollout_summary,
    sharded_megakernel_summary_from_packed,
    sharded_neural_megakernel_rollout_summary,
    sharded_neural_summary_from_packed,
    sharded_packed_trace,
    sharded_plan_summary_from_packed,
)
