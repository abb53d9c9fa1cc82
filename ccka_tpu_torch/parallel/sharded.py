"""Mesh-sharded entry points for the plain batched rollout and PPO.

The PyTorch form of `ccka_tpu/parallel/sharded.py`. The cluster batch is
split over the mesh's ``data`` axis and the parameters replicated; each
shard's rollout runs on its device, in shard order, with its first
cluster's global index, so its spot interruptions are the fleet's
(`sim/random.py` addresses them by (seed, cluster, tick, row)). Results
come back per shard (`parallel/mesh.py::Sharded`). The rollout needs no
cross-shard step at all; the PPO iteration's only one is the batch-mean
loss, a fixed-order sum of the shards' sums (`train/ppo.py`).
"""

from __future__ import annotations

from ccka_tpu_torch.parallel.mesh import (ColumnSharded, Mesh, Replicated,
                                          Sharded, replicate, shard_batch)


def _per_shard(mesh: Mesh, params, states0, traces, action_fn,
               action_fn_for):
    """Yields ``(device, params, states, traces, action_fn, cluster0)``
    per data shard."""
    params = replicate(mesh, params)
    states = shard_batch(mesh, states0)
    tr = shard_batch(mesh, traces)
    for i, dev in enumerate(mesh.data_devices()):
        fn = action_fn_for(dev) if action_fn_for is not None else action_fn
        yield (params.on(dev), states.parts[i], tr.parts[i], fn,
               states.offsets[i])


def sharded_batched_rollout(mesh: Mesh, params, states0, action_fn, traces,
                            seed: int = 0, *, stochastic: bool = False,
                            action_fn_for=None) -> tuple[Sharded, Sharded]:
    """`sim/rollout.py::rollout` with the cluster batch split over
    ``data``: ``(final_state, metrics)``, each a :class:`Sharded` of the
    shards' results. Inputs may live anywhere; they are placed here
    (params replicated, batch sharded). ``action_fn`` closes over tensors
    of one device; on a mesh of several devices pass ``action_fn_for``
    (device -> action_fn) instead."""
    from ccka_tpu_torch.sim.rollout import rollout

    finals, metrics, offsets = [], [], []
    for p, s, tr, fn, c0 in _per_shard(mesh, params, states0, traces,
                                       action_fn, action_fn_for):
        f, m = rollout(p, s, fn, tr, seed, stochastic=stochastic,
                       cluster0=c0)
        finals.append(f)
        metrics.append(m)
        offsets.append(c0)
    return (Sharded(finals, offsets, mesh), Sharded(metrics, offsets, mesh))


def sharded_batched_rollout_summary(mesh: Mesh, params, states0, action_fn,
                                    traces, seed: int = 0, *,
                                    stochastic: bool = False,
                                    action_fn_for=None, faults=None,
                                    workloads=None
                                    ) -> tuple[Sharded, Sharded]:
    """The mesh-sharded summarize-in-loop rollout: per-cluster
    EpisodeSummary without stacking per-tick metrics
    (`sim/rollout.py::batched_rollout_summary`), arguments as for
    :func:`sharded_batched_rollout`; ``faults`` and ``workloads`` (the
    stream's lanes, batch first) split with the traces."""
    from ccka_tpu_torch.sim.rollout import batched_rollout_summary

    lanes = {k: None if v is None else shard_batch(mesh, v)
             for k, v in (("faults", faults), ("workloads", workloads))}
    finals, summaries, offsets = [], [], []
    for i, (p, s, tr, fn, c0) in enumerate(_per_shard(
            mesh, params, states0, traces, action_fn, action_fn_for)):
        f, summ = batched_rollout_summary(
            p, s, fn, tr, seed, stochastic=stochastic, cluster0=c0,
            **{k: None if v is None else v.parts[i]
               for k, v in lanes.items()})
        finals.append(f)
        summaries.append(summ)
        offsets.append(c0)
    return (Sharded(finals, offsets, mesh),
            Sharded(summaries, offsets, mesh))


def shard_ppo_state(mesh: Mesh, ts):
    """Place a `train/ppo.py::PPOTrainState` on the mesh: the worlds split
    over ``data``, the params replicated. The trainer's iteration accepts
    the result as it is (collect per shard, one batch-mean loss over all
    of them); ``shard_params`` on its ``params`` adds the ``model`` axis.
    The optimizer's moments stay where they are: the one process updates
    the parameters once for all shards."""
    return ts._replace(
        params={k: v if isinstance(v, (Replicated, ColumnSharded))
                else replicate(mesh, v) for k, v in ts.params.items()},
        env_states=shard_batch(mesh, ts.env_states))
