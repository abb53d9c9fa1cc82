"""Behavior cloning: distill a teacher PolicyBackend into the policy net.

The PyTorch form of `ccka_tpu/train/imitate.py`. PPO from scratch explores
into gross overprovisioning before the diffuse cost and carbon gradient
can walk it back; distilling a strong teacher (the carbon-aware policy
beats the rule on the multiregion fleet) gives a learned policy at the
teacher's operating point, which `train/flagship.py` then selects or
refines with small exploration.

Collection rolls the teacher through stochastic dynamics over a cluster
batch and records (observation, teacher latent, discounted return) per
(tick, cluster); distillation is minibatch Adam on two MSEs (actor mean
-> teacher latent, critic -> observed discounted return).

Rows are flattened time-major (row ``t * B + b``), as in the JAX package,
so a dataset and a row index mean the same in both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ccka_tpu_torch import bridge, resolve_device
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.models import ActorCritic, action_to_latent, latent_dim
from ccka_tpu_torch.policy.base import PolicyBackend, observe
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim.dynamics import clip
from ccka_tpu_torch.sim.rollout import initial_state, rollout
from ccka_tpu_torch.sim.types import SimParams
from ccka_tpu_torch.train.objective import step_reward
from ccka_tpu_torch.train.optim import Adam
from ccka_tpu_torch.train.ppo import _REWARD_SCALE

# Teacher actions sit at the corners of the feasible box (one-hot zone
# weights etc.); the exact inverse-codec logits are clipped at about
# +-9.2 where the sigmoid saturates. +-3 (sigmoid ~ 0.95 / 0.05)
# reproduces the teacher's behavior while keeping every coordinate
# trainable.
_TARGET_CLIP = 3.0


class ImitationBatch(NamedTuple):
    obs: torch.Tensor      # [N, F]
    target: torch.Tensor   # [N, A] clipped teacher latents
    returns: torch.Tensor  # [N] discounted reward-to-go (critic target)


def _time_major(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [T * B, ...], row t * B + b."""
    return x.transpose(0, 1).reshape(-1, *x.shape[2:])


def discounted_returns(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """Reward-to-go ``g_t = r_t + gamma * g_{t+1}`` over the time axis of
    [B, T] rewards."""
    g = torch.zeros_like(rewards[:, 0])
    out = [None] * rewards.shape[1]
    for t in reversed(range(rewards.shape[1])):
        g = rewards[:, t] + gamma * g
        out[t] = g
    return torch.stack(out, dim=1)


@torch.no_grad()
def collect_dataset(cfg: FrameworkConfig, teacher: PolicyBackend, source, *,
                    batch_clusters: int | None = None,
                    steps: int | None = None, seed: int = 0,
                    traces: ExogenousTrace | None = None,
                    device=None) -> ImitationBatch:
    """Roll the teacher through stochastic dynamics; record (observation,
    clipped teacher latent, discounted return) per (tick, cluster).

    The traces ([B, T, ...]) are ``traces`` when given, else made from
    ``source`` (on the device from a generator seeded with ``seed`` under
    ``train.device_traces``, else from numpy seeds ``seed .. seed + B -
    1``); the world seed of the interruption draws is ``seed + 1``."""
    dev = resolve_device(device)
    b = batch_clusters or cfg.train.batch_clusters
    t = steps or cfg.train.unroll_steps * 4
    params = SimParams.from_config(cfg, device=dev)
    if traces is None:
        traces = (source.batch_trace_device(
            t, torch.Generator(device=dev).manual_seed(seed), b, device=dev)
            if cfg.train.device_traces and hasattr(source,
                                                   "batch_trace_device")
            else source.batch_trace(t, range(seed, seed + b), device=dev))
    traces = traces.to(dev)
    action_fn = teacher.action_fn()
    obs_t, lat_t = [], []

    def decide(state, exo, ti):
        action = action_fn(state, exo, ti)
        obs_t.append(observe(params, state, exo).flatten())
        lat_t.append(action_to_latent(action, cfg.cluster))
        return action

    states0 = initial_state(cfg, traces.is_peak.shape[0], dev)
    _, metrics = rollout(params, states0, decide, traces, seed + 1,
                         stochastic=True)
    rewards = step_reward(metrics, cfg.train) * _REWARD_SCALE
    returns = discounted_returns(rewards, cfg.train.gamma)
    lat = torch.stack(lat_t, dim=1)
    return ImitationBatch(
        obs=_time_major(torch.stack(obs_t, dim=1)),
        target=clip(_time_major(lat), -_TARGET_CLIP, _TARGET_CLIP),
        returns=_time_major(returns))


def imitate(cfg: FrameworkConfig, teacher: PolicyBackend | None, source, *,
            iterations: int = 2000, minibatch: int = 4096,
            learning_rate: float = 1e-3, seed: int = 0,
            dataset: ImitationBatch | None = None, init_params=None,
            indices=None, device=None):
    """Distill ``teacher`` into a fresh ActorCritic; returns ``(params,
    history)``, the params a flax-layout tree of numpy arrays (the
    checkpoints' layout: PPOBackend and the rollout kernels take it).

    ``dataset`` skips collection; ``init_params`` (a flax-layout tree)
    warm-starts instead of a fresh init (flax's initialisation from a
    CPU generator seeded with ``seed + 2``). Each step draws its
    minibatch rows uniformly with replacement from a generator seeded
    with ``seed + 3``; ``indices`` ([iterations, minibatch] row indices)
    gives them instead."""
    dev = resolve_device(device)
    data = dataset if dataset is not None else collect_dataset(
        cfg, teacher, source, seed=seed, device=dev)
    data = ImitationBatch(*(torch.as_tensor(x, dtype=torch.float32).to(dev)
                            for x in data))
    net = ActorCritic(data.obs.shape[-1], latent_dim(cfg.cluster),
                      init_log_std=cfg.train.init_log_std,
                      generator=torch.Generator().manual_seed(seed + 2))
    if init_params is not None:
        net.load_state_dict(bridge.actor_critic_from_flax(init_params))
    net.to(dev)
    params = [p.detach() for p in net.parameters()]
    names = [k for k, _ in net.named_parameters()]
    opt = Adam(learning_rate)
    opt_state = opt.init(params)
    n = data.obs.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    if indices is not None:
        indices = torch.as_tensor(np.asarray(indices), dtype=torch.int64,
                                  device=dev)

    def loss_fn(p, idx):
        mean, _log_std, value = torch.func.functional_call(
            net, dict(zip(names, p)), (data.obs[idx],))
        actor = ((mean - data.target[idx]) ** 2).mean()
        critic = ((value - data.returns[idx]) ** 2).mean()
        return actor + 0.5 * critic, (actor.detach(), critic.detach())

    history = []
    for it in range(iterations):
        idx = (indices[it] if indices is not None else torch.randint(
            n, (minibatch,), generator=gen, device=dev))
        with torch.enable_grad():
            leaves = [p.requires_grad_(True) for p in
                      (q.detach() for q in params)]
            loss, (actor_l, critic_l) = loss_fn(leaves, idx)
            # log_std takes no part in the loss: a zero gradient, as
            # jax.grad gives an unused leaf.
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
                leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        updates, opt_state = opt.update(grads, opt_state)
        params = [p.detach() + u for p, u in zip(params, updates)]
        if it % max(1, iterations // 10) == 0 or it == iterations - 1:
            history.append({"iteration": it,
                            "actor_mse": float(actor_l),
                            "critic_mse": float(critic_l)})
    return bridge.actor_critic_to_flax(dict(zip(names, params))), history


def build_teacher(cfg: FrameworkConfig, teacher_name: str,
                  device=None) -> PolicyBackend:
    """The one teacher-name registry (flagship's
    ``init_from=distill:<name>`` resolves here too)."""
    from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
    from ccka_tpu_torch.policy.rule import RulePolicy

    teachers = {
        "carbon": lambda: CarbonAwarePolicy(cfg.cluster, device=device),
        "rule": lambda: RulePolicy(cfg.cluster, device=device),
    }
    if teacher_name not in teachers:
        raise ValueError(f"unknown teacher {teacher_name!r} "
                         f"(known: {sorted(teachers)})")
    return teachers[teacher_name]()


def distill_teacher(cfg: FrameworkConfig, teacher_name: str = "carbon", *,
                    seed: int = 0, iterations: int = 2000,
                    batch_clusters: int | None = None,
                    steps: int | None = None, minibatch: int = 4096,
                    device=None):
    """Build the named teacher, collect, distill. Returns ``(params,
    history)``."""
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    dev = resolve_device(device)
    src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                cfg.signals)
    teacher = build_teacher(cfg, teacher_name, device=dev)
    data = collect_dataset(cfg, teacher, src, batch_clusters=batch_clusters,
                           steps=steps, seed=seed, device=dev)
    return imitate(cfg, teacher, src, seed=seed, iterations=iterations,
                   minibatch=minibatch, dataset=data, device=dev)
