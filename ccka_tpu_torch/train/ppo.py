"""The PPO policy as a decision backend.

The PyTorch form of `ccka_tpu/train/ppo.py::PPOBackend`: the deterministic
(mean-action) policy of trained ActorCritic params. The trainer itself is
not ported yet.
"""

from __future__ import annotations

from ccka_tpu_torch import bridge, resolve_device
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.models import ActorCritic, latent_dim, latent_to_action
from ccka_tpu_torch.policy.base import PolicyBackend, observe
from ccka_tpu_torch.sim.dynamics import ExoStep
from ccka_tpu_torch.sim.types import Action, ClusterState, SimParams


class PPOBackend(PolicyBackend):
    """Deterministic (mean-action) policy from trained PPO params.

    ``params`` is the ActorCritic params tree in the checkpoints' layout
    (`bridge.actor_critic_from_flax`); it stays available as
    ``self.params`` for the rollout kernel's entries, which take the tree.
    """

    def __init__(self, cfg: FrameworkConfig, params: dict, device=None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.cluster = cfg.cluster
        self.params_sim = SimParams.from_config(cfg, device=dev)
        self.params = params
        state = bridge.actor_critic_from_flax(params)
        hidden = [state[f"Dense_{i}.bias"].shape[-1]
                  for i in range(sum(k.startswith("Dense_")
                                     and k.endswith(".bias") for k in state))]
        self.net = ActorCritic(state["Dense_0.weight"].shape[-1],
                               latent_dim(cfg.cluster), hidden)
        self.net.load_state_dict(state)
        self.net.to(dev).requires_grad_(False)

    def decide(self, state: ClusterState, exo: ExoStep, t: int) -> Action:
        obs = observe(self.params_sim, state, exo).flatten()
        mean, _, _ = self.net(obs)
        return latent_to_action(mean, self.cluster)
