"""Policy networks for the learned backends and the latent action codec."""

from ccka_tpu_torch.models.nets import (  # noqa: F401
    ActorCritic,
    PolicyMLP,
    action_to_latent,
    latent_dim,
    latent_to_action,
)
