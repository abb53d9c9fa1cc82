"""The shipped flagship policies: where they live and how they load.

The PyTorch form of the loading half of `ccka_tpu/train/flagship.py`. The
checkpoints under ``ccka_tpu_torch/checkpoints/`` are byte copies of the
JAX package's, so the port stands without that package on disk. The
trainer that produced them is not ported yet.
"""

from __future__ import annotations

import os
import sys

from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.train.checkpoint import load_params_npz
from ccka_tpu_torch.train.ppo import PPOBackend

_CHECKPOINTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")


def flagship_checkpoint_path(cfg: FrameworkConfig | None = None, *,
                             variant: str = "") -> str:
    """Absolute path of the shipped checkpoint (inside the package).

    Keyed by topology: a multi-region config loads the multi-region
    checkpoint, since the nets' observation and action widths differ with
    the zone count. ``variant="replay"`` names the replay-family
    checkpoint (default topology)."""
    if variant:
        name = f"ppo_flagship_{variant}.npz"
    elif cfg is not None and cfg.cluster.regions:
        name = "ppo_flagship_multiregion.npz"
    else:
        name = "ppo_flagship.npz"
    return os.path.join(_CHECKPOINTS, name)


def load_flagship_backend(cfg: FrameworkConfig, *, variant: str = "",
                          device=None):
    """(PPOBackend, meta) from the shipped checkpoint, or (None, None) if
    none is shipped for this config. Published quality numbers come from
    these selected params, not from a fresh training run."""
    path = flagship_checkpoint_path(cfg, variant=variant)
    if not os.path.exists(path):
        return None, None
    params, meta = load_params_npz(path)
    # Provenance at load time: whether the params were a trained winner or
    # a fallback init.
    print(f"# flagship checkpoint {os.path.basename(path)}: "
          f"selected_iteration={meta.get('selected_iteration')} "
          f"init_from={meta.get('init_from')} "
          f"wins_both={meta.get('wins_both')}", file=sys.stderr)
    return PPOBackend(cfg, params, device=device), meta
