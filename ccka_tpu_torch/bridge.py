"""Carry the JAX package's tuples and params trees across as the port's.

The port never imports JAX. A caller that holds the JAX package's
``SimParams``, ``Action`` or ``ExogenousTrace`` turns them into plain
dicts of numpy arrays on its side (``jax.tree.map(np.asarray,
x)._asdict()``) and hands those dicts here, so the same inputs go through
both implementations. An ActorCritic params tree (the flax layout, which
is also the checkpoints') turns into an ``nn.Module`` state dict and back.
"""

from __future__ import annotations

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim.types import Action, SimParams

_INT_FIELDS = ("provision_pipeline_k", "wl_batch_deadline_ticks")


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def sim_params(d: dict, device=None) -> SimParams:
    """``SimParams`` from a dict of numpy arrays."""
    dev = resolve_device(device)
    return SimParams(**{
        k: int(np.asarray(v)) if k in _INT_FIELDS else _tensor(v, dev)
        for k, v in d.items()})


def action(d: dict, device=None) -> Action:
    """``Action`` from a dict of numpy arrays."""
    dev = resolve_device(device)
    return Action(**{k: _tensor(v, dev) for k, v in d.items()})


def trace(d: dict, device=None) -> ExogenousTrace:
    """``ExogenousTrace`` from a dict of numpy arrays."""
    dev = resolve_device(device)
    return ExogenousTrace(**{k: _tensor(v, dev) for k, v in d.items()})


_LINEAR = ("actor_mean", "critic")


def actor_critic_from_flax(tree: dict) -> dict:
    """ActorCritic params tree ``{"params": {"Dense_i": {"kernel", "bias"},
    "actor_mean": ..., "critic": ..., "log_std"}}`` -> the state dict of
    `models.nets.ActorCritic`. flax's ``kernel`` is [in, out] and
    ``nn.Linear.weight`` [out, in], so the last two axes swap; a leading
    population axis on every leaf is kept."""
    out = {}
    for name, leaf in tree["params"].items():
        if name == "log_std":
            out[name] = _tensor(leaf, "cpu")
        elif name.startswith("Dense_") or name in _LINEAR:
            out[f"{name}.weight"] = _tensor(
                leaf["kernel"], "cpu").transpose(-1, -2).contiguous()
            out[f"{name}.bias"] = _tensor(leaf["bias"], "cpu")
        else:
            raise ValueError(f"unknown ActorCritic params entry {name!r}")
    return out


def actor_critic_to_flax(state_dict: dict) -> dict:
    """Inverse of :func:`actor_critic_from_flax`: float32 numpy leaves."""
    params: dict = {}
    for key, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32)
        name, _, kind = key.partition(".")
        if not kind:
            params[name] = arr.numpy()
        elif kind == "weight":
            params.setdefault(name, {})["kernel"] = (
                arr.transpose(-1, -2).contiguous().numpy())
        else:
            params.setdefault(name, {})["bias"] = arr.numpy()
    return {"params": params}
