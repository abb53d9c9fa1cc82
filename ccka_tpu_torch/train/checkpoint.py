"""Checkpoints: single-file parameter npz files and training states.

The PyTorch form of `ccka_tpu/train/checkpoint.py`, in numpy and JSON (no
orbax, no pickle). A params tree is a nested dict of arrays; its file holds one
entry per leaf under the '/'-joined path, plus ``__meta__`` (JSON) that
carries the tree's sha256. The digest of a tree is the same in both
packages, so a checkpoint written by either loads and verifies in the
other.

A training state (:func:`save_state`, :func:`load_state`,
:func:`latest_step`) is a directory: the arrays in ``state.npz``, the
structure and the digest in ``meta.json``; ``step=`` names a
``step_<n>`` subdirectory and loading without it resumes the latest.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

# The meta key carrying the params content digest: written by
# save_params_npz and verified by load_params_npz. Checkpoints saved before
# the key existed (the shipped flagship files) carry no digest and load
# unchecked: absence is legacy, mismatch is refusal.
PARAMS_DIGEST_KEY = "params_sha256"


def _flat_params(params: Any, prefix: str = "") -> dict:
    """'/'-joined tree-path key -> host ndarray (the npz layout). A leaf
    is anything that is not a dict, list or tuple; tensors go through
    numpy."""
    if isinstance(params, dict):
        items = [(str(k), v) for k, v in params.items()]
    elif isinstance(params, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(params)]
    else:
        if hasattr(params, "detach"):
            params = params.detach().cpu().numpy()
        return {prefix: np.asarray(params)}
    flat = {}
    for key, value in items:
        flat.update(_flat_params(value, f"{prefix}/{key}" if prefix else key))
    return flat


def params_digest(params: Any) -> str:
    """Content sha256 of a params tree: every leaf's tree path, dtype,
    shape and C-order bytes, in sorted key order. A nested dict and its
    '/'-joined flat layout hash identically, so the digest survives the
    npz round trip."""
    flat = _flat_params(params)
    h = hashlib.sha256()
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def save_params_npz(path: str, params: Any, *,
                    meta: dict | None = None) -> str:
    """Write ``params`` as one npz file; ``meta`` (JSON-serializable) rides
    along under ``__meta__`` and always carries the content digest that
    :func:`load_params_npz` re-verifies. Returns the absolute path."""
    flat = _flat_params(params)
    meta = dict(meta or {})
    meta[PARAMS_DIGEST_KEY] = params_digest(flat)
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    return path


def load_params_npz(path: str) -> tuple[dict, dict]:
    """Inverse of :func:`save_params_npz`: (nested-dict params, meta).

    When the meta carries the digest, the loaded leaves are re-hashed and
    a mismatch refuses the checkpoint (ValueError): a tampered or
    bit-rotted file must not load as a policy. Digest-less files load
    unchecked."""
    with np.load(path) as z:
        meta: dict = {}
        flat: dict = {}
        tree: dict = {}
        for key in z.files:
            if key == "__meta__":
                meta = json.loads(bytes(z[key]).decode())
                continue
            flat[key] = z[key]
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    stored = meta.get(PARAMS_DIGEST_KEY)
    if stored:
        got = params_digest(flat)
        if got != stored:
            raise ValueError(
                f"checkpoint {path!r}: params digest mismatch: meta says "
                f"{stored[:12]}..., the stored arrays hash to {got[:12]}.... "
                "The file was modified after saving; refusing a tampered "
                "checkpoint.")
    return tree, meta


# ---------------------------------------------------------------------------
# Whole training states: step directories of npz plus JSON meta.

_STATE_NPZ, _STATE_META = "state.npz", "meta.json"


def _step_dir(path: str, step: int | None) -> str:
    path = os.path.abspath(path)
    return path if step is None else os.path.join(path, f"step_{step:08d}")


def _encode(node: Any, prefix: str, flat: dict) -> dict:
    """The JSON spec of one state node; its array leaves go into ``flat``
    under '/'-joined paths. Containers: dict, list, tuple and NamedTuple
    (kept as its fields); leaves: tensors, numpy arrays, generators (their
    state bytes) and JSON scalars."""
    def child(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {"namedtuple": type(node).__name__, "fields": {
            f: _encode(v, child(f), flat) for f, v in node._asdict().items()}}
    if isinstance(node, dict):
        return {"dict": {str(k): _encode(v, child(k), flat)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, child(i), flat)
                       for i, v in enumerate(node)]}
    if isinstance(node, torch.Generator):
        flat[prefix] = node.get_state().numpy()
        return {"generator": prefix, "device": str(node.device)}
    if isinstance(node, torch.Tensor):
        flat[prefix] = node.detach().cpu().numpy()
        return {"tensor": prefix}
    if isinstance(node, np.ndarray):
        flat[prefix] = node
        return {"array": prefix}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"save_state: cannot store {type(node).__name__} at "
                    f"{prefix or '<root>'}")


def _decode(spec: dict, flat: dict, target: Any, device) -> Any:
    """Inverse of :func:`_encode`. With a ``target`` of the same shape,
    NamedTuples come back as the target's type and tensors on the target
    tensor's device; without one, NamedTuples come back as dicts and
    tensors on ``device``."""
    if "namedtuple" in spec:
        fields = {f: _decode(s, flat, getattr(target, f, None), device)
                  for f, s in spec["fields"].items()}
        if target is not None and hasattr(target, "_fields"):
            return type(target)(**fields)
        return fields
    if "dict" in spec:
        return {k: _decode(s, flat, target.get(k) if isinstance(
            target, dict) else None, device) for k, s in spec["dict"].items()}
    for kind in ("list", "tuple"):
        if kind in spec:
            items = [_decode(s, flat, target[i] if isinstance(
                target, (list, tuple)) and i < len(target) else None, device)
                for i, s in enumerate(spec[kind])]
            return items if kind == "list" else tuple(items)
    if "generator" in spec:
        g = torch.Generator(device=spec["device"])
        g.set_state(torch.from_numpy(flat[spec["generator"]]))
        return g
    if "tensor" in spec:
        dev = target.device if isinstance(target, torch.Tensor) else device
        return torch.from_numpy(flat[spec["tensor"]]).to(dev)
    if "array" in spec:
        return flat[spec["array"]]
    return spec["value"]


def save_state(path: str, state: Any, *, step: int | None = None) -> str:
    """Save a training state (nested dicts, lists, tuples and NamedTuples
    of tensors, arrays, generators and scalars) as ``state.npz`` plus
    ``meta.json`` in ``path`` (``path/step_<step>`` when ``step`` is
    given). The meta carries the structure and the arrays' content digest,
    which :func:`load_state` verifies. Returns the directory."""
    path = _step_dir(path, step)
    flat: dict = {}
    spec = _encode(state, "", flat)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _STATE_NPZ), **flat)
    meta = {"spec": spec, PARAMS_DIGEST_KEY: params_digest(flat)}
    with open(os.path.join(path, _STATE_META), "w", encoding="utf-8") as fh:
        json.dump(meta, fh)
    return path


def load_state(path: str, *, step: int | None = None, target: Any = None,
               device="cpu") -> Any:
    """Load a state saved by :func:`save_state`; ``step=None`` on a
    directory of steps resumes the latest. A digest mismatch refuses the
    state (ValueError), as :func:`load_params_npz` refuses a params
    file. ``target`` (a state of the same structure) restores
    NamedTuple types and tensor devices."""
    path = _step_dir(path, step)
    if step is None and os.path.isdir(path):
        latest = latest_step(path)
        if latest is not None:
            path = _step_dir(path, latest)
    with open(os.path.join(path, _STATE_META), encoding="utf-8") as fh:
        meta = json.load(fh)
    with np.load(os.path.join(path, _STATE_NPZ)) as z:
        flat = {k: z[k] for k in z.files}
    got = params_digest(flat)
    if got != meta.get(PARAMS_DIGEST_KEY):
        raise ValueError(
            f"state {path!r}: digest mismatch: meta says "
            f"{str(meta.get(PARAMS_DIGEST_KEY))[:12]}..., the stored arrays "
            f"hash to {got[:12]}.... Refusing a modified state.")
    return _decode(meta["spec"], flat, target, device)


def latest_step(path: str) -> int | None:
    """The highest ``step_<n>`` under ``path``, or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])
