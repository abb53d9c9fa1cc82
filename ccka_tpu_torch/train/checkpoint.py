"""Single-file parameter checkpoints (npz) with a content digest.

The PyTorch form of the npz half of `ccka_tpu/train/checkpoint.py`, in
pure numpy. A params tree is a nested dict of arrays; its file holds one
entry per leaf under the '/'-joined path, plus ``__meta__`` (JSON) that
carries the tree's sha256. The digest of a tree is the same in both
packages, so a checkpoint written by either loads and verifies in the
other.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

import numpy as np

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
