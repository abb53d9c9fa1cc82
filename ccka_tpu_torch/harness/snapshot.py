"""Durable controller snapshots: versioned, checksummed, atomic.

The PyTorch form of `ccka_tpu/harness/snapshot.py`, the same disk format:

- **versioned**: every snapshot carries ``format``/``version``; a reader
  refuses a format it does not understand instead of mis-decoding it;
- **checksummed**: the body's canonical JSON is SHA-256'd at write time
  and checked at load, so a torn or hand-edited file is refused with a
  :class:`SnapshotError`, never half-restored;
- **atomic**: written to a temporary file in the target directory, then
  renamed over the target, so a crash mid-write leaves the previous
  snapshot in place;
- **leaf-faithful**: tensors round-trip as base64 raw bytes with dtype and
  shape, keyed by the key-path strings the JAX package's ``encode_tree``
  gives its tuples (a NamedTuple field by name, joined by "/"; a bare
  tensor is "."), so the leaves of the two
  packages' bodies can be compared one by one.

The body schema belongs to the writer (`harness/controller.py`,
`harness/fleet.py`, `obs/recorder.py`); this module guarantees integrity
and fidelity.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import tempfile
from typing import Any, Iterator

import numpy as np
import torch

SNAPSHOT_FORMAT = "ccka-snapshot"
SNAPSHOT_VERSION = 1


class SnapshotError(RuntimeError):
    """Unreadable, corrupt, or incompatible snapshot."""


# -- tuples of tensors <-> JSON-safe encoding --------------------------------


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(key path, leaf) pairs in the JAX package's flatten order: a
    NamedTuple's fields by name, recursively; anything else is a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, child in zip(tree._fields, tree):
            yield from _leaves(child, path + (name,))
    else:
        yield "/".join(path) or ".", tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def encode_tree(tree: Any) -> dict:
    """Flatten a (nested) NamedTuple of tensors, or one tensor, to {key
    path: {dtype, shape, b64}}."""
    out: dict[str, dict] = {}
    for key, leaf in _leaves(tree):
        arr = np.array(_host(leaf), order="C")  # keeps 0-d leaves 0-d
        out[key] = {
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
        }
    return out


def decode_array(rec: dict) -> np.ndarray:
    """One encoded leaf as a host array."""
    raw = base64.b64decode(rec["b64"])
    return np.frombuffer(raw, dtype=np.dtype(rec["dtype"])).reshape(
        rec["shape"]).copy()


def decode_like(template: Any, enc: dict) -> Any:
    """Rebuild a tuple shaped like ``template`` from :func:`encode_tree`
    output, each tensor on its template leaf's device. A missing or
    shape-mismatched leaf is a :class:`SnapshotError` (schema drift fails
    loudly instead of restoring a half-right state)."""

    def build(node, path: tuple):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(c, path + (n,))
                                for n, c in zip(node._fields, node)))
        key = "/".join(path) or "."
        rec = enc.get(key)
        if rec is None:
            raise SnapshotError(f"snapshot missing leaf {key!r}")
        arr = decode_array(rec)
        want = tuple(node.shape) if isinstance(node, torch.Tensor) \
            else tuple(np.shape(node))
        if tuple(arr.shape) != want:
            raise SnapshotError(
                f"snapshot leaf {key!r} has shape {tuple(arr.shape)}, "
                f"expected {want}")
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(arr).to(node.device)
        return arr

    return build(template, ())


# -- disk format -------------------------------------------------------------


def _canonical(body: dict) -> str:
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def save_snapshot(path: str, body: dict) -> str:
    """Atomically write ``body`` in its integrity envelope; returns the
    absolute path."""
    return save_snapshot_with_digest(path, body)[0]


def save_snapshot_with_digest(path: str, body: dict) -> tuple[str, str]:
    """:func:`save_snapshot`, also returning the envelope's SHA-256, for a
    writer that records the digest beside a reference to the file (the
    flight recorder's incident records) without serializing the body
    twice."""
    sha = hashlib.sha256(_canonical(body).encode()).hexdigest()
    doc = {
        "format": SNAPSHOT_FORMAT,
        "version": SNAPSHOT_VERSION,
        "sha256": sha,
        "body": body,
    }
    path = os.path.abspath(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".snap.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path, sha


def load_snapshot(path: str) -> dict:
    """Read and verify a snapshot; returns its body. Raises
    :class:`SnapshotError` on any integrity or compatibility problem."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise SnapshotError(f"cannot read snapshot {path!r}: {e}")
    except json.JSONDecodeError as e:
        raise SnapshotError(f"snapshot {path!r} is not valid JSON "
                            f"(torn write?): {e}")
    if not isinstance(doc, dict) or doc.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(f"{path!r} is not a {SNAPSHOT_FORMAT} file")
    if doc.get("version") != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"snapshot {path!r} has version {doc.get('version')!r}; this "
            f"reader understands version {SNAPSHOT_VERSION} only")
    body = doc.get("body")
    want = doc.get("sha256")
    got = hashlib.sha256(_canonical(body).encode()).hexdigest()
    if got != want:
        raise SnapshotError(
            f"snapshot {path!r} failed its checksum (stored {want!r}, "
            f"recomputed {got!r}) — refusing to restore corrupt state")
    return body


def config_digest(cfg) -> str:
    """Identity digest of a FrameworkConfig: a resumed run refuses a
    snapshot taken under another config."""
    return hashlib.sha256(cfg.to_json().encode()).hexdigest()
