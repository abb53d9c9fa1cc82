"""The device mesh and the placement of a cluster batch on it.

The PyTorch form of `ccka_tpu/parallel/mesh.py`. One process drives every
device, as JAX's mesh does: a :class:`Mesh` is a ``[data, model]`` grid
of `torch.device`s, and the sharded entries loop over its data shards in
shard order, each shard's work on its row's device.

- ``data`` axis: the cluster batch. :func:`shard_batch` splits axis 0 of
  every leaf of a tree into equal contiguous parts, part ``i`` on data row
  ``i``'s first device, and returns a :class:`Sharded` that keeps each
  part's global offset. Results come back the same way: distributed;
  :func:`gather` is the explicit call that puts them on one device.
- ``model`` axis: :func:`shard_params` splits a Dense kernel over output
  columns, piece ``j`` on column ``j`` of the grid (:class:`ColumnSharded`);
  a product with it computes each device's ``x @ W[:, cols_j]`` and
  concatenates (`train/ppo.py`'s sharded iteration).
- :func:`replicate` places a tree on every device of the mesh
  (:class:`Replicated`, one copy per distinct device).

A device list may repeat a device, the counterpart of XLA's virtual host
devices: the CPU tests build ``[cpu] * 8``, a card ``[cuda:0] * 4``.
Without a list, :func:`make_mesh` takes every CUDA device
(`torch.cuda.device_count()`), or the CPU when the caller asks for it.
Cross-shard reductions are fixed-order sums in this one process; there is
no process group (NCCL cannot put two ranks on one card).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ccka_tpu_torch.config import ConfigError, MeshConfig


class Mesh:
    """A ``[data, model]`` grid of torch devices with JAX's ``axis_names``
    and ``shape`` (axis name -> size)."""

    def __init__(self, devices, axis_names=("data", "model")):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(devices[idx[0]][idx[1]])
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def data_devices(self) -> list:
        """Each data shard's device: the first of its grid row."""
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())


def make_mesh(cfg: MeshConfig | None = None, devices: list | None = None,
              *, device=None) -> Mesh:
    """Build a ``(data, model)`` mesh from the config's axis sizes.

    ``data_parallel == -1`` (the default) means "all devices divided by
    ``model_parallel``". ``devices`` defaults to every CUDA device, or to
    the one device ``device`` names when it is not CUDA (``"cpu"``)."""
    from ccka_tpu_torch import resolve_device

    cfg = cfg or MeshConfig()
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    mp = cfg.model_parallel
    dp = cfg.data_parallel
    if dp == -1:
        if n % mp:
            raise ConfigError(
                f"mesh: {n} devices not divisible by model_parallel={mp}")
        dp = n // mp
    if dp * mp > n:
        raise ConfigError(
            f"mesh: requested {dp}x{mp} mesh exceeds {n} devices")
    grid = [devices[i * mp:(i + 1) * mp] for i in range(dp)]
    return Mesh(grid, (cfg.data_axis, cfg.model_axis))


class PartitionSpec(tuple):
    """Which mesh axis splits each array axis (None: not split), as
    `jax.sharding.PartitionSpec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


class NamedSharding(NamedTuple):
    """A layout descriptor: ``spec`` over ``mesh``."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None for a in self.spec)


def batch_spec(mesh: Mesh, ndim: int) -> PartitionSpec:
    """The layout splitting the leading (batch) axis over ``data``."""
    return PartitionSpec(mesh.axis_names[0], *([None] * (ndim - 1)))


def batch_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """The layout of an array whose axis 0 is the cluster batch."""
    return NamedSharding(mesh, batch_spec(mesh, ndim))


# ---- trees --------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, lists, tuples and
    NamedTuples (None and other leaves handed to ``fn`` as they are)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(lambda x: out.append(x), tree)
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class Sharded:
    """A tree split on one axis over the mesh's data shards: ``parts[i]``
    (a tree like the whole, on ``devices[i]``) holds the global indices
    ``offsets[i]`` .. ``offsets[i] + sizes[i] - 1`` of the split axis
    ``axis``."""

    def __init__(self, parts, offsets, mesh: Mesh, axis: int = 0):
        self.parts = list(parts)
        self.offsets = [int(o) for o in offsets]
        self.mesh = mesh
        self.axis = int(axis)

    @property
    def devices(self) -> list:
        return self.mesh.data_devices()

    @property
    def sizes(self) -> list:
        return [int(tree_leaves(p)[0].shape[self.axis]) for p in self.parts]

    @property
    def size(self) -> int:
        return sum(self.sizes)

    @property
    def sharding(self) -> NamedSharding:
        ndim = tree_leaves(self.parts[0])[0].dim()
        axis = self.axis % ndim
        spec = [None] * ndim
        spec[axis] = self.mesh.axis_names[0]
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    def map(self, fn) -> "Sharded":
        """``fn(part)`` on every part, offsets kept."""
        return Sharded([fn(p) for p in self.parts], self.offsets, self.mesh,
                       self.axis)

    def gather(self, device=None):
        """The whole tree on one device (default: shard 0's)."""
        dev = torch.device(device) if device is not None else self.devices[0]
        return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs],
                                              dim=self.axis), *self.parts)


def data_shards(mesh: Mesh) -> int:
    """Size of the batch-splitting axis (mesh axis 0, ``data``)."""
    return int(mesh.shape[mesh.axis_names[0]])


def split_parts(mesh: Mesh, tree, axis: int = 0) -> Sharded:
    """:func:`shard_batch` without its checks: every leaf's ``axis``
    split into equal parts (views where a part's device is the leaf's)."""
    n = data_shards(mesh)
    size = int(_as_tensor(tree_leaves(tree)[0]).shape[axis])
    b = size // n
    devs = mesh.data_devices()
    parts = [tree_map(lambda x, i=i: _as_tensor(x).narrow(
        axis, i * b, b).to(devs[i]), tree) for i in range(n)]
    return Sharded(parts, [i * b for i in range(n)], mesh, axis)


def shard_batch(mesh: Mesh, tree: Any, axis: int = 0) -> Sharded:
    """Place a tree on the mesh, axis 0 (or ``axis``) of every leaf split
    over ``data``: the device placement of cluster-batched states, traces
    and streams. The split axis must divide by the data-axis size (batch
    sizes here are powers of two: no padding path)."""
    if isinstance(tree, Sharded):
        return tree
    size = data_shards(mesh)
    for x in tree_leaves(tree):
        x = _as_tensor(x)
        if x.dim() == 0 or x.shape[axis] % size:
            raise ConfigError(
                f"shard_batch: leading dim {tuple(x.shape[:1])} not "
                f"divisible by data axis size {size}")
    return split_parts(mesh, tree, axis)


class Replicated:
    """A tree placed on every device of a mesh: one copy per distinct
    device (a repeated device shares its copy). Leaves that are not
    tensors (numbers, numpy arrays) are shared as they are."""

    def __init__(self, mesh: Mesh, tree):
        self.mesh = mesh
        self.copies: dict = {}
        for d in mesh.devices.flat:
            if str(d) not in self.copies:
                self.copies[str(d)] = tree_map(
                    lambda x, d=d: x.to(d) if isinstance(x, torch.Tensor)
                    else x, tree)

    @property
    def value(self):
        return self.copies[str(self.mesh.devices.flat[0])]

    def on(self, device):
        """The copy on ``device`` (a mesh device)."""
        return self.copies[str(torch.device(device))]

    def devices(self) -> list:
        return list(self.mesh.devices.flat)

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, PartitionSpec())


def replicate(mesh: Mesh, tree: Any) -> Replicated:
    """Replicate a tree across every mesh device (params, SimParams)."""
    if isinstance(tree, Replicated):
        return tree
    return Replicated(mesh, gather(tree))


class ColumnSharded:
    """A 2-D kernel split over the ``model`` axis by output features:
    ``pieces[j]`` (the columns ``cols[j]`` of dim ``dim``) on grid column
    ``j`` of data row 0; :meth:`on` places a piece on another row."""

    def __init__(self, mesh: Mesh, x: torch.Tensor, dim: int):
        mp = mesh.devices.shape[1]
        self.mesh, self.dim = mesh, dim
        w = x.shape[dim] // mp
        self.cols = [(j * w, (j + 1) * w) for j in range(mp)]
        self.pieces = [x.narrow(dim, lo, hi - lo).to(mesh.devices[0, j])
                       .contiguous() for j, (lo, hi) in enumerate(self.cols)]

    def on(self, i: int, j: int) -> torch.Tensor:
        return self.pieces[j].to(self.mesh.devices[i, j])

    def gather(self, device=None) -> torch.Tensor:
        dev = torch.device(device) if device is not None else \
            self.mesh.devices[0, 0]
        return torch.cat([p.to(dev) for p in self.pieces], dim=self.dim)

    @property
    def sharding(self) -> NamedSharding:
        spec = [None, None]
        spec[self.dim] = self.mesh.axis_names[-1]
        return NamedSharding(self.mesh, PartitionSpec(*spec))


def _out_dim(name: str) -> int:
    """The output-feature axis of a 2-D parameter: 0 for a torch Linear
    weight (``*.weight``, [out, in]), 1 for a flax kernel ([in, out])."""
    return 0 if name.endswith("weight") else 1


def shard_params(mesh: Mesh, params: dict) -> dict:
    """Shard Dense kernels over the ``model`` axis by output features.

    Tensor parallelism for the policy net: a 2-D kernel whose output
    dimension divides by the model-axis size is split
    (:class:`ColumnSharded`); everything else (biases, ``log_std``, heads
    with indivisible widths) replicates. With ``model_parallel == 1``
    this is :func:`replicate` leaf by leaf. ``params`` is a flat dict
    (a torch state dict, or the flax layout's nested dicts)."""
    size = mesh.shape[mesh.axis_names[-1]]

    def place(name: str, x):
        x = gather(x)
        dim = _out_dim(name)
        if x.dim() == 2 and size > 1 and x.shape[dim] % size == 0:
            return ColumnSharded(mesh, x, dim)
        return Replicated(mesh, x)

    def walk(tree, prefix=""):
        return {k: (walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                    else place(f"{prefix}{k}", v)) for k, v in tree.items()}

    return walk(params)


def gather(x, device=None):
    """A sharded, replicated or column-split value (or a tree of them) as
    plain tensors on one device; plain tensors pass through (moved when
    ``device`` is given)."""
    if isinstance(x, (Sharded, ColumnSharded)):
        return x.gather(device)
    if isinstance(x, Replicated):
        v = x.value
        return v if device is None else tree_map(lambda t: t.to(device), v)
    if isinstance(x, dict):
        return {k: gather(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(gather(v, device) for v in x))
    if isinstance(x, list):
        return [gather(v, device) for v in x]
    if isinstance(x, torch.Tensor) and device is not None:
        return x.to(device)
    return x
