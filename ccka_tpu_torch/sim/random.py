"""Counter-based random numbers for spot interruptions: Philox4x32-10.

The JAX package draws its in-kernel interruptions from the TPU's own
generator, seeded per (seed, batch block, time chunk), and its lax path
from threefry; neither can be reproduced here. The port defines one stream
of its own, keyed and addressed so that it never depends on how a run is
cut up:

    counter = (global cluster index, global tick, spot row p*Z + z, 0)
    key     = (seed & 0xffffffff, seed >> 32)

One Philox4x32-10 call per (cluster, tick, spot row) gives four 32-bit
words; word 0 is the CDF-inversion uniform and words 1 and 2 are
Box-Muller's u1 and u2 (`sim/dynamics._poisson_small`). A uniform is the
word's top 24 bits plus half a step, ``(w >> 8) * 2^-24 + 2^-25``, so it is
never 0 or 1 (the TPU kernel's `_uniform` convention).

Because the stream is addressed by global coordinates, a batch taken whole
or in blocks, a horizon taken at once or in time chunks, and any policy
scored on the same seed draw the same numbers by construction: runs of two
policies on one seed are paired, and no seed-stride arithmetic is needed
to keep blocked or sharded runs equal to whole ones. The CUDA kernels
(`csrc/rollout_tick.cuh`) compute the same function bit for bit.

Arithmetic is in int64 with 32-bit masks: the 32x32 -> 64-bit products are
split into 16-bit halves so that no intermediate overflows int64.
"""

from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_ROUNDS = 10
_WORDS = 3  # words of each call that the simulator uses


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant ``m``
    and the uint32 values in ``x`` (int64 tensor)."""
    p0 = x * (m & 0xFFFF)                 # < 2^48
    p1 = x * (m >> 16)                    # < 2^48
    t = p0 + ((p1 & 0xFFFF) << 16)        # < 2^49
    return (t >> 32) + (p1 >> 16), t & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 of Random123. ``counter`` is four and ``key`` two
    broadcastable int64 tensors (or ints) holding uint32 values; returns
    the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> tuple[int, int]:
    """The Philox key of a non-negative seed of up to 64 bits."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64), got {seed}")
    return seed & _MASK32, seed >> 32


def to_uniform(word: torch.Tensor) -> torch.Tensor:
    """uint32 word (int64 tensor) -> float32 uniform in (0, 1)."""
    return ((word >> 8).to(torch.float32) * (1.0 / (1 << 24))
            + (0.5 / (1 << 24)))


def uniforms(seed: int, cluster_idx, tick, row) -> torch.Tensor:
    """The three uniforms of each (cluster, tick, spot row): a float32
    tensor [3, *broadcast(cluster_idx, tick, row)], on the device of the
    index tensors. Plain PyTorch: the definition of the stream."""
    k0, k1 = seed_key(seed)
    words = philox4x32((cluster_idx, tick, row, 0), (k0, k1))
    return torch.stack([to_uniform(w) for w in words[:_WORDS]])


def uniform_grid(seed: int, n_clusters: int, tick0: int, n_ticks: int,
                 n_rows: int, device) -> torch.Tensor:
    """[3, n_ticks, n_rows, n_clusters] uniforms of clusters 0..n_clusters-1
    at ticks tick0..tick0+n_ticks-1 and spot rows 0..n_rows-1.

    The wrapper of ``philox_uniform_kernel`` (`csrc/rollout_profiles.cu`),
    which exists to hold the device Philox that the rollout kernel inlines
    bit for bit against :func:`uniforms`; no rollout draws through it. On
    a CUDA device it launches the kernel and counts the launch in
    ``uniform_grid.launches``; on the CPU it is :func:`uniforms`."""
    device = torch.device(device)
    if device.type == "cuda":
        from ccka_tpu_torch.kernels import build

        out = torch.empty((_WORDS, n_ticks, n_rows, n_clusters),
                          dtype=torch.float32, device=device)
        build.launch_philox_uniforms(out, seed, tick0)
        uniform_grid.launches += 1
        return out
    if device.type != "cpu":
        raise ValueError(f"uniform_grid: unsupported device {device}")
    ar = lambda n: torch.arange(n, dtype=torch.int64)  # noqa: E731
    return uniforms(seed, ar(n_clusters)[None, None, :],
                    (tick0 + ar(n_ticks))[:, None, None],
                    ar(n_rows)[None, :, None])


uniform_grid.launches = 0
