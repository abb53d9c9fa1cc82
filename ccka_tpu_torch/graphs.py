"""A functional body captured once as a CUDA graph and replayed.

Shared by the planner's segments (`train/mpc.py`) and the fleet tick
(`harness/fleet.py`). The body's inputs live in static tensors that a
caller copies into before each replay; its outputs are the graph's own
tensors, overwritten by the next replay.
"""

from __future__ import annotations

import torch


class Graph:
    """``body()`` captured once as a CUDA graph, replayed on demand. Its
    inputs live in static tensors that callers copy into before a
    replay; the body is functional, so warm-up runs change nothing."""

    def __init__(self, body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                body()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = body()


def static(tup):
    """A static copy of a tuple of tensors (a capture's input slots)."""
    clones = [x.clone() for x in tup]
    return type(tup)(*clones) if hasattr(tup, "_fields") else tuple(clones)


def copy_in(dst, src) -> None:
    """Each tensor of ``src`` copied into its slot of ``dst``."""
    for d, s in zip(dst, src):
        d.copy_(s)
