"""Nested wall-clock spans, with an optional device fence.

The PyTorch form of the span half of `ccka_tpu/obs/trace.py`:
:class:`Span` and :class:`SpanTracer` (``span``, ``device_span``,
``spans``, ``timings_by_name``). A span that measured device work takes
the work's tensors through ``span.fence(x)``; at the span's exit the
tracer records an event on each of their devices' current CUDA stream and
waits for it, so the span covers the work and not its enqueue. Tensors on
the CPU need no wait: their work is done when the call returns.

The Chrome export, the JSONL stream and `StageTimer` are not ported yet.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

import torch


def _tensors(x) -> Iterator[torch.Tensor]:
    """The tensors of a tensor, or of a (nested) tuple, list or dict."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def device_fence(x) -> None:
    """Wait until the work queued on the current CUDA stream of every
    device that holds a tensor of ``x`` is done (an event recorded there,
    then waited for)."""
    devices = {t.device for t in _tensors(x) if t.is_cuda}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class Span:
    """One completed (or open) span. ``fence(x)`` makes it a device span:
    the work behind ``x`` is waited for at its exit."""

    __slots__ = ("name", "cat", "t0_s", "dur_s", "depth", "args", "_fence")

    def __init__(self, name: str, cat: str, t0_s: float, depth: int,
                 args: dict):
        self.name = name
        self.cat = cat
        self.t0_s = t0_s          # seconds since the tracer's epoch
        self.dur_s = 0.0
        self.depth = depth
        self.args = args
        self._fence = None

    def fence(self, x) -> None:
        """Wait for the work behind ``x`` (tensors) at span exit."""
        self._fence = x
        self.cat = "device"


class SpanTracer:
    """Collects nested spans; each thread nests on its own stack."""

    def __init__(self):
        self._epoch = time.perf_counter()
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "host",
             **args) -> Iterator[Span]:
        """Time a block as a nested span; ``.fence(x)`` on the yielded
        span makes it a fenced device span."""
        stack = self._stack()
        sp = Span(name, cat, time.perf_counter() - self._epoch,
                  depth=len(stack), args=dict(args))
        stack.append(sp)
        try:
            yield sp
        finally:
            try:
                if sp._fence is not None:
                    device_fence(sp._fence)
            finally:
                sp._fence = None
                sp.dur_s = (time.perf_counter() - self._epoch) - sp.t0_s
                stack.pop()
                with self._lock:
                    self._spans.append(sp)

    @contextlib.contextmanager
    def device_span(self, name: str, **args) -> Iterator[Span]:
        """A span that must fence: its exit raises if nothing was
        attached, so a device span never times an enqueue."""
        with self.span(name, cat="device", **args) as sp:
            yield sp
            if sp._fence is None:
                raise RuntimeError(
                    f"device_span {name!r} closed without a fence — call "
                    "span.fence(result) with the device tensors, or use "
                    "span() for host-only timing")

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def timings_by_name(self) -> dict[str, float]:
        """Total seconds per span name (re-entry accumulates)."""
        acc: dict[str, float] = {}
        for sp in self.spans():
            acc[sp.name] = acc.get(sp.name, 0.0) + sp.dur_s
        return acc
