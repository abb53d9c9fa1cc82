"""Nested wall-clock spans, with an optional device fence.

The PyTorch form of `ccka_tpu/obs/trace.py`:

- :class:`SpanTracer` — nested spans. A span that measured device work
  takes the work's tensors through ``span.fence(x)``; at the span's exit
  the tracer records an event on each of their devices' current CUDA
  stream and waits for it, so the span covers the work and not its
  enqueue. Tensors on the CPU need no wait: their work is done when the
  call returns.
- Chrome trace-event export (:meth:`SpanTracer.chrome_trace`,
  :meth:`SpanTracer.write_chrome_trace`), loadable in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``; spans nest by
  timestamp within a thread's track.
- JSONL streaming (``jsonl_path=``): one record per completed span,
  flushed as it closes.
- :class:`StageTimer` — the control loop's named-phase accumulator on
  spans (`harness/telemetry.py` re-exports it).

This file is the one place in ``ccka_tpu_torch/`` that times with a bare
``time.perf_counter()`` next to device work: everywhere else the timing
guard (`tests/test_torch_timing_guard.py`) requires a fence or a span.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Iterator, Mapping

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

    __slots__ = ("name", "cat", "t0_s", "dur_s", "depth", "tid", "args",
                 "_fence")

    def __init__(self, name: str, cat: str, t0_s: float, depth: int,
                 tid: int, args: dict):
        self.name = name
        self.cat = cat
        self.t0_s = t0_s          # seconds since the tracer's epoch
        self.dur_s = 0.0
        self.depth = depth
        self.tid = tid
        self.args = args
        self._fence = None

    def fence(self, x) -> None:
        """Wait for the work behind ``x`` (tensors) at span exit."""
        self._fence = x
        self.cat = "device"

    @property
    def dur_ms(self) -> float:
        return self.dur_s * 1e3

    def to_record(self) -> dict:
        return {"name": self.name, "cat": self.cat,
                "ts_us": round(self.t0_s * 1e6, 1),
                "dur_us": round(self.dur_s * 1e6, 1),
                "depth": self.depth, **({"args": self.args}
                                        if self.args else {})}


class SpanTracer:
    """Collects nested spans; each thread nests on its own stack.
    ``jsonl_path`` streams every completed span as it closes;
    ``max_spans`` bounds what is kept in memory (oldest dropped), None
    keeps everything."""

    def __init__(self, jsonl_path: str = "", *,
                 max_spans: int | None = None):
        self._epoch = time.perf_counter()
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=max_spans)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._fh = None
        if jsonl_path:
            parent = os.path.dirname(os.path.abspath(jsonl_path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(jsonl_path, "a", encoding="utf-8")

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "host",
             **args) -> Iterator[Span]:
        """Time a block as a nested span; ``.fence(x)`` on the yielded
        span makes it a fenced device span. Extra keywords land in the
        Chrome trace's ``args``."""
        stack = self._stack()
        sp = Span(name, cat, time.perf_counter() - self._epoch,
                  depth=len(stack), tid=threading.get_ident(),
                  args=dict(args))
        stack.append(sp)
        try:
            yield sp
        finally:
            try:
                if sp._fence is not None:
                    device_fence(sp._fence)
            finally:
                # The record closes even when the fence raises: a broken
                # stack would mis-nest every later span of this thread.
                sp._fence = None
                sp.dur_s = (time.perf_counter() - self._epoch) - sp.t0_s
                stack.pop()
                with self._lock:
                    self._spans.append(sp)
                    if self._fh is not None:
                        self._fh.write(json.dumps(sp.to_record(),
                                                  sort_keys=True) + "\n")
                        self._fh.flush()

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

    # -- export -------------------------------------------------------------

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON: one complete ("ph": "X") event per
        span, microseconds from the tracer's epoch, one track per
        thread."""
        pid = os.getpid()
        events = [{
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": round(sp.t0_s * 1e6, 1),
            "dur": round(sp.dur_s * 1e6, 1),
            "pid": pid, "tid": sp.tid,
            "args": dict(sp.args, depth=sp.depth),
        } for sp in self.spans()]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_trace(), fh)
        return path

    def timings_by_name(self) -> dict[str, float]:
        """Total seconds per span name (re-entry accumulates)."""
        acc: dict[str, float] = {}
        for sp in self.spans():
            acc[sp.name] = acc.get(sp.name, 0.0) + sp.dur_s
        return acc

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "SpanTracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StageTimer:
    """Named-phase wall timing for one control tick, on spans.

    ``stage(name)`` yields the stage's span (re-entering a stage
    accumulates); call ``span.fence(result)`` inside a stage whose work
    runs on the card, or its time is the enqueue's. A shared ``tracer``
    puts the stages in that tracer's Chrome trace.
    """

    def __init__(self, tracer: SpanTracer | None = None, *,
                 prefix: str = ""):
        self.tracer = tracer or SpanTracer()
        self.prefix = prefix
        self._acc: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[Span]:
        try:
            with self.tracer.span(self.prefix + name) as sp:
                yield sp
        finally:
            # Recorded even when the stage raised (the span has closed).
            self._acc[name] = self._acc.get(name, 0.0) + sp.dur_s

    def timings_ms(self) -> dict[str, float]:
        return {k: round(v * 1000.0, 3) for k, v in self._acc.items()}

    @property
    def total_ms(self) -> float:
        return round(sum(self._acc.values()) * 1000.0, 3)


def validate_chrome_trace(doc: Mapping) -> list[str]:
    """Schema check of a Chrome trace-event document; the problems found,
    empty when it is loadable."""
    problems = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i} missing {key!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            problems.append(f"complete event {i} missing 'dur'")
        for key in ("ts", "dur"):
            if key in ev and not isinstance(ev[key], (int, float)):
                problems.append(f"event {i} {key!r} not numeric")
    return problems
