"""Call and CUDA-graph capture accounting for hot entry points.

The PyTorch form of `ccka_tpu/obs/compile.py`. The port compiles nothing
at run time the way XLA does; what it builds on the way is a CUDA graph
(the planner's segment and replan graphs, `train/mpc.py`). So this module
counts, per watched entry point, its calls and the graph captures they
made:

    replan = watch_jit(plan_graphs, "mpc.replan", hot=True)

:class:`CompileStats` keeps the JAX package's field names: ``compiles``
counts captures and ``compile_s`` the wall of the calls that captured
(their first replay included); ``cache_hits`` and ``execute_s`` the
calls that replayed or ran eagerly. A wrapped callable reports its
captures through an integer ``captures`` attribute; one without it (an
eager step) is counted by calls alone, its ``compiles`` staying 0.

A ``hot=True`` entry that captures beyond its warm-up budget warns
(stderr by default) and counts the capture in ``recompiles``: a graph
re-captured mid-run means a shape or a captured input changed under a
hot path, which is a bug, not a cost.

``execute_s`` is host time in the call: for work on the card that is
its enqueue, unless the call waited. Device time belongs to fenced spans
(`obs/trace.py`).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable

_REGISTRY: dict[str, "CompileStats"] = {}
_LOCK = threading.Lock()


@dataclasses.dataclass
class CompileStats:
    """Counters of one watched entry point."""

    name: str
    calls: int = 0
    compiles: int = 0          # CUDA-graph captures
    cache_hits: int = 0        # calls that captured nothing
    compile_s: float = 0.0     # wall of capturing calls
    execute_s: float = 0.0     # wall of the other calls (host time)
    last_compile_call: int = 0  # 1-based call index of the latest capture
    recompiles: int = 0        # captures of a hot entry past its warm-up

    def to_dict(self) -> dict:
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in dataclasses.asdict(self).items()}


class WatchedJit:
    """Callable wrapper counting calls and captures; see the module
    docstring. Unknown attributes delegate to the wrapped callable."""

    def __init__(self, fn: Callable, name: str, *, hot: bool = False,
                 warmup_compiles: int = 1,
                 warn: Callable[[str], None] | None = None,
                 shared_stats: bool = False):
        self._fn = fn
        self.hot = hot
        self.warmup_compiles = warmup_compiles
        self._warn = warn or (lambda msg: print(msg, file=sys.stderr))
        with _LOCK:
            if shared_stats and name in _REGISTRY:
                # One name for an entry built again per geometry or per
                # owner: the counters accumulate instead of resetting.
                self.stats = _REGISTRY[name]
            else:
                self.stats = CompileStats(name)
                _REGISTRY[name] = self.stats
        # The warm-up budget is this wrapped callable's own: with shared
        # stats, the name's total may legitimately exceed it.
        self._own_compiles = 0

    def _captures(self) -> int | None:
        n = getattr(self._fn, "captures", None)
        return n if isinstance(n, int) else None

    def __call__(self, *args, **kwargs):
        before = self._captures()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        after = self._captures()
        s = self.stats
        with _LOCK:
            s.calls += 1
            captured = (0 if before is None or after is None
                        else after - before)
            if captured > 0:
                s.compiles += captured
                s.compile_s += dt
                s.last_compile_call = s.calls
                self._own_compiles += captured
                late = (self._own_compiles - self.warmup_compiles
                        if self.hot else 0)
                if late > 0:
                    s.recompiles += min(late, captured)
            else:
                s.cache_hits += 1
                s.execute_s += dt
        if captured > 0 and self.hot \
                and self._own_compiles > self.warmup_compiles:
            self._warn(
                f"# [obs] hot path {s.name!r} RECAPTURED at call "
                f"{s.calls} (capture #{s.compiles}, {dt:.2f}s): a shape "
                "or a captured input changed under a hot path mid-run")
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


def watch_jit(fn: Callable, name: str, *, hot: bool = False,
              warmup_compiles: int = 1,
              warn: Callable[[str], None] | None = None,
              shared_stats: bool = False) -> WatchedJit:
    """Wrap ``fn`` with call and capture counters, registered under
    ``name``. Re-registration replaces the entry unless ``shared_stats``,
    which accumulates into the name's existing counters instead."""
    return WatchedJit(fn, name, hot=hot, warmup_compiles=warmup_compiles,
                      warn=warn, shared_stats=shared_stats)


def stats_for(name: str) -> CompileStats | None:
    with _LOCK:
        return _REGISTRY.get(name)


def compile_report() -> dict[str, dict]:
    """Every watched entry point's counters."""
    with _LOCK:
        return {name: s.to_dict() for name, s in sorted(_REGISTRY.items())}
