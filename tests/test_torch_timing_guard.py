"""The timing guard of `tests/test_timing_guard.py`, over the port.

Any function of ``ccka_tpu_torch/`` or of the port's scripts
(``scripts/torch_*.py``) that reads a wall clock
(``time.perf_counter()``, ``time.time()``, ``time.monotonic()``) and
touches torch must also hold a fence in scope: a ``device_fence`` or
``synchronize`` call (or the factory's ``_fenced``, which makes one),
a ``.span(``/``device_span(`` context, or a
``StageTimer`` stage (whose spans fence). Otherwise it times the
enqueue of work on the card, not the work. The port's tracer
(`ccka_tpu_torch/obs/trace.py`) is the one file exempt: it is the
primitive the rule points everyone else at. The rule's AST walk is the
JAX guard's own, imported from it.
"""

from __future__ import annotations

import ast
import os

from test_timing_guard import _enclosing_function, _segment, _timing_calls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ccka_tpu_torch")
SCRIPTS = os.path.join(ROOT, "scripts")
EXEMPT = {os.path.join(PORT, "obs", "trace.py")}
# `train/factory.py::_fenced` synchronizes the device before it reads
# the clock.
_FENCE_MARKERS = ("device_fence", "synchronize", "_fenced(", ".span(",
                  "device_span(", "StageTimer")
_DEVICE_MARKERS = ("torch.",)


def _python_files():
    for dirpath, _dirs, files in os.walk(PORT):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    # The port's twins of the JAX-era scripts.
    for f in sorted(os.listdir(SCRIPTS)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(SCRIPTS, f)


def test_no_unfenced_device_timing_in_the_port():
    violations = []
    for path in _python_files():
        if path in EXEMPT:
            continue
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        tree = ast.parse(src)
        src_lines = src.splitlines(keepends=True)
        seen = set()
        for call in _timing_calls(tree):
            fn = _enclosing_function(tree, call)
            key = fn.lineno if fn else 0
            if key in seen:
                continue
            seen.add(key)
            seg = _segment(src_lines, fn)
            if (any(m in seg for m in _DEVICE_MARKERS)
                    and not any(m in seg for m in _FENCE_MARKERS)):
                violations.append(f"{os.path.relpath(path, ROOT)}:"
                                  f"{call.lineno} in "
                                  f"{fn.name if fn else '<module>'}()")
    assert not violations, (
        "unfenced wall-clock timing next to torch code (time the work "
        "through a span with a fence, or synchronize before reading the "
        "clock):\n  " + "\n  ".join(violations))


def test_guard_scans_the_control_loop():
    files = list(_python_files())
    assert len(files) > 40
    for rel in (("harness", "controller.py"), ("harness", "recovery.py"),
                ("obs", "compile.py"), ("signals", "live.py"),
                ("signals", "transport.py"), ("actuation", "reconcile.py"),
                ("sim", "streaming.py"), ("train", "mpc.py"),
                ("actuation", "guardrails.py"), ("actuation", "bootstrap.py"),
                ("actuation", "burst.py"), ("harness", "preroll.py"),
                ("harness", "watch.py"), ("harness", "dashboard.py"),
                ("harness", "pipeline.py"), ("harness", "fleet.py"),
                ("obs", "decisions.py"), ("obs", "tournament.py"),
                ("obs", "incidents.py"), ("obs", "recorder.py"),
                ("harness", "service.py"), ("harness", "overload.py"),
                ("harness", "fleetscale.py"), ("obs", "burnrate.py"),
                ("regions", "process.py"), ("regions", "migrate.py"),
                ("regions", "geo.py"), ("regions", "pareto.py"),
                ("search", "params.py"), ("search", "axis.py"),
                ("search", "adversarial.py"), ("train", "mining.py"),
                ("train", "flywheel.py"), ("harness", "flywheel.py"),
                ("parallel", "mesh.py"), ("parallel", "sharded.py"),
                ("parallel", "sharded_kernel.py"), ("obs", "occupancy.py"),
                ("cli.py",), ("scripts", "torch_make_replay_trace.py"),
                ("scripts", "torch_zone_spread_probe.py"),
                ("scripts", "torch_train_replay_flagship.py"),
                ("scripts", "torch_train_carbon_frontier.py")):
        assert any(p.endswith(os.path.join(*rel)) for p in files), rel
