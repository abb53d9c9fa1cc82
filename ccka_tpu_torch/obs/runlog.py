"""Structured run logs for the training drivers.

A copy of `ccka_tpu/obs/runlog.py` (stdlib only), so that the port writes
and reads the same JSONL records without importing the JAX package: one
JSON object per line, flushed per write, append-only, plus the human
stderr line the operator still wants:

    rl = RunLog("runs/flagship.jsonl", kind="flagship", meta={...})
    rl.note("rule baseline: ...")                      # echoed + recorded
    rl.event("eval", _echo="it 100: ...", **record)    # structured record
    rl.close()                                         # "end" event

Schema: line 0 is ``{"event": "start", "kind": ..., "time_unix": ...,
"meta": {...}}``; every later line carries ``event`` plus ``elapsed_s``
since start; a clean exit appends ``{"event": "end", "status": ...}`` —
its ABSENCE flags a crashed or live run.

A RunLog is also a plain callable (``rl("msg")`` == ``rl.note``), so it
drops into every ``log=`` callback the trainers take.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Mapping

# Events that are bookkeeping, not training progress — excluded from the
# per-field numeric summary in summarize_runlog.
_META_EVENTS = ("start", "end", "note")

# The declared event vocabulary, the same set as the JAX package's: event
# names are a schema, not free text, so a record written by either
# package joins the other's timeline. :meth:`RunLog.event` enforces it at
# write time.
RUNLOG_EVENTS = frozenset({
    # RunLog's own bookkeeping schema (start/end envelope + notes).
    "start", "end", "note",
    # Training drivers: flagship/replay-flagship selection evaluations
    # and distill provenance, PPO iterations, CEM generations, the MPC
    # warm-start plan record (`ccka train`).
    "eval", "distill", "iter", "gen", "mpc_plan",
    # RESERVED for mirroring incident records into a RunLog stream —
    # no writer yet: `obs/incidents.py`'s IncidentLog writes its own
    # JSONL (with t/trigger/id keys) directly. Registered up front so
    # the name cannot be claimed by an unrelated schema in the
    # meantime.
    "incident",
    # RESERVED the same way for decision-provenance rows (round 18):
    # `obs/decisions.py`'s DecisionLedger writes its own JSONL (with
    # t/tenant/lane/objective/shadow keys) directly; the name is
    # parked here so a future RunLog mirror cannot fork the schema.
    "decision",
    # Adversarial scenario search (`search/adversarial.py`, ISSUE 19):
    # one record per CEM iteration (population best/mean objective,
    # elite stats) and one per minted worst-case scenario (name,
    # params digest, objective value).
    "search_iter", "search_mint",
    # Continual-learning flywheel (`train/flywheel.py`, round 23): one
    # record per stage of a generation — mined weakness cells, the
    # distilled challenger (curriculum + checkpoint digests), the gate
    # decision, the atomic promotion swap, and the incident-triggered
    # rollback to the parent digest.
    "flywheel_mine", "flywheel_distill", "flywheel_gate",
    "flywheel_promote", "flywheel_rollback",
})


class RunLog:
    """Append-only JSONL run record + optional human echo.

    ``path`` empty/None keeps it echo-only (tests, dry drivers) — every
    method still works, nothing is written. ``echo`` is the stderr-line
    sink (None = stderr print; pass the driver's existing ``log``
    callable to preserve its capture hooks).
    """

    def __init__(self, path: str | None = None, *, kind: str = "run",
                 echo: Callable[[str], None] | None = None,
                 meta: Mapping | None = None):
        self.path = path or ""
        self.kind = kind
        self._echo = echo or (lambda s: print(s, file=sys.stderr,
                                              flush=True))
        self._fh = None
        self._closed = False
        self._t0 = time.perf_counter()
        if self.path:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._write({"event": "start", "kind": kind,
                     "time_unix": round(time.time(), 3),
                     **({"meta": dict(meta)} if meta else {})})

    def _write(self, rec: Mapping) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(dict(rec), sort_keys=True,
                                      default=str) + "\n")
            self._fh.flush()

    def event(self, event: str, _echo: str | None = None, **fields) -> dict:
        """Record one structured event; ``_echo`` additionally prints a
        human line (it is NOT written — the fields are the record).
        ``event`` must come from :data:`RUNLOG_EVENTS` — the timeline
        join treats event names as schema identifiers."""
        if event not in RUNLOG_EVENTS:
            raise ValueError(
                f"unregistered RunLog event {event!r} — add it to "
                "obs.runlog.RUNLOG_EVENTS next to the writer that "
                f"emits it (registered: {sorted(RUNLOG_EVENTS)})")
        rec = {"event": event,
               "elapsed_s": round(time.perf_counter() - self._t0, 3),
               **fields}
        self._write(rec)
        if _echo is not None:
            self._echo(_echo)
        return rec

    def note(self, msg: str) -> None:
        """Free-text progress line: echoed AND recorded (as `note`)."""
        self.event("note", _echo=msg, msg=msg)

    def __call__(self, msg: str) -> None:  # drop-in for log= callbacks
        self.note(str(msg))

    def close(self, status: str = "ok", **fields) -> None:
        if self._closed:
            return
        self._closed = True
        self.event("end", status=status, **fields)
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.close(status="error", error=repr(exc)[:200])


def read_runlog(path: str, *, strict: bool = False,
                with_stats: bool = False):
    """Load a run log; returns the records (or ``(records, stats)``
    with ``with_stats=True``).

    Non-strict (default) tolerates exactly ONE malformation: a torn/
    truncated FINAL line — what a crash (or a live writer) mid-write
    leaves behind. The intact prefix is returned and the torn tail is
    COUNTED (``stats["torn_tail"]``), never silently swallowed: before
    round 14 every malformed line anywhere in the file was skipped
    without a trace, so mid-file corruption mis-parsed into a
    plausible-looking shorter log. Now an interior malformed line
    raises even non-strict (corruption must fail loudly); only the
    final line may be torn. ``strict=True`` raises on any malformed
    line, the telemetry reader's discipline."""
    raw: list[tuple[int, str]] = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if line:
                raw.append((lineno, line))
    out: list[dict] = []
    stats = {"torn_tail": 0}
    for i, (lineno, line) in enumerate(raw):
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if strict:
                raise
            if i == len(raw) - 1:
                # The expected crash/live artifact: count it, keep the
                # intact prefix.
                stats["torn_tail"] = 1
                break
            raise json.JSONDecodeError(
                f"malformed run-log line {lineno} of {path!r} (not the "
                "final line, so this is file corruption, not a "
                f"mid-write tear): {e.msg}", e.doc, e.pos)
    if with_stats:
        return out, stats
    return out


def summarize_runlog(records: list[dict]) -> dict:
    """Reduce a run log to a scoreboard: event counts, completion status
    (a missing "end" event means crashed-or-live), and first/last/min/max
    per numeric field over the progress events."""
    if not records:
        return {"events": 0}
    start = next((r for r in records if r.get("event") == "start"), {})
    end = next((r for r in reversed(records)
                if r.get("event") == "end"), None)
    counts: dict[str, int] = {}
    fields: dict[str, dict] = {}
    for r in records:
        ev = str(r.get("event", "?"))
        counts[ev] = counts.get(ev, 0) + 1
        if ev in _META_EVENTS:
            continue
        for k, v in r.items():
            if k in ("event", "elapsed_s") or isinstance(v, bool) \
                    or not isinstance(v, (int, float)):
                continue
            f = fields.setdefault(k, {"first": v, "last": v,
                                      "min": v, "max": v, "n": 0})
            f["last"] = v
            f["min"] = min(f["min"], v)
            f["max"] = max(f["max"], v)
            f["n"] += 1
    return {
        "kind": start.get("kind"),
        "events": len(records),
        "counts": dict(sorted(counts.items())),
        "completed": end is not None,
        "status": (end.get("status") if end
                   else "unterminated (crashed or still running)"),
        "elapsed_s": records[-1].get("elapsed_s"),
        "fields": {k: {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                       for kk, vv in v.items()}
                   for k, v in sorted(fields.items())},
    }
