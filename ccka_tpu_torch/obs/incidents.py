"""Incident triggers, structured incident records, and the causal timeline.

The PyTorch form of `ccka_tpu/obs/incidents.py` (host-only; the same
records, byte for byte apart from the wall clock).

Before round 14 an operator reconstructing "why did tenant 7 fall back
to the rule profile at tick 132?" had to hand-join RunLog lines,
Prometheus gauges and trace spans. This module makes the join a data
structure:

- :data:`TRIGGERS` — the declared trigger vocabulary. Each name fires
  from exactly one code path (`harness/service.py` for breaker/shed/
  deadline, `harness/controller.py` for the degraded machine,
  `actuation/reconcile.py`'s give-up hook) and stamps exactly ONE
  :class:`Incident` per occurrence — `tests/test_incidents.py` pins
  trigger-count == counter-count under seeded chaos.
- :class:`IncidentLog` — append-only structured records (JSONL with
  per-write flush, the RunLog discipline) plus the in-memory list a
  live service reads. When a :class:`~ccka_tpu_torch.obs.recorder.
  FlightRecorder` is attached, every stamp freezes a checksummed
  pre-incident capture and the record carries its path + digest.
- :func:`build_timeline` — the causal join: incidents, RunLog records
  and trace spans merged on their tick keys into one chronological
  event list (`ccka incidents timeline`).

Host-side only; nothing here imports torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Mapping, Sequence

# Trigger name -> what fires it (the vocabulary `ccka incidents`
# prints; a stamp with an unknown trigger is a programming error and
# is rejected at the stamp site).
TRIGGERS: dict[str, str] = {
    "breaker_open": "a tenant's circuit breaker transitioned to open "
                    "(scrape timeouts/failures or reconcile give-ups "
                    "crossed the failure threshold)",
    "hold_fallback": "a decision lane escalated hold-last-action -> "
                     "rule-fallback (tenant breaker open past "
                     "hold_fallback_after, or the single-cluster "
                     "degraded machine falling back)",
    "reconcile_giveup": "a reconciler exhausted its rounds/deadline "
                        "with pools still diverged from intent",
    "deadline_overshoot": "a service tick ran past its configured "
                          "tick_deadline_ms",
    "shed_spike": "one tick shed at least obs.shed_spike_frac of the "
                  "fleet's decides",
    "policy_divergence": "the decision ledger's windowed shadow-"
                         "disagreement rate (fraction of decides whose "
                         "action departs from the rule shadow by more "
                         "than obs.divergence_threshold over the "
                         "trailing obs.decision_window ticks) crossed "
                         "obs.divergence_spike_rate from below "
                         "(edge-triggered, re-armed below the bar)",
    "challenger_sustained_win": "a tournament roster candidate held its "
                                "windowed win rate at or above "
                                "obs.tournament_win_rate for "
                                "obs.tournament_sustain_ticks "
                                "consecutive ticks against the live "
                                "primary (edge-triggered, re-armed when "
                                "the rate drops below the bar; carries "
                                "the signed promotion audit's evidence)",
}


@dataclasses.dataclass(frozen=True)
class Incident:
    """One structured incident record (the timeline's anchor row)."""

    id: int
    trigger: str
    t: int                       # tick the trigger fired on
    tenant: int | None           # None = fleet/loop-level incident
    time_unix: float
    details: dict = dataclasses.field(default_factory=dict)
    dump_path: str | None = None
    dump_sha256: str | None = None

    def to_record(self) -> dict:
        return dataclasses.asdict(self)


class IncidentLog:
    """Append-only incident records + optional recorder capture.

    ``path`` empty keeps it in-memory (tests, short boards); a path
    appends one JSON object per line, flushed per write, so a crashed
    service leaves every stamped incident on disk. ``recorder`` (a
    FlightRecorder) makes every stamp freeze a dump; None stamps
    dump-less records.
    """

    def __init__(self, path: str = "", *, recorder=None):
        self.path = path or ""
        self.recorder = recorder
        self.incidents: list[Incident] = []
        self._next_id = 1
        self._fh = None
        self.io_errors = 0
        if self.path:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            # Appending to an existing log continues its id sequence:
            # restarting at 1 would collide ids in `ccka incidents
            # show` AND overwrite the previous session's dump files
            # (their names carry the incident id) while the old JSONL
            # records still reference the old checksums. A corrupt
            # prior log is refused with a diagnosable error, not a
            # raw JSON traceback out of a service constructor.
            if os.path.exists(self.path):
                import json as _json

                from ccka_tpu_torch.obs.runlog import read_runlog
                try:
                    prior, stats = read_runlog(self.path,
                                               with_stats=True)
                except _json.JSONDecodeError as e:
                    raise ValueError(
                        f"corrupt incident log {self.path!r}: {e} — "
                        "repair or remove it before appending")
                self._next_id = max(
                    (int(rec.get("id", 0)) for rec in prior),
                    default=0) + 1
                if stats["torn_tail"]:
                    # A crash mid-stamp left a torn final line: TRIM
                    # it before appending, or the first new record
                    # would concatenate onto the partial line (or
                    # strand a malformed line in the interior, which
                    # the reader refuses) and corrupt the log for
                    # every later reader. The torn line may or may not
                    # carry a trailing newline — cut at the start of
                    # the last NON-EMPTY line, not at the last \n.
                    with open(self.path, "rb+") as fh:
                        raw = fh.read()
                        cut = raw.rstrip(b"\n").rfind(b"\n") + 1
                        fh.truncate(cut)
            self._fh = open(self.path, "a", encoding="utf-8")

    def stamp(self, trigger: str, *, t: int, tenant: int | None = None,
              **details) -> Incident:
        """Record one incident; returns it. Unknown triggers are
        rejected — the vocabulary is declared, not emergent."""
        if trigger not in TRIGGERS:
            raise ValueError(f"unknown incident trigger {trigger!r}; "
                             f"declared: {sorted(TRIGGERS)}")
        iid = self._next_id
        self._next_id += 1
        # I/O failures (full disk, unwritable dump dir) degrade the
        # RECORD, never the control loop: the observer must not kill
        # the actuation it observes. Counted, with a one-line note.
        dump_path = dump_sha = None
        if self.recorder is not None:
            try:
                dumped = self.recorder.dump(trigger=trigger, t=t,
                                            tenant=tenant,
                                            incident_id=iid,
                                            context=details)
            except OSError as e:
                dumped = None
                self._note_io_error("recorder dump", e)
            if dumped is not None:
                dump_path, dump_sha = dumped
        inc = Incident(id=iid, trigger=trigger, t=int(t),
                       tenant=(int(tenant) if tenant is not None
                               else None),
                       time_unix=round(time.time(), 3),
                       details=dict(details),
                       dump_path=dump_path, dump_sha256=dump_sha)
        self.incidents.append(inc)
        if self._fh is not None:
            try:
                self._fh.write(json.dumps(inc.to_record(),
                                          sort_keys=True) + "\n")
                self._fh.flush()
            except (OSError, ValueError) as e:
                # ValueError covers write-on-closed-file — same
                # degrade-the-record, never-the-loop posture.
                self._note_io_error("incident append", e)
        return inc

    def _note_io_error(self, what: str, e: Exception) -> None:
        self.io_errors += 1
        if self.io_errors == 1:  # once, not per tick
            import sys
            print(f"# incident-log {what} failed ({e}); further I/O "
                  "errors counted in io_errors, records stay "
                  "in-memory", file=sys.stderr)

    @property
    def total(self) -> int:
        return len(self.incidents)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for inc in self.incidents:
            out[inc.trigger] = out.get(inc.trigger, 0) + 1
        return out

    def last_tick(self) -> int | None:
        return self.incidents[-1].t if self.incidents else None

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_incidents(path: str) -> list[dict]:
    """Load an incident JSONL; the reader is the runlog reader (same
    torn-tail-tolerant discipline — a live service's last stamp may be
    mid-write)."""
    from ccka_tpu_torch.obs.runlog import read_runlog
    return read_runlog(path)


# -- the causal timeline -----------------------------------------------------


def _span_tick(span: Mapping):
    args = span.get("args")
    return args.get("t") if isinstance(args, Mapping) else None


def build_timeline(incidents: Sequence[Mapping], *,
                   runlog: Sequence[Mapping] = (),
                   spans: Sequence[Mapping] = (),
                   around: int | None = None,
                   window: int = 8) -> list[dict]:
    """Join incidents, RunLog records and trace spans into ONE
    chronological event list keyed on tick.

    ``around``/``window`` restrict to ticks in [around-window,
    around+window] (the `ccka incidents timeline --id` view); None
    keeps everything carrying a tick. Sources without a tick key are
    dropped — the join IS the point; un-keyed rows cannot be placed
    causally. Rows sort by (tick, source rank, seq) with incidents
    LAST within their tick: the trigger fires after the state that
    explains it."""
    rank = {"span": 0, "runlog": 1, "incident": 2}
    events: list[tuple] = []

    def keep(t) -> bool:
        if t is None:
            return False
        return around is None or abs(int(t) - int(around)) <= window

    for i, sp in enumerate(spans):
        t = _span_tick(sp)
        if keep(t):
            events.append((int(t), rank["span"], i, {
                "t": int(t), "source": "span",
                "name": sp.get("name"),
                "dur_ms": round(float(sp.get("dur_us", 0.0)) / 1e3, 3),
                **({"args": sp["args"]} if sp.get("args") else {})}))
    for i, rec in enumerate(runlog):
        t = rec.get("t", rec.get("tick"))
        if keep(t):
            events.append((int(t), rank["runlog"], i, {
                "t": int(t), "source": "runlog",
                "event": rec.get("event"),
                **{k: v for k, v in rec.items()
                   if k not in ("t", "tick", "event")}}))
    for i, inc in enumerate(incidents):
        rec = inc.to_record() if isinstance(inc, Incident) else dict(inc)
        t = rec.get("t")
        if keep(t):
            events.append((int(t), rank["incident"], i, {
                "source": "incident", **rec}))
    events.sort(key=lambda e: e[:3])
    return [e[3] for e in events]


def attach_dump_entries(timeline_row: Mapping) -> dict:
    """Expand an incident row with its (verified) recorder-dump ring —
    the `ccka incidents show` payload. Raises SnapshotError on a
    corrupt dump; a missing dump (dump-less posture) passes through."""
    row = dict(timeline_row)
    path = row.get("dump_path")
    if path:
        from ccka_tpu_torch.obs.recorder import verify_dump
        row["dump"] = verify_dump(path)
        row["dump_verified"] = True
    return row
