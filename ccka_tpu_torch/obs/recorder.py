"""Per-tenant flight recorder: bounded pre-incident state capture.

The PyTorch form of `ccka_tpu/obs/recorder.py` (host-only, the same dump
format and digest). "ratio 1.0 on the scoreboard" says the fleet
survived; it does not say WHAT the loop was doing in the ticks before a
breaker opened. The recorder is the black box: a fixed-size ring buffer per tenant (plus
one for the fleet loop itself) of recent control-surface rows — lane,
breaker level, scrape outcome, apply outcome, latency, burn rates —
appended host-side AFTER each tick's decisions, so recording can never
perturb them (the bitwise non-interference contract
`tests/test_torch_incidents.py` pins with a paired recorder-on/
recorder-off run).

When a trigger fires (`obs/incidents.py`), :meth:`FlightRecorder.dump`
freezes the rings into an atomic, SHA-256-checksummed capture on disk —
the exact write-temp-fsync-rename + canonical-JSON-digest discipline of
`harness/snapshot.py` (whose codec this module reuses rather than
re-implements): a torn or hand-edited dump is refused at load, never
half-trusted. `verify_dump` is the read side; `ccka incidents show`
runs it before displaying a capture.
"""

from __future__ import annotations

import collections
import os
from typing import Mapping

from ccka_tpu_torch.config import ObsConfig

DUMP_KIND = "recorder-dump"

# The fleet-loop ring's key (per-tenant rings use the int tenant index).
FLEET_KEY = "fleet"


class FlightRecorder:
    """Bounded ring buffers of recent control-surface rows.

    ``record(key, row)`` appends one row (a small dict of host scalars
    — never device arrays: the recorder must not force a transfer) to
    ``key``'s ring; rings hold the last ``obs.ring_size`` rows. Rows
    are stored as-is; :meth:`dump` is the only serialization point.
    """

    def __init__(self, obs: ObsConfig):
        self.obs = obs
        self._rings: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=obs.ring_size))
        self.dumps_total = 0
        # One dump per (tick, tenant): several triggers firing on the
        # same tick for the same tenant capture the SAME ring state, so
        # they share one file (the incident records all reference it) —
        # a breaker open + give-up + lane escalation in one bad tick
        # must not triple the dump I/O on the tick path.
        self._dump_cache: dict = {}
        if obs.dump_dir:
            # Warm the snapshot codec import now: the first incident of
            # a run must not pay an import inside a deadline-bounded
            # tick.
            import ccka_tpu_torch.harness.snapshot  # noqa: F401

    def record(self, key, row: Mapping) -> None:
        self._rings[key].append(dict(row))

    def ring(self, key) -> list[dict]:
        return list(self._rings.get(key, ()))

    # -- dump / verify -------------------------------------------------------

    def dump_body(self, *, trigger: str, t: int, tenant,
                  context: Mapping | None = None) -> dict:
        """The capture body: the triggering tenant's ring, the fleet
        ring, and any extra context the trigger site attaches."""
        rings = {FLEET_KEY: self.ring(FLEET_KEY)}
        if tenant is not None:
            rings[str(tenant)] = self.ring(tenant)
        return {
            "kind": DUMP_KIND,
            "trigger": trigger,
            "t": int(t),
            "tenant": (int(tenant) if isinstance(tenant, int)
                       else tenant),
            "ring_size": int(self.obs.ring_size),
            "rings": rings,
            **({"context": dict(context)} if context else {}),
        }

    def dump(self, *, trigger: str, t: int, tenant=None,
             incident_id: int = 0,
             context: Mapping | None = None) -> tuple[str, str] | None:
        """Freeze the rings into an atomic checksummed capture under
        ``obs.dump_dir``; returns ``(path, sha256)`` or None when
        dumping is disabled (no dump_dir). Reuses the snapshot codec:
        the file IS a `harness/snapshot.py` document (format-versioned,
        canonical-JSON SHA-256), so `verify_dump` inherits its refusal
        of torn/corrupt files. Triggers sharing a (tick, tenant) share
        one capture (identical ring state; see ``_dump_cache``) — the
        first trigger names the file, later ones reference it."""
        if not self.obs.dump_dir:
            return None
        cache_key = (int(t), tenant)
        hit = self._dump_cache.get(cache_key)
        if hit is not None:
            return hit
        from ccka_tpu_torch.harness.snapshot import save_snapshot_with_digest

        body = self.dump_body(trigger=trigger, t=t, tenant=tenant,
                              context=context)
        name = (f"incident-{incident_id:05d}-t{int(t):06d}-"
                f"{trigger}.json")
        out = save_snapshot_with_digest(
            os.path.join(self.obs.dump_dir, name), body)
        self.dumps_total += 1
        # Bounded: only the CURRENT tick's captures can repeat, so one
        # tick of memory is enough (keyed entries from older ticks are
        # dead — drop them instead of growing forever).
        self._dump_cache = {k: v for k, v in self._dump_cache.items()
                            if k[0] == int(t)}
        self._dump_cache[cache_key] = out
        return out


def verify_dump(path: str) -> dict:
    """Load + checksum-verify a recorder dump; returns the body.
    Raises `harness.snapshot.SnapshotError` on any integrity problem
    and on a snapshot that is not a recorder dump (a controller
    snapshot handed to `ccka incidents show` must be refused, not
    rendered as a garbage timeline)."""
    from ccka_tpu_torch.harness.snapshot import SnapshotError, load_snapshot

    body = load_snapshot(path)
    if body.get("kind") != DUMP_KIND:
        raise SnapshotError(
            f"{path!r} is a {body.get('kind')!r} snapshot, not a "
            f"{DUMP_KIND} capture")
    return body
