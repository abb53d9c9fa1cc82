"""Concurrent scrape transport: thread-pool fan-in with per-tenant

The PyTorch port's form of `ccka_tpu/signals/transport.py`: a copy: host code, no tensors.
deadlines (the fleet-scale host loop's real-I/O half).

`harness/service.py` models tenant scrapes on a :class:`VirtualClock`
— deterministic, fast, and the deadline arithmetic is identical to
real time — but a real fleet scrapes N HTTP endpoints, and a
sequential walk over 10^4 sockets cannot fit any tick budget. This
module is the same ``_scrape`` contract (``(ok, timed_out)`` within a
budget) over a real concurrent transport, seeded by the in-process
HTTP round-trip idiom of ``tests/test_http_integration.py``:

- **fan-in, not fan-out-and-wait**: every ready tenant's fetch is
  submitted to one bounded thread pool at once; results are gathered
  until the budget edge and NOT ONE MICROSECOND past it.
- **stragglers abandoned, never awaited**: a fetch that misses the
  deadline is left to its own socket timeout and recorded as a
  timeout; the service defers/breakers it exactly like a virtual
  hung scrape. While a tenant's previous fetch is still hung, a new
  attempt fails fast instead of stacking a second request behind a
  dead endpoint.
- **deterministic tests keep the VirtualClock path**: the service
  only routes through a transport when one is injected.

Clock waits here are socket/pool waits on the REAL monotonic clock by
design — this module holds no device code (no jax anywhere), which is
exactly the condition the AST timing guard
(`tests/test_torch_timing_guard.py`) enforces; it scans this file and finds
no un-fenced clock next to a device marker.
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Sequence

Fetcher = Callable[[], bytes]


class ScrapeFanIn:
    """N per-tenant fetchers behind the FleetService scrape contract.

    ``fetchers[i]`` is a zero-arg callable performing tenant i's
    scrape (raising on failure); each should carry its OWN bounded
    socket timeout so an abandoned straggler eventually frees its
    worker thread. ``clock`` is injectable for tests; the pool is
    bounded (a 10^4-tenant fleet must not spawn 10^4 threads — ready
    tenants queue through the pool inside the same budget)."""

    def __init__(self, fetchers: Sequence[Fetcher], *,
                 workers: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._fetchers = list(fetchers)
        self.n = len(self._fetchers)
        self._clock = clock
        self._pool = ThreadPoolExecutor(
            max_workers=workers or min(32, max(4, self.n)),
            thread_name_prefix="ccka-scrape")
        # tenant -> still-running Future from a previous budget window.
        self._stragglers: dict = {}
        self.completed_total = 0
        self.failed_total = 0
        self.abandoned_total = 0

    # -- the service contract -------------------------------------------

    def scrape(self, i: int, budget_s: float) -> tuple:
        """One tenant within ``budget_s`` → (ok, timed_out); the
        sequential `_scrape` surface (object host loop)."""
        return self.fan_in([i], budget_s)[i]

    def fan_in(self, tenants: Sequence[int], budget_s: float) -> dict:
        """Launch every tenant's fetch concurrently, gather until the
        budget edge; returns {tenant: (ok, timed_out)}. Stragglers are
        abandoned — their futures are never awaited again, only
        checked for doneness if the same tenant comes back."""
        deadline = self._clock() + max(budget_s, 0.0)
        pending: dict = {}
        results: dict = {}
        for i in tenants:
            prev = self._stragglers.pop(i, None)
            if prev is not None and not prev.done():
                # Previous scrape still hung: fail fast, keep tracking.
                self._stragglers[i] = prev
                results[i] = (False, True)
                continue
            pending[self._pool.submit(self._fetchers[i])] = i
        while pending:
            remaining = deadline - self._clock()
            if remaining <= 0.0:
                break
            done, _ = wait(set(pending), timeout=remaining,
                           return_when=FIRST_COMPLETED)
            if not done:
                break
            for fut in done:
                i = pending.pop(fut)
                try:
                    fut.result()
                except Exception:
                    results[i] = (False, False)
                    self.failed_total += 1
                else:
                    results[i] = (True, False)
                    self.completed_total += 1
        for fut, i in pending.items():
            # Abandoned at the budget edge: never awaited past here.
            results[i] = (False, True)
            self._stragglers[i] = fut
            self.abandoned_total += 1
        return results

    def stragglers(self) -> list:
        """Tenants whose last fetch is STILL in flight (hung sockets
        the pool is carrying; drains as their own timeouts fire)."""
        return sorted(i for i, f in self._stragglers.items()
                      if not f.done())

    def close(self) -> None:
        """Release the pool without awaiting stragglers (their own
        socket timeouts unwind the worker threads)."""
        self._pool.shutdown(wait=False, cancel_futures=True)


def http_scrape_fan_in(urls: Sequence[str], *, timeout_s: float = 5.0,
                       workers: int | None = None,
                       clock: Callable[[], float] = time.monotonic,
                       fetch=None) -> ScrapeFanIn:
    """Fan-in over per-tenant metric URLs through the signals-layer
    urllib transport (`signals/live.default_fetch`). ``timeout_s`` is
    each socket's own bound — the straggler drain above."""
    from ccka_tpu_torch.signals.live import default_fetch
    f = fetch or default_fetch(timeout_s)
    return ScrapeFanIn(
        [functools.partial(f, url, {}) for url in urls],
        workers=workers, clock=clock)
