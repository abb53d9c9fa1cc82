"""Multi-window SLO burn-rate engine.

The PyTorch port's copy of `ccka_tpu/obs/burnrate.py`, host-side
arithmetic only: a FAST window that catches a new fire within a few
ticks, ANDed with a SLOW window that stops a single bad tick from
flapping the alert. Both windows above the threshold = the budget is
burning, exported as `ccka_slo_burn_rate` / `ccka_incident_active` next
to the KPIs they explain (`harness/promexport.py`).

Pure host-side arithmetic on O(window) deques: nothing here touches
device state, and the whole engine rides AFTER the service tick's
decisions (the bitwise non-interference contract of
`harness/service.py`).
"""

from __future__ import annotations

import collections


class BurnWindow:
    """One trailing window: (bad, total) pairs over the last N ticks."""

    __slots__ = ("_events",)

    def __init__(self, ticks: int):
        if ticks < 1:
            raise ValueError("burn window must cover >= 1 tick")
        self._events: collections.deque = collections.deque(maxlen=ticks)

    def update(self, bad: float, total: float) -> None:
        self._events.append((float(bad), float(total)))

    @property
    def rate(self) -> float:
        """Fraction of the window's budget burned: sum(bad)/sum(total)
        (0.0 before the first update — an empty window is not on fire)."""
        if not self._events:
            return 0.0
        bad = sum(b for b, _t in self._events)
        total = sum(t for _b, t in self._events)
        return bad / max(total, 1e-12)


class BurnRate:
    """Fast+slow windows over one counter series.

    ``update(bad, total)`` once per tick with the tick's violating
    count (e.g. tenants failing the SLO gate) and its denominator
    (fleet size). ``burning`` is the two-window AND: the fast window
    says a fire started, the slow window says it is not a blip.
    """

    def __init__(self, fast_ticks: int, slow_ticks: int,
                 threshold: float = 0.5):
        if fast_ticks > slow_ticks:
            raise ValueError("fast window must not exceed slow window")
        self.fast = BurnWindow(fast_ticks)
        self.slow = BurnWindow(slow_ticks)
        self.threshold = float(threshold)

    def update(self, bad: float, total: float) -> None:
        self.fast.update(bad, total)
        self.slow.update(bad, total)

    @property
    def fast_rate(self) -> float:
        return self.fast.rate

    @property
    def slow_rate(self) -> float:
        return self.slow.rate

    @property
    def burning(self) -> bool:
        return (self.fast.rate > self.threshold
                and self.slow.rate > self.threshold)


class BurnRateEngine:
    """Named burn-rate series sharing one window/threshold posture.

    The service tracks {"slo", "deadline", "shed"} — the three
    per-tenant counter families the round-13 board already emits. The
    exported `ccka_slo_burn_rate` gauge is the "slo" series' fast rate;
    ``any_burning`` feeds `ccka_incident_active` alongside fresh
    incident stamps.
    """

    def __init__(self, fast_ticks: int, slow_ticks: int,
                 threshold: float = 0.5,
                 series: tuple = ("slo", "deadline", "shed")):
        self._series: dict[str, BurnRate] = {
            name: BurnRate(fast_ticks, slow_ticks, threshold)
            for name in series}

    def update(self, name: str, bad: float, total: float) -> None:
        self._series[name].update(bad, total)

    def rate(self, name: str, window: str = "fast") -> float:
        br = self._series[name]
        return br.fast_rate if window == "fast" else br.slow_rate

    @property
    def any_burning(self) -> bool:
        return any(br.burning for br in self._series.values())

    def rates(self) -> dict:
        """All series' fast/slow rates (the recorder-dump payload)."""
        return {name: {"fast": round(br.fast_rate, 6),
                       "slow": round(br.slow_rate, 6),
                       "burning": br.burning}
                for name, br in self._series.items()}
