"""SignalSource interface and the ExogenousTrace tensor bundle.

The PyTorch form of `ccka_tpu/signals/base.py`: a time-major bundle of
float32 tensors with static shapes. A batch of traces carries its batch
axis in front ([B, T, Z] and so on). A source serves a whole horizon
(``trace``, ``batch_trace``) and the control loop's per-tick views
(``tick``, ``forecast``, ``history``) on the device the caller names.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class ExogenousTrace(NamedTuple):
    """Time-major exogenous inputs to the cluster simulator.

    spot_price_hr [(B,) T, Z], od_price_hr [(B,) T, Z], carbon_g_kwh
    [(B,) T, Z], demand_pods [(B,) T, C], is_peak [(B,) T].
    """

    spot_price_hr: torch.Tensor
    od_price_hr: torch.Tensor
    carbon_g_kwh: torch.Tensor
    demand_pods: torch.Tensor
    is_peak: torch.Tensor

    @property
    def steps(self) -> int:
        return self.spot_price_hr.shape[-2]

    @property
    def n_zones(self) -> int:
        return self.spot_price_hr.shape[-1]

    def slice_steps(self, start: int, length: int) -> "ExogenousTrace":
        return ExogenousTrace(
            spot_price_hr=self.spot_price_hr[..., start:start + length, :],
            od_price_hr=self.od_price_hr[..., start:start + length, :],
            carbon_g_kwh=self.carbon_g_kwh[..., start:start + length, :],
            demand_pods=self.demand_pods[..., start:start + length, :],
            is_peak=self.is_peak[..., start:start + length],
        )

    def to(self, device) -> "ExogenousTrace":
        return ExogenousTrace(*(x.to(device) for x in self))

    def validate_shapes(self) -> None:
        t, z = self.spot_price_hr.shape[-2:]
        checks = {
            "od_price_hr": tuple(self.od_price_hr.shape[-2:]) == (t, z),
            "carbon_g_kwh": tuple(self.carbon_g_kwh.shape[-2:]) == (t, z),
            "demand_pods": self.demand_pods.shape[-2] == t,
            "is_peak": self.is_peak.shape[-1] == t,
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            shapes = {k: tuple(getattr(self, k).shape) for k in self._fields}
            raise ValueError(f"inconsistent trace shapes for {bad}: {shapes}")


@dataclasses.dataclass(frozen=True)
class TraceMeta:
    """Provenance for a trace."""

    source: str  # "synthetic" | "replay" | "live"
    start_unix_s: float
    dt_s: float
    zones: tuple[str, ...]
    description: str = ""


class SignalSource(abc.ABC):
    """Common interface over signal backends: ``batch_trace`` produces a
    whole horizon for a batch of seeds at once, ``trace`` one seed's
    horizon, ``tick`` the latest single-step observation (the control
    loop's 30 s scrape)."""

    @abc.abstractmethod
    def batch_trace(self, steps: int, seeds, device=None) -> ExogenousTrace:
        """[B, T, ...] traces for a batch of seeds."""

    @abc.abstractmethod
    def meta(self) -> TraceMeta:
        """Provenance of what :meth:`batch_trace` returns."""

    def trace(self, steps: int, *, seed: int = 0,
              device=None) -> ExogenousTrace:
        """[T, ...]: ``steps`` ticks of one seed's signals."""
        return ExogenousTrace(*(x[0] for x in self.batch_trace(
            steps, [seed], device=device)))

    def tick(self, t_index: int, *, seed: int = 0,
             device=None) -> ExogenousTrace:
        """A single-step trace at tick ``t_index``."""
        return self.trace(t_index + 1, seed=seed,
                          device=device).slice_steps(t_index, 1)

    def forecast(self, t_index: int, steps: int, *, seed: int = 0,
                 device=None) -> ExogenousTrace:
        """``steps`` ticks of forward-looking signals from ``t_index``,
        what a receding-horizon planner optimizes against: the future
        slice of :meth:`trace` (exact for synthetic and replayed worlds).
        A live source overrides it."""
        return self.trace(t_index + steps, seed=seed,
                          device=device).slice_steps(t_index, steps)

    def history(self, t_index: int, steps: int, *, seed: int = 0,
                device=None) -> ExogenousTrace:
        """The trailing ``steps`` observed ticks ending at ``t_index``
        inclusive, the forecaster's input. Only ticks <= ``t_index`` are
        touched; an early history left-pads by repeating its first tick,
        so the shape stays ``steps``. A live source overrides it."""
        avail = min(steps, t_index + 1)
        tr = self.trace(t_index + 1, seed=seed, device=device).slice_steps(
            t_index + 1 - avail, avail)
        pad = steps - avail
        if not pad:
            return tr

        def lead(x, taxis):
            first = x.narrow(taxis, 0, 1)
            reps = [1] * x.dim()
            reps[taxis] = pad
            return torch.cat([first.repeat(*reps), x], dim=taxis)

        return ExogenousTrace(
            spot_price_hr=lead(tr.spot_price_hr, -2),
            od_price_hr=lead(tr.od_price_hr, -2),
            carbon_g_kwh=lead(tr.carbon_g_kwh, -2),
            demand_pods=lead(tr.demand_pods, -2),
            is_peak=lead(tr.is_peak, -1),
        )

    # The staleness protocol of the degraded-mode path: a source sets this
    # when the sample its latest tick() returned is stale (its scrapes
    # ran out of retries and the tick fell back to priors). The controller
    # reads it after every scrape. Synthetic and replayed worlds are never
    # stale; LiveSignalSource sets it per tick.
    last_scrape_stale = False

    # True only for a source whose device sampler generates traces on the
    # device at any batch (synthetic); replay's samples windows from a
    # finite store.
    supports_device_traces = False

    def slo_snapshot(self) -> dict:
        """Measured app-level SLO metrics (p95, RPS, queue depth) for the
        controller's KPI line; none unless the source scrapes them."""
        return {}


def as_f32(x, device=None) -> torch.Tensor:
    """A float32 tensor on ``device`` (a tensor keeps its device when
    ``device`` is None, anything else lands on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=device if device is not None else "cpu")
