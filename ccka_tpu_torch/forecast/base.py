"""Forecaster protocol: predicted exogenous windows.

The PyTorch form of `ccka_tpu/forecast/base.py`. A forecaster maps an
observed history to a predicted forward window:

    Forecaster.predict(history, horizon) -> ExogenousTrace [..., H, ...]

with any leading batch axes on the history ([T_hist, ...] for one trace,
[N, T_hist, ...] for a fleet), so one call forecasts every cluster's
window, as JAX's ``predict_batch`` does.
"""

from __future__ import annotations

import abc

import torch

from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim.dynamics import clip


def trace_to_matrix(trace: ExogenousTrace) -> torch.Tensor:
    """A trace as one [..., T, D] channel matrix; column order spot (Z),
    od (Z), carbon (Z), demand (C), is_peak (1)."""
    return torch.cat([trace.spot_price_hr, trace.od_price_hr,
                      trace.carbon_g_kwh, trace.demand_pods,
                      trace.is_peak[..., None]], dim=-1)


def matrix_to_trace(m: torch.Tensor, n_zones: int,
                    n_classes: int) -> ExogenousTrace:
    """Inverse of :func:`trace_to_matrix`, with the physical clamps of
    every backend: prices, carbon and demand non-negative, is_peak in
    [0, 1]."""
    z, c = n_zones, n_classes
    m = clip(m, 0.0)
    return ExogenousTrace(
        spot_price_hr=m[..., :z], od_price_hr=m[..., z:2 * z],
        carbon_g_kwh=m[..., 2 * z:3 * z], demand_pods=m[..., 3 * z:3 * z + c],
        is_peak=clip(m[..., 3 * z + c], hi=1.0))


class Forecaster(abc.ABC):
    """Maps an observed history window to a predicted forward window.
    Stateless (a fit happens in closed form inside ``predict``); equal
    and hashed by (type, config), so two same-config instances are one
    forecaster."""

    name: str = "forecaster"

    def _config_key(self) -> tuple:
        """Hashable constructor config; () for stateless backends."""
        return tuple(sorted(self.__dict__.items()))

    def __eq__(self, other) -> bool:
        return (type(self) is type(other)
                and self._config_key() == other._config_key())

    def __hash__(self) -> int:
        return hash((type(self), self._config_key()))

    @abc.abstractmethod
    def predict(self, history: ExogenousTrace,
                horizon: int) -> ExogenousTrace:
        """[..., T_hist, ...] observed history -> [..., H, ...] window."""

    def predict_batch(self, histories: ExogenousTrace,
                      horizon: int) -> ExogenousTrace:
        """[B, T_hist, ...] -> [B, H, ...]: :meth:`predict` on a batch."""
        return self.predict(histories, horizon)

    def wanted_history(self, horizon: int) -> int:
        """How many trailing observed ticks ``predict`` wants."""
        return max(horizon, 8)


def planning_window(forecaster: Forecaster, history: ExogenousTrace,
                    horizon: int) -> ExogenousTrace:
    """The window a receding-horizon planner optimizes against: tick 0 is
    the observed current tick (the history's last), ticks 1..H-1 the
    forecaster's predictions from ticks up to it. Leading batch axes are
    kept."""
    current = history.slice_steps(history.steps - 1, 1)
    if horizon == 1:
        return current
    pred = forecaster.predict(history, horizon - 1)
    return ExogenousTrace(*(
        torch.cat([c, p], dim=-1 if name == "is_peak" else -2)
        for name, c, p in zip(ExogenousTrace._fields, current, pred)))


def make_forecaster(name: str, *, dt_s: float = 30.0,
                    period_s: float = 86400.0) -> Forecaster | None:
    """The backend of a CLI/bench spelling; ``oracle`` (or empty) is None,
    the perfect-foresight reference."""
    from ccka_tpu_torch.forecast.backends import (PersistenceForecaster,
                                                  RidgeARForecaster,
                                                  SeasonalNaiveForecaster)

    key = (name or "oracle").lower().replace("-", "_")
    if key in ("oracle", "none"):
        return None
    if key == "persistence":
        return PersistenceForecaster()
    if key in ("seasonal", "seasonal_naive"):
        return SeasonalNaiveForecaster(
            period_steps=max(1, int(round(period_s / dt_s))))
    if key in ("ridge", "ridge_ar", "learned"):
        return RidgeARForecaster()
    raise ValueError(f"unknown forecaster {name!r} (expected oracle, "
                     "persistence, seasonal-naive, or ridge)")
