"""Forecaster backends: persistence, seasonal-naive, ridge AR-k.

The PyTorch form of `ccka_tpu/forecast/backends.py`, batch-first: every
backend takes histories with any leading axes.

- persistence: hold the last observation;
- seasonal-naive: repeat the value one period (a day) ago;
- ridge AR-k: a per-channel autoregression fit in closed form (normal
  equations, `torch.linalg.solve`) inside ``predict``, for every channel
  of every history at once.
"""

from __future__ import annotations

import torch

from ccka_tpu_torch.forecast.base import (Forecaster, matrix_to_trace,
                                          trace_to_matrix)
from ccka_tpu_torch.signals.base import ExogenousTrace


def _shape_info(history: ExogenousTrace) -> tuple[int, int]:
    return history.n_zones, history.demand_pods.shape[-1]


def _hold(m: torch.Tensor, horizon: int) -> torch.Tensor:
    """The last row of [..., T, D] repeated ``horizon`` times."""
    return m[..., -1:, :].expand(*m.shape[:-2], horizon, m.shape[-1])


class PersistenceForecaster(Forecaster):
    """Last-value hold: x[t+h] = x[t] for every h."""

    name = "persistence"

    def predict(self, history: ExogenousTrace,
                horizon: int) -> ExogenousTrace:
        z, c = _shape_info(history)
        return matrix_to_trace(_hold(trace_to_matrix(history), horizon), z,
                               c)

    def wanted_history(self, horizon: int) -> int:
        return 1


class SeasonalNaiveForecaster(Forecaster):
    """Period-lag repeat: x[t+h] = x[t+h-P], P one period of ticks; a
    history shorter than a period falls back to persistence."""

    name = "seasonal_naive"

    def __init__(self, period_steps: int):
        if period_steps < 1:
            raise ValueError(f"period_steps must be >= 1, "
                             f"got {period_steps}")
        self.period_steps = int(period_steps)

    def _config_key(self) -> tuple:
        return (self.period_steps,)

    def predict(self, history: ExogenousTrace,
                horizon: int) -> ExogenousTrace:
        z, c = _shape_info(history)
        m = trace_to_matrix(history)
        t_hist, p = m.shape[-2], self.period_steps
        if t_hist < p:
            return matrix_to_trace(_hold(m, horizon), z, c)
        idx = t_hist - p + torch.arange(horizon, device=m.device) % p
        return matrix_to_trace(m[..., idx, :], z, c)

    def wanted_history(self, horizon: int) -> int:
        return self.period_steps


def fit_ar_coeffs(y: torch.Tensor, lags: int, ridge: float):
    """Closed-form ridge fit of AR(k) channels on standardized data:
    ``y`` [..., T] -> ``(w [..., k], mu [...], sd [...])``, ``w[j]`` the
    coefficient of lag j+1. Solves (X^T X + ridge * n * I) w = X^T y."""
    t_hist = y.shape[-1]
    if t_hist <= lags:
        raise ValueError(f"AR({lags}) needs more than {lags} observations, "
                         f"got {t_hist}")
    mu = y.mean(dim=-1)
    sd = y.std(dim=-1, correction=0) + 1e-6
    yn = (y - mu[..., None]) / sd[..., None]
    n = t_hist - lags
    dev = y.device
    # Row i predicts yn[lags + i] from column j = lag j + 1.
    idx = ((lags + torch.arange(n, device=dev))[:, None] - 1
           - torch.arange(lags, device=dev)[None, :])
    x = yn[..., idx]                                       # [..., n, k]
    target = yn[..., lags:]                                # [..., n]
    xt = x.transpose(-1, -2)
    a = xt @ x + ridge * n * torch.eye(lags, dtype=y.dtype, device=dev)
    w = torch.linalg.solve(a, (xt @ target[..., None]))[..., 0]
    return w, mu, sd


class RidgeARForecaster(Forecaster):
    """Per-channel ridge AR(k), fit in closed form inside ``predict`` on
    every channel of every history, then forecast recursively."""

    name = "ridge_ar"

    def __init__(self, lags: int = 16, ridge: float = 1e-3):
        if lags < 1:
            raise ValueError(f"lags must be >= 1, got {lags}")
        self.lags = int(lags)
        self.ridge = float(ridge)

    def _config_key(self) -> tuple:
        return (self.lags, self.ridge)

    def predict(self, history: ExogenousTrace,
                horizon: int) -> ExogenousTrace:
        z, c = _shape_info(history)
        y = trace_to_matrix(history).transpose(-1, -2)     # [..., D, T]
        w, mu, sd = fit_ar_coeffs(y, self.lags, self.ridge)
        yn = (y - mu[..., None]) / sd[..., None]
        state = yn[..., -self.lags:].flip(-1)              # lag 1 first
        preds = []
        for _ in range(horizon):
            pred = (w * state).sum(dim=-1)
            preds.append(pred)
            state = torch.cat([pred[..., None], state[..., :-1]], dim=-1)
        out = torch.stack(preds, dim=-1) * sd[..., None] + mu[..., None]
        return matrix_to_trace(out.transpose(-1, -2), z, c)

    def wanted_history(self, horizon: int) -> int:
        return max(8 * self.lags, horizon)
