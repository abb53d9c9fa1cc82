"""Forecast-error metrics: per-channel MAPE and RMSE along the horizon.

The PyTorch form of `ccka_tpu/forecast/metrics.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ccka_tpu_torch.forecast.base import Forecaster
from ccka_tpu_torch.signals.base import ExogenousTrace

_EPS = 1e-6


def _nhk(x: torch.Tensor) -> torch.Tensor:
    """[N, H, K] view of a field ([N, H] is_peak gains K = 1)."""
    return x[..., None] if x.dim() == 2 else x


def forecast_errors(pred: ExogenousTrace, actual: ExogenousTrace) -> dict:
    """Horizon-resolved errors over [N, H, ...] windows: ``{field: {"rmse":
    [H], "mape": [H]}}`` averaged over windows and channels, and their
    horizon means under ``overall``."""
    out: dict = {}
    for field in ExogenousTrace._fields:
        p = _nhk(getattr(pred, field))
        a = _nhk(getattr(actual, field))
        err = p - a
        rmse = torch.sqrt(torch.mean(err ** 2, dim=(0, 2)))
        mape = torch.mean(err.abs() / (a.abs() + _EPS), dim=(0, 2))
        out[field] = {"rmse": rmse.cpu().numpy().tolist(),
                      "mape": mape.cpu().numpy().tolist()}
    fields = list(out.values())
    out["overall"] = {
        "mape_mean": float(np.mean([np.mean(v["mape"]) for v in fields])),
        "rmse_mean": float(np.mean([np.mean(v["rmse"]) for v in fields])),
    }
    return out


def gather_windows(trace: ExogenousTrace, anchors, history_steps: int,
                   horizon: int) -> tuple[ExogenousTrace, ExogenousTrace]:
    """(histories [N, T_hist, ...], futures [N, H, ...]) of a [T, ...]
    trace at ``anchors``: the history ends at the anchor, the future
    covers the H ticks after it; both must lie inside the trace."""
    dev = trace.is_peak.device
    anchors = torch.as_tensor(np.asarray(anchors), dtype=torch.int64,
                              device=dev)
    steps = trace.steps
    lo = int(anchors.min()) if anchors.numel() else history_steps - 1
    hi = int(anchors.max()) if anchors.numel() else 0
    if lo < history_steps - 1 or hi + horizon >= steps:
        raise ValueError(
            f"anchors must lie in [{history_steps - 1}, "
            f"{steps - horizon - 1}] for history={history_steps} "
            f"horizon={horizon} on a {steps}-step trace")
    hist_idx = anchors[:, None] + torch.arange(1 - history_steps, 1,
                                               device=dev)[None, :]
    fut_idx = anchors[:, None] + 1 + torch.arange(horizon,
                                                  device=dev)[None, :]
    return (ExogenousTrace(*(x[hist_idx] for x in trace)),
            ExogenousTrace(*(x[fut_idx] for x in trace)))


def evaluate_forecaster(forecaster: Forecaster, trace: ExogenousTrace, *,
                        horizon: int, history_steps: int | None = None,
                        stride: int = 32) -> dict:
    """A forecaster over every ``stride``-th valid window of a [T, ...]
    trace in one batched predict: :func:`forecast_errors` and the
    sweep's geometry."""
    hist = (forecaster.wanted_history(horizon)
            if history_steps is None else history_steps)
    first, last = hist - 1, trace.steps - horizon - 1
    if last < first:
        raise ValueError(f"trace of {trace.steps} steps too short for "
                         f"history={hist} + horizon={horizon}")
    anchors = np.arange(first, last + 1, max(stride, 1))
    histories, futures = gather_windows(trace, anchors, hist, horizon)
    out = forecast_errors(forecaster.predict_batch(histories, horizon),
                          futures)
    out["forecaster"] = forecaster.name
    out["horizon"] = int(horizon)
    out["history_steps"] = int(hist)
    out["n_windows"] = int(anchors.size)
    out["stride"] = int(stride)
    return out
