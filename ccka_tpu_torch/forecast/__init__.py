"""Forecasting: predicted exogenous windows for non-oracle MPC.

`forecast/base.py` holds the protocol and the planning window,
`forecast/backends.py` the persistence, seasonal-naive and ridge AR-k
backends, `forecast/metrics.py` horizon-resolved MAPE/RMSE. The oracle
(perfect-foresight) path is ``forecaster=None`` wherever a forecaster is
taken.
"""
