"""Walk-forward backtesting of forecasters against telemetry series.

``backtest(series, make)`` replays the classic expanding-window protocol:
at every origin t ≥ warmup the forecaster is fit on ``series[:t]`` and
scored against the true ``series[t:t+horizon]`` with

  * MAPE        — point accuracy (% of truth magnitude), per lead hour and
                  overall;
  * pinball loss — quantile-band calibration at the forecaster's (lo, hi)
                  quantiles (mean over both tails);
  * band coverage — fraction of truth inside [lo, hi].

``backtest_telemetry`` is the convenience entry for the generator's hourly
signals (ci / ewif / wue / water intensity).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core import telemetry
from repro_torch.forecast import base


def mape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean absolute percentage error (%), guarded against zero truth.

    The denominator is floored at ``|t| = 1e-9``, so the result is always
    finite: an exact prediction of a zero truth contributes 0, while a
    nonzero prediction of a zero truth contributes a huge (but finite and
    deterministic) term — a signal that percentage error is the wrong
    metric for that series (use ``pinball_loss``/MAE on near-zero signals;
    the telemetry signals this repo forecasts are strictly positive).
    Accepts any matching shapes, including scalars and length-1 series.
    """
    t = np.asarray(y_true, np.float64)
    p = np.asarray(y_pred, np.float64)
    return float(100.0 * np.mean(np.abs(p - t) / np.maximum(np.abs(t), 1e-9)))


def pinball_loss(y_true: np.ndarray, y_pred: np.ndarray, q: float) -> float:
    """Quantile (pinball) loss for quantile level ``q``.

    At ``q = 0.5`` this is exactly half the mean absolute error (pinned by
    a property test), which is why the q50 head of a quantile forecaster is
    also its point forecast. Defined for any matching shapes, length-1 and
    all-zero series included (no division anywhere).
    """
    d = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return float(np.mean(np.maximum(q * d, (q - 1.0) * d)))


def backtest(series: np.ndarray, make: Callable[[], base.Forecaster], *,
             horizon: int = 6, warmup: int = 30, stride: int = 1,
             refit_every: int = 1) -> Dict:
    """Expanding-window backtest of a ``make()`` forecaster over ``series``.

    One forecaster instance walks forward through the origins: it is fully
    re-``fit`` at the first origin and every ``refit_every``-th origin after
    that, and cheaply ``update``-d (re-conditioned on the grown history) in
    between. For the stateless classical models ``update`` *is* ``fit``, so
    ``refit_every`` only matters for models with a real training cost (the
    learned forecaster trains on refits and re-conditions on updates).

    Args:
      series: [T, C] hourly truth.
      make: zero-arg factory returning the forecaster to walk forward.
      horizon: lead hours scored per origin.
      warmup: first origin (minimum history length).
      stride: hours between consecutive origins.
      refit_every: full-refit cadence in origins (1 = refit every origin).

    Returns a dict with overall ``mape``, per-lead ``mape_by_lead`` [horizon],
    ``pinball`` (mean of both tails), ``coverage`` in [0, 1], and
    ``n_origins``.
    """
    y = np.asarray(series, np.float64)
    T = y.shape[0]
    origins = range(warmup, T - horizon + 1, stride)
    abs_pct = []        # [n, horizon] per-origin per-lead APE means
    pin, cover = [], []
    n = 0
    f = make()
    for i, t in enumerate(origins):
        if refit_every <= 1 or i % refit_every == 0:
            f.fit(y[:t])
        else:
            f.update(y[:t])
        fc = f.predict(horizon)
        truth = y[t:t + horizon]
        ape = np.abs(fc.mean - truth) / np.maximum(np.abs(truth), 1e-9)
        abs_pct.append(100.0 * ape.mean(axis=1))
        q_lo, q_hi = fc.quantiles
        pin.append(0.5 * (pinball_loss(truth, fc.lo, q_lo)
                          + pinball_loss(truth, fc.hi, q_hi)))
        cover.append(float(np.mean((truth >= fc.lo) & (truth <= fc.hi))))
        n += 1
    if n == 0:
        raise ValueError("series too short for the requested warmup/horizon")
    by_lead = np.mean(abs_pct, axis=0)
    return dict(mape=float(by_lead.mean()), mape_by_lead=by_lead,
                pinball=float(np.mean(pin)), coverage=float(np.mean(cover)),
                n_origins=n)


def backtest_telemetry(tele: telemetry.Telemetry, key: str, name: str, *,
                       horizon: int = 6, warmup: int = 30, stride: int = 1,
                       refit_every: int = 1, **model_kw) -> Dict:
    """Backtest a named forecaster on one telemetry signal.

    ``key`` ∈ {"ci", "ewif", "wue", "water_intensity"}; ``name`` is a
    registered model name or ``"oracle"``; ``refit_every`` sets the
    walk-forward full-refit cadence (see :func:`backtest`); ``model_kw``
    are constructor overrides for the named model (e.g. ``train_steps``
    for ``learned``).
    """
    series = getattr(tele, key)
    if name == "oracle":
        make = lambda: base.Oracle(series)
    else:
        make = lambda: base.make_forecaster(name, **model_kw)
    return backtest(series, make, horizon=horizon, warmup=warmup,
                    stride=stride, refit_every=refit_every)
