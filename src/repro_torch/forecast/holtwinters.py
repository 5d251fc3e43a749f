"""Holt–Winters damped-trend seasonal forecaster — the port of
``repro/forecast/holtwinters.py``; the grid filter runs in PyTorch on the
forecaster's device.

The additive damped-trend seasonal recursions (Hyndman & Athanasopoulos §7.3,
the ETS(A,Ad,A) filter) over hourly history ``y[t]``:

    l_t = α·(y_t − s_{t−m}) + (1−α)·(l_{t−1} + φ·b_{t−1})
    b_t = β·(l_t − l_{t−1}) + (1−β)·φ·b_{t−1}
    s_t = γ·(y_t − l_t) + (1−γ)·s_{t−m}

"Fitting" here = one forward filter pass per candidate smoothing-parameter
triple, selecting the per-column triple with the lowest post-warmup one-step
SSE. The filter is a loop over time with the parameter grid as a batch
dimension, in float32 as in the reference (the host keeps float64). History
windows are padded to the reference's buckets, so the same SSE and the same
grid choice come out.

Point forecasts are closed-form from the final state; quantile bands use the
selected triple's one-step residual σ widened with √horizon.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.forecast import base
from repro_torch.runtime import platform

# Candidate smoothing parameters (α, β, γ). A coarse grid is standard for
# online refitting: the SSE surface is flat near the optimum and the filter
# cost is P parallel scans.
_ALPHAS = (0.2, 0.4, 0.7)
_BETAS = (0.05, 0.15)
_GAMMAS = (0.1, 0.3)
PARAM_GRID = np.array([(a, b, g) for a in _ALPHAS for b in _BETAS
                       for g in _GAMMAS], np.float32)
PHI = 0.98        # trend damping (φ<1: long-horizon forecasts flatten out)

# History windows are clipped to at most MAX_FIT_PERIODS seasonal periods and
# padded up to the next bucket (a small set of whole-period multiples): the
# reference compiles its filter once per bucket, and the port pads the same
# way so the filter sees the same series.
# Padding prepends a cyclic extension of the oldest period, which keeps the
# seasonal phase of the padded series identical to the real one.
FIT_BUCKET_PERIODS = (2, 3, 4, 6, 8, 12, 14)
MAX_FIT_PERIODS = FIT_BUCKET_PERIODS[-1]


def fit_bucket_for(rows: int, period: int) -> int:
    """Smallest whole-period bucket ≥ rows."""
    for k in FIT_BUCKET_PERIODS:
        if rows <= k * period:
            return k * period
    return MAX_FIT_PERIODS * period


def _hw_filter(y: torch.Tensor, params: torch.Tensor, valid0: int,
               period: int):
    """Forward ETS(A,Ad,A) filter over ``y`` for every parameter triple.

    Args:
      y: [T, C] float32 history (oldest first).
      params: [P, 3] float32 (alpha, beta, gamma) candidates; the grid is a
        batch dimension of every step.
      valid0: rows before this index are padding replicas of the oldest
        observations; their one-step errors are excluded from the SSE.
      period: seasonal period.

    Returns:
      level [P, C], trend [P, C], season [P, period, C] (season[0] is the
      seasonal term for the *next* time step), sse [P, C], count (float).

    The reference runs this as a ``lax.scan`` vmapped over the grid; here
    it is a Python loop over T, every step in the reference's float32
    operation order. The season is a ring buffer indexed by t mod period
    (the reference shifts its [period, C] window each step); the values
    are the same.
    """
    T, C = y.shape
    acc = y[0]
    for k in range(1, period):       # the reference's sequential row sum
        acc = acc + y[k]
    l0 = acc / period                                         # [C]
    alpha, beta, gamma = (params[:, i, None] for i in range(3))   # [P, 1]
    P = params.shape[0]
    level = l0.expand(P, C)
    trend = torch.zeros((P, C), dtype=y.dtype, device=y.device)
    ring = (y[:period] - l0[None, :])[:, None, :].repeat(1, P, 1)  # [m,P,C]
    sse = torch.zeros((P, C), dtype=y.dtype, device=y.device)
    cnt = 0.0
    warmup = valid0 + period
    for t in range(T):
        y_t = y[t]
        s_prev = ring[t % period]
        damped = level + PHI * trend
        err = y_t - (damped + s_prev)
        l_new = alpha * (y_t - s_prev) + (1 - alpha) * damped
        trend = beta * (l_new - level) + (1 - beta) * PHI * trend
        ring[t % period] = gamma * (y_t - l_new) + (1 - gamma) * s_prev
        level = l_new
        if t >= warmup:
            sse = sse + err * err
            cnt += 1.0
    season = torch.roll(ring, -(T % period), dims=0).permute(1, 0, 2)
    return level, trend, season, sse, cnt


def damped_sum(horizon: int, phi: float = PHI) -> np.ndarray:
    """[Σ_{i=1..h} φ^i for h=1..H] — the damped-trend forecast multiplier."""
    return np.cumsum(phi ** np.arange(1, horizon + 1))


@base.register_model
class HoltWinters(base.Forecaster):
    """Damped-trend seasonal Holt–Winters with grid-selected smoothing."""

    name = "holtwinters"
    description = ("damped-trend seasonal ETS(A,Ad,A) filter, "
                   "grid-selected smoothing, on the forecaster's torch "
                   "device")
    on_device = True

    def __init__(self, period: int = 24, device=None):
        """``device``: where the grid filter runs (None: the CUDA card)."""
        self.period = period
        self.device = platform.device(device)

    def fit(self, history: np.ndarray) -> "HoltWinters":
        y = np.asarray(history, np.float64)
        self._T = y.shape[0]
        self._last = y[-1]
        # Too short for a seasonal init: delegate (which itself falls back to
        # persistence below one full period).
        if self._T < 2 * self.period:
            self._fallback = base.SeasonalNaive(self.period).fit(y)
            return self
        self._fallback = None
        y = y[-MAX_FIT_PERIODS * self.period:]
        rows = y.shape[0]
        pad = fit_bucket_for(rows, self.period) - rows
        if pad:
            # Cyclic extension of the oldest period, aligned so the row just
            # before y[0] is y[period-1]: the padded series is exactly
            # periodic, preserving seasonal phase and init.
            reps = int(np.ceil(pad / self.period))
            ext = np.tile(y[:self.period], (reps, 1))[-pad:] \
                if pad % self.period == 0 else \
                np.tile(y[:self.period], (reps + 1, 1))[
                    self.period - (pad % self.period):][:pad]
            y = np.vstack([ext, y])
        level, trend, season, sse, cnt = _hw_filter(
            torch.from_numpy(y.astype(np.float32)).to(self.device),
            torch.from_numpy(PARAM_GRID).to(self.device), pad, self.period)
        level, trend, season, sse = (
            t.cpu().numpy() for t in (level, trend, season, sse))
        best = np.argmin(sse, axis=0)                      # [C]
        cols = np.arange(y.shape[1])
        self._level = level[best, cols].astype(np.float64)
        self._trend = trend[best, cols].astype(np.float64)
        self._season = season[best, :, cols].T.astype(np.float64)  # [m, C]
        n = max(cnt, 1.0)
        self._sigma = np.sqrt(sse[best, cols].astype(np.float64) / n)
        return self

    def predict(self, horizon: int) -> base.Forecast:
        if self._fallback is not None:
            return self._fallback.predict(horizon)
        damp = damped_sum(horizon)
        idx = np.arange(horizon) % self.period
        mean = (self._level[None, :] + damp[:, None] * self._trend[None, :]
                + self._season[idx])
        lo, hi = self._gaussian_band(mean, self._sigma)
        return base.Forecast(self._T - 1, mean, lo, hi, self._last.copy())
