"""Forecaster interface + reference models (persistence, seasonal-naive,
oracle, error-injection wrapper) — the port of ``repro/forecast/base.py``.

Every forecaster consumes an *hourly history matrix* ``[T, R]`` — one column
per region (or per stacked signal×region, see ``ForecastController``) — and
produces a ``Forecast``: point predictions plus a symmetric-in-probability
quantile band for the next ``H`` hours. The models here are the classical
baselines every forecasting study must beat (Hyndman & Athanasopoulos §5.2);
the Holt–Winters model lives in ``repro_torch.forecast.holtwinters``.

All forecasters are deterministic given their inputs (the error-injection
wrapper takes an explicit seed), so scenario sweeps that embed them stay
reproducible cell-for-cell.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Type

import numpy as np

from repro_torch import spec as _spec
from repro_torch.spec import UnknownNameError  # noqa: F401  (re-export)


HOUR = 3600.0

# Default band quantiles and the matching standard-normal z (the models use
# Gaussian residual bands: cheap, and calibrated enough for risk weighting).
QUANTILES: Tuple[float, float] = (0.1, 0.9)
_Z90 = 1.2815515655446004


@dataclasses.dataclass
class Forecast:
    """Point + quantile-band forecast for hours ``issue_hour+1 .. +H``.

    ``mean/lo/hi`` are ``[H, C]`` (C = columns of the fitted history);
    ``anchor`` is the last *observed* row, used to interpolate sub-hourly
    lookups continuously from the present into the forecast horizon.
    """
    issue_hour: int
    mean: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    anchor: np.ndarray
    quantiles: Tuple[float, float] = QUANTILES

    @property
    def horizon(self) -> int:
        return self.mean.shape[0]

    def at(self, t_s: float, which: str = "mean") -> np.ndarray:
        """Linearly interpolated forecast row at absolute time ``t_s``.

        Sample points sit on the hour grid: ``anchor`` at hour ``issue_hour``
        and ``mean[j]`` at hour ``issue_hour+1+j``. Times at or before the
        anchor return it; times beyond the horizon hold the last row.
        """
        return self.at_many(np.asarray([t_s]), which)[0]

    def at_many(self, t_s: np.ndarray, which: str = "mean") -> np.ndarray:
        """Vectorized ``at``: K times → [K, C] interpolated rows."""
        series = getattr(self, which)
        grid = np.vstack([self.anchor[None, :], series])
        u = np.clip(np.asarray(t_s, np.float64) / HOUR - self.issue_hour,
                    0.0, float(self.horizon))
        k = np.minimum(u.astype(np.int64), self.horizon - 1)
        frac = (u - k)[:, None]
        return (1.0 - frac) * grid[k] + frac * grid[k + 1]

    def _antiderivative(self, u: np.ndarray, which: str) -> np.ndarray:
        """A(u) = ∫_0^u g — g is the piecewise-linear forecast in hour
        coordinates (u = t/HOUR − issue_hour), held constant outside
        [0, horizon]. Returns [K, C] in value·hours."""
        grid = np.vstack([self.anchor[None, :], getattr(self, which)])
        seg = 0.5 * (grid[:-1] + grid[1:])
        cum = np.vstack([np.zeros((1, grid.shape[1])),
                         np.cumsum(seg, axis=0)])       # [H+1, C]
        u = np.asarray(u, np.float64)
        H = self.horizon
        below = np.minimum(u, 0.0)[:, None] * grid[0][None, :]
        above = np.maximum(u - H, 0.0)[:, None] * grid[-1][None, :]
        uc = np.clip(u, 0.0, H)
        k = np.minimum(uc.astype(np.int64), H - 1)
        f = (uc - k)[:, None]
        inner = cum[k] + grid[k] * f + 0.5 * (grid[k + 1] - grid[k]) * f ** 2
        return below + inner + above

    def mean_many(self, t0_s: np.ndarray, t1_s: np.ndarray,
                  which: str = "mean") -> np.ndarray:
        """Exact time-mean of the piecewise-linear forecast over [t0, t1],
        vectorized over K windows → [K, C].

        This is the planner's pricing primitive: the simulator accounts each
        job with the integrated telemetry over its execution window, so
        plan-time costs must integrate the *forecast* over the same window —
        with the oracle forecaster the two coincide exactly.
        """
        u0 = np.asarray(t0_s, np.float64) / HOUR - self.issue_hour
        u1 = np.maximum(np.asarray(t1_s, np.float64) / HOUR - self.issue_hour,
                        u0 + 1e-9)
        return ((self._antiderivative(u1, which)
                 - self._antiderivative(u0, which)) / (u1 - u0)[:, None])


class Forecaster:
    """``fit(history) -> self`` then ``predict(horizon) -> Forecast``."""

    name = "base"
    description = ""
    # Models that run on a torch device take ``device=`` (None: the CUDA
    # card); the pricer passes its pipeline's device to these only.
    on_device = False

    def fit(self, history: np.ndarray) -> "Forecaster":
        raise NotImplementedError

    def update(self, history: np.ndarray) -> "Forecaster":
        """Walk-forward refresh between full refits. For the stateless
        classical models this *is* a full refit (their ``fit`` is cheap);
        stateful models (the learned forecaster) override it to re-condition
        on the new history without retraining."""
        return self.fit(history)

    def predict(self, horizon: int) -> Forecast:
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------

    @staticmethod
    def _gaussian_band(mean: np.ndarray, sigma: np.ndarray) -> Tuple:
        """10/90% band around ``mean`` with per-step spread ``sigma`` that
        widens with lead time like a random walk (sqrt-of-horizon)."""
        H = mean.shape[0]
        widen = np.sqrt(np.arange(1, H + 1))[:, None]
        spread = _Z90 * sigma[None, :] * widen
        return mean - spread, mean + spread


class Persistence(Forecaster):
    """Tomorrow looks exactly like right now (the naive / random-walk model)."""

    name = "persistence"
    description = ("random-walk baseline: every lead repeats the last "
                   "observation")

    def fit(self, history: np.ndarray) -> "Persistence":
        y = np.asarray(history, np.float64)
        assert y.ndim == 2 and y.shape[0] >= 1
        self._last = y[-1]
        self._T = y.shape[0]
        d = np.diff(y, axis=0)
        self._sigma = d.std(axis=0) if d.shape[0] else np.zeros(y.shape[1])
        return self

    def predict(self, horizon: int) -> Forecast:
        mean = np.tile(self._last, (horizon, 1))
        lo, hi = self._gaussian_band(mean, self._sigma)
        return Forecast(self._T - 1, mean, lo, hi, self._last.copy())


class SeasonalNaive(Forecaster):
    """Tomorrow's hour h looks like today's hour h (period=24 by default).

    The right baseline for diurnal grid signals: carbon intensity and WUE are
    dominated by the solar/temperature cycle, which persistence is blind to.
    Falls back to persistence while history is shorter than one period.
    """

    name = "seasonal-naive"
    description = ("period-24 baseline: tomorrow's hour h repeats today's "
                   "hour h (persistence fallback below one period)")

    def __init__(self, period: int = 24):
        self.period = period

    def fit(self, history: np.ndarray) -> "SeasonalNaive":
        y = np.asarray(history, np.float64)
        self._T = y.shape[0]
        if self._T < self.period + 1:
            self._fallback: Optional[Persistence] = Persistence().fit(y)
            return self
        self._fallback = None
        self._season = y[-self.period:]        # season[k] = lag-(period-k)
        self._last = y[-1]
        resid = y[self.period:] - y[:-self.period]
        self._sigma = resid.std(axis=0) if resid.shape[0] else \
            np.zeros(y.shape[1])
        return self

    def predict(self, horizon: int) -> Forecast:
        if self._fallback is not None:
            return self._fallback.predict(horizon)
        idx = np.arange(horizon) % self.period
        mean = self._season[idx]
        lo, hi = self._gaussian_band(mean, self._sigma)
        return Forecast(self._T - 1, mean, lo, hi, self._last.copy())


class Oracle(Forecaster):
    """Reads the true future — the infeasible upper bound for planner studies.

    Holds the full ground-truth matrix ``[T_all, C]``; ``fit`` only records
    how much of it the caller has "seen". Lookups past the end wrap
    periodically, matching ``telemetry.Telemetry.at``.
    """

    name = "oracle"

    def __init__(self, truth: np.ndarray):
        self._truth = np.asarray(truth, np.float64)

    def fit(self, history: np.ndarray) -> "Oracle":
        self._T = np.asarray(history).shape[0]
        return self

    def predict(self, horizon: int) -> Forecast:
        T_all = self._truth.shape[0]
        idx = (self._T + np.arange(horizon)) % T_all
        mean = self._truth[idx]
        return Forecast(self._T - 1, mean, mean.copy(), mean.copy(),
                        self._truth[(self._T - 1) % T_all].copy())


class Perturbed(Forecaster):
    """Error-injection wrapper: systematic bias × multiplicative noise.

    Drives the ``forecast_error`` scenario regime — a planner must degrade
    gracefully when its forecaster over-/under-predicts (bias ≠ 1) or is
    simply noisy. Deterministic given ``seed`` and the fit history length.
    Bands are *not* widened: the planner believes its bad forecast, which is
    exactly the failure mode under study.
    """

    name = "perturbed"

    def __init__(self, inner: Forecaster, bias: float = 1.0,
                 noise: float = 0.0, seed: int = 0):
        self.inner = inner
        self.bias = float(bias)
        self.noise = float(noise)
        self.seed = int(seed)

    def fit(self, history: np.ndarray) -> "Perturbed":
        self.inner.fit(history)
        self._T = np.asarray(history).shape[0]
        return self

    def predict(self, horizon: int) -> Forecast:
        fc = self.inner.predict(horizon)
        rng = np.random.default_rng((self.seed, self._T))
        factor = self.bias * np.exp(
            self.noise * rng.standard_normal(fc.mean.shape))
        mean = fc.mean * factor
        return Forecast(fc.issue_hour, mean, fc.lo * factor, fc.hi * factor,
                        fc.anchor, fc.quantiles)


_MODELS: Dict[str, Type[Forecaster]] = {
    Persistence.name: Persistence,
    SeasonalNaive.name: SeasonalNaive,
}


def register_model(cls: Type[Forecaster]) -> Type[Forecaster]:
    _MODELS[cls.name] = cls
    return cls


def _ensure_models() -> None:
    # The HoltWinters / learned registrations are import side effects of
    # their modules; importing the package pulls them in. Guard for callers
    # that imported ``repro_torch.forecast.base`` directly.
    if "holtwinters" not in _MODELS or "learned" not in _MODELS:
        import repro_torch.forecast  # noqa: F401


def model_class(name: str) -> Type[Forecaster]:
    """The registered forecaster class ``name``. Unknown names raise the
    shared did-you-mean ``UnknownNameError`` (a ``KeyError`` subclass,
    matching the policy/scenario registries)."""
    _ensure_models()
    if name not in _MODELS:
        raise _spec.unknown_name_error("forecaster", name, sorted(_MODELS))
    return _MODELS[name]


def make_forecaster(name: str, **kw) -> Forecaster:
    """Instantiate a history-driven forecaster by name (see
    ``model_class``). ``oracle`` is not constructible here — it needs
    ground truth, which only the caller (pricer / backtest harness) holds.
    Models that run on a torch device (``on_device``) take ``device=``.
    """
    return model_class(name)(**kw)


def list_forecasters() -> list:
    _ensure_models()
    return sorted(_MODELS)


def forecaster_schema(name: str) -> Dict[str, _spec.Param]:
    """Typed constructor-parameter schema of a registered forecaster,
    introspected from its ``__init__`` signature (the same derivation the
    policy registry uses, so documented defaults can never drift; the
    ``device`` of the on-device models has no spec type and is skipped)."""
    return {p.name: p
            for p in _spec.params_from_signature(model_class(name))}


def describe_forecasters(markdown: bool = False) -> str:
    """Human-readable registry dump (the ``--list-forecasters`` surface and
    the source of the README forecaster table)."""
    entries: List[Type[Forecaster]] = [_MODELS[n]
                                       for n in list_forecasters()]
    if markdown:
        lines = ["| forecaster | parameters | description |", "|---|---|---|"]
        for cls in entries:
            ps = ", ".join(f"`{p.describe()}`"
                           for p in forecaster_schema(cls.name).values()) \
                or "—"
            lines.append(f"| `{cls.name}` | {ps} | {cls.description} |")
        return "\n".join(lines)
    lines = []
    for cls in entries:
        lines.append(f"{cls.name:16s} {cls.description}")
        for p in forecaster_schema(cls.name).values():
            lines.append(f"    {p.describe()}")
    return "\n".join(lines)
