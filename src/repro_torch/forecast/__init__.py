"""Forecasting + temporal-shifting subsystem — the port of
``repro/forecast`` (the forecaster registry is the port's own).

``base``        Forecaster interface + registry (did-you-mean errors),
                persistence / seasonal-naive baselines, the true-future
                Oracle, and the error-injection Perturbed wrapper.
``holtwinters`` Damped-trend seasonal Holt–Winters; the grid filter runs in
                PyTorch on the forecaster's device.
``learned``     RG-LRU (Griffin) sequence head with q10/q50/q90 outputs,
                trained on sliding telemetry windows with the port's AdamW,
                its linear recurrence the CUDA kernel on a card.
``backtest``    Walk-forward MAPE / pinball-loss / coverage scoring.
``planner``     Spatio-temporal (regions × horizon-slots) assignment builder
                + the deferral queue used by the forecast pipeline.

``holtwinters`` and ``learned`` run on a torch device and take ``device=``
(``on_device``); the others are numpy on the host.
"""
from repro_torch.forecast import holtwinters as _holtwinters  # registers
from repro_torch.forecast import learned as _learned          # registers
from repro_torch.forecast.backtest import (backtest, backtest_telemetry,
                                           mape, pinball_loss)
from repro_torch.forecast.base import (Forecast, Forecaster, Oracle,
                                       Persistence, Perturbed, SeasonalNaive,
                                       UnknownNameError, describe_forecasters,
                                       forecaster_schema, list_forecasters,
                                       make_forecaster, register_model)
from repro_torch.forecast.holtwinters import HoltWinters
from repro_torch.forecast.learned import LearnedForecaster
from repro_torch.forecast.planner import (DeferralQueue, TemporalPlan,
                                          build_temporal_plan)

__all__ = [
    "Forecast", "Forecaster", "Persistence", "SeasonalNaive", "Oracle",
    "Perturbed", "HoltWinters", "LearnedForecaster", "make_forecaster",
    "list_forecasters", "forecaster_schema", "describe_forecasters",
    "register_model", "UnknownNameError",
    "backtest", "backtest_telemetry", "mape", "pinball_loss",
    "DeferralQueue", "TemporalPlan", "build_temporal_plan",
]
