"""WaterWise Optimization Decision Controller — compatibility surface.

The controller now lives in ``repro_torch.policy.pipeline`` as ONE composable
``PolicyPipeline`` (Pricer × DeferralPolicy × solver backend) instead of a
``Controller`` / ``ForecastController`` subclass pair; every scheduler
variant is a declarative ``PolicySpec`` over that pipeline (see
``repro_torch.policy``). This module keeps the historical names importable:

  ``Controller(tele, **kw)``          -> ``reactive_pipeline`` (Algorithm 1:
                                         snapshot pricing + defer arc)
  ``ForecastController(tele, **kw)``  -> ``forecast_pipeline`` (forecast-
                                         grid pricing + deferral queue)

Both return a ``PolicyPipeline`` with the same attributes and the same
``schedule(jobs, now_s, capacity) -> Decision`` protocol as before.
"""
from __future__ import annotations

from repro_torch.policy.pipeline import (Decision, HistoryLearner, PolicyPipeline,
                                         forecast_pipeline, reactive_pipeline)

# Historical constructor names (still used by tests and downstream code).
Controller = reactive_pipeline
ForecastController = forecast_pipeline

__all__ = ["Controller", "Decision", "ForecastController", "HistoryLearner",
           "PolicyPipeline", "forecast_pipeline", "reactive_pipeline"]
