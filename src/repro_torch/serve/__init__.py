"""repro_torch.serve: the always-on streaming scheduler service (the port of
``repro/serve``).

Batch replay answers "what would this policy have done over that trace";
a *service* must answer it continuously: arrivals stream in, each decision
round has a wall-clock budget, the admission buffer is bounded, and held
jobs are re-planned as forecasts refresh. This package is that seam over
the same engine and policies:

* ``arrivals``  — pull-based ``ArrivalSource`` streams (trace replay,
                  endless Poisson-burst, JSONL file tail) and the bounded
                  ``AdmissionQueue`` with explicit shed accounting;
* ``loop``      — the ``DecisionLoop`` driving ``EngineStepper`` rounds
                  (inject → step-to-boundary) with round-latency metrics,
                  and the ``ServeReport``.

Receding-horizon re-planning and the Sinkhorn warm-start carry live in
the *policy* (``waterwise-forecast[replan=true,warm=true]``) — the loop
just drives rounds; see ``policy.ReplanQueueDeferral`` and
``core.round.SinkhornWarmStart`` (on the card one launch of the
warm-started Sinkhorn kernel a round). On the CPU::

    DecisionLoop(EventSimulator(tele, cap), forecast_pipeline(
        tele, backend="fused", warm=True, device="cpu"),
        ReplayArrivals(jobs)).run(duration_s)
"""
from repro_torch.serve.arrivals import (DROP_OLDEST, REJECT_NEW,
                                        AdmissionQueue, ArrivalSource,
                                        FileTailArrivals,
                                        PoissonBurstArrivals, ReplayArrivals)
from repro_torch.serve.loop import DecisionLoop, ServeConfig, ServeReport

__all__ = [
    "ArrivalSource", "ReplayArrivals", "PoissonBurstArrivals",
    "FileTailArrivals", "AdmissionQueue", "REJECT_NEW", "DROP_OLDEST",
    "DecisionLoop", "ServeConfig", "ServeReport",
]
