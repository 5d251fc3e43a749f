"""Discrete-event geo-distributed cluster simulator (paper §5-§6 testbed;
the port of ``repro/sim``).

``trace`` generates statistically matched arrival/duration/energy processes
(real trace files can be loaded when available), ``cluster``/``engine`` run
the event loop with any scheduler plugged in, and ``metrics`` computes the
paper's figures of merit.
"""
from repro_torch.sim.trace import (borg_trace, alibaba_trace,  # noqa: F401
                                   BENCHMARK_PROFILES)
from repro_torch.sim.engine import (Simulator, EventSimulator,  # noqa: F401
                                    WindowedSimulator, SimConfig)
from repro_torch.sim.metrics import summarize, savings_vs  # noqa: F401
