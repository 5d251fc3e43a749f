"""The always-on decision loop: bounded-latency rounds over the stepable
engine, receding-horizon re-planning, and the service report (the port of
``repro/serve/loop.py``).

Structure of one round at boundary ``t_k`` (simulated time):

  1. ``source.poll(t_k)``      — arrivals of the last round period;
  2. ``admission.offer(...)``  — bounded buffering, explicit shed;
  3. ``admission.take(...)``   — up to ``max_round_jobs`` enter the engine;
  4. ``stepper.inject(...)``   — arrivals join the un-consumed trace tail;
  5. ``stepper.step(t_k)``     — the engine advances to the boundary,
                                 scheduling rounds firing on its own grid.

Because ``EngineStepper.step`` uses the chained-handoff ``stop_at``
semantics (proven bit-exact by the sharded-execution tests), a
``DecisionLoop`` over ``ReplayArrivals`` with no admission bound pressure
reproduces ``EventSimulator.run`` of the same trace *bit for bit* — batch
replay and live serving are one engine (pinned in tests/test_torch_serve.py).

Wall-clock round latency is measured around step 5 (pricing + Sinkhorn +
extraction all live there) and fed to a ``runtime.StepWatchdog``; rounds
over ``round_budget_s`` count as budget overruns. On the card every solve
of a round ends in its device-to-host copy, so the wall already covers the
device work; the loop adds no synchronisation of its own. The scheduler
runs where it was built: a pipeline built without ``device="cpu"`` runs on
the card, and raises without one. The Sinkhorn warm-start
carry (``core.round.SinkhornWarmStart``) lives inside the scheduler
pipeline (``waterwise-forecast[warm=true]``) and is surfaced per-service
in the report as cold vs warm iterations-to-converge.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

import repro_torch.obs as obs
from repro_torch.runtime.elastic import StepWatchdog
from repro_torch.serve.arrivals import (REJECT_NEW, AdmissionQueue,
                                        ArrivalSource)
from repro_torch.sim.engine import EventSimulator


@dataclasses.dataclass
class ServeConfig:
    """Decision-loop knobs (simulated-time cadence, wall-time budget)."""
    round_s: float = 30.0            # decision-round period (simulated)
    queue_bound: int = 10_000        # admission buffer bound
    shed_policy: str = REJECT_NEW    # who pays when the bound binds
    max_round_jobs: Optional[int] = None   # per-round injection cap
    round_budget_s: Optional[float] = None # wall-clock budget per round


def _pctl(values: List[float], q: float) -> float:
    return float(np.percentile(values, q)) if values else 0.0


@dataclasses.dataclass
class ServeReport:
    """What the service did — stream accounting + footprint + latency."""
    duration_s: float
    rounds: int                      # decision-loop rounds (boundaries)
    engine_rounds: int               # scheduler rounds the engine fired
    jobs_in: int                     # arrivals pulled from the source
    admitted: int
    shed: int
    placed: int
    violations: int                  # placed jobs over tolerance
    deadline_misses: int             # violations + shed (shed = missed)
    carbon_kg: float
    water_kl: float
    mean_defer_s: float
    replans: int
    budget_overruns: int             # rounds over the wall-clock budget
    p50_round_ms: float
    p99_round_ms: float
    max_admission_depth: int
    max_engine_depth: int
    sinkhorn_cold_iters: float       # mean iterations, cold starts
    sinkhorn_warm_iters: float       # mean iterations, warm starts
    utilization: float

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class DecisionLoop:
    """Drive scheduler + engine against an arrival stream (module doc)."""

    def __init__(self, sim: EventSimulator, scheduler,
                 source: ArrivalSource,
                 config: Optional[ServeConfig] = None):
        self.sim = sim
        self.cfg = config or ServeConfig()
        self.source = source
        self.stepper = sim.stepper(scheduler)
        self.admission = AdmissionQueue(self.cfg.queue_bound,
                                        self.cfg.shed_policy)
        self.watchdog = StepWatchdog(self.cfg.round_budget_s
                                     if self.cfg.round_budget_s is not None
                                     else float("inf"))
        self.budget_overruns = 0
        self.rounds = 0
        self.max_engine_depth = 0

    def run_round(self, t_k: float) -> float:
        """One decision round up to boundary ``t_k``; returns the wall
        seconds the engine step took."""
        cfg = self.cfg
        arrivals = self.source.poll(t_k)
        with obs.span("serve.round", boundary_s=t_k,
                      arrivals=len(arrivals)) as sp:
            self.admission.offer(arrivals, self.stepper.now)
            batch = self.admission.take(cfg.max_round_jobs)
            self.stepper.inject(batch)
            t0 = time.perf_counter()
            self.stepper.step(t_k)
            wall = time.perf_counter() - t0
            if self.watchdog.observe(wall):
                self.budget_overruns += 1
                obs.counter("serve.budget_overrun")
            depth = len(self.stepper.pending)
            self.max_engine_depth = max(self.max_engine_depth, depth)
            if obs.enabled():
                obs.observe("serve.round_wall_ms", wall * 1e3)
                obs.gauge("serve.engine_depth", float(depth))
            sp.set(injected=len(batch), wall_ms=round(wall * 1e3, 3),
                   engine_depth=depth)
        self.rounds += 1
        return wall

    def run(self, duration_s: float, drain: bool = True) -> ServeReport:
        """Serve for ``duration_s`` of simulated time (then drain)."""
        cfg = self.cfg
        k = 1
        while (k - 1) * cfg.round_s < duration_s:
            self.run_round(min(k * cfg.round_s, duration_s))
            k += 1
        if drain:
            # Horizon end: whatever the admission buffer still holds enters
            # the engine, and the engine runs to empty.
            self.stepper.inject(self.admission.take())
            t0 = time.perf_counter()
            self.stepper.step(None)
            self.watchdog.observe(time.perf_counter() - t0)
        return self.report(duration_s)

    def report(self, duration_s: float) -> ServeReport:
        res = self.stepper.result()
        rec = res["records"]
        violations = sum(1 for r in rec if r.violated)
        sched = self.stepper.scheduler
        cold = getattr(sched, "sinkhorn_cold_iters", None) or []
        warm = getattr(sched, "sinkhorn_warm_iters", None) or []
        wall_ms = [w * 1e3 for w in self.watchdog.history]
        return ServeReport(
            duration_s=float(duration_s),
            rounds=self.rounds,
            engine_rounds=int(res["rounds"]),
            jobs_in=self.admission.offered,
            admitted=self.admission.admitted,
            shed=self.admission.shed,
            placed=len(rec),
            violations=violations,
            deadline_misses=violations + self.admission.shed,
            carbon_kg=float(sum(r.carbon_g for r in rec)) / 1e3,
            water_kl=float(sum(r.water_l for r in rec)) / 1e3,
            mean_defer_s=float(getattr(sched, "mean_defer_s", 0.0)),
            replans=int(getattr(sched, "replans", 0)),
            budget_overruns=self.budget_overruns,
            p50_round_ms=_pctl(wall_ms, 50),
            p99_round_ms=_pctl(wall_ms, 99),
            max_admission_depth=self.admission.peak_depth,
            max_engine_depth=self.max_engine_depth,
            sinkhorn_cold_iters=float(np.mean(cold)) if cold else 0.0,
            sinkhorn_warm_iters=float(np.mean(warm)) if warm else 0.0,
            utilization=float(res["utilization"]))
