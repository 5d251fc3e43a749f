"""Comparison schedulers — paper §5 "Relevant Techniques".

All expose ``schedule(jobs, now_s, capacity) -> Decision`` (same contract as
``controller.Controller``) so the simulator treats them interchangeably.

  Baseline          home region, carbon/water-unaware (paper's reference).
  Round-Robin       cyclic region placement, sustainability-unaware.
  Least-Load        most-free-capacity region, sustainability-unaware.
  CarbonGreedyOpt   infeasible oracle: knows future carbon intensity, delays/
  WaterGreedyOpt    moves each job (within TOL) to its per-job best slot.
  Ecovisor          home-region carbon scaler (customized re-implementation
                    of [50] per paper §5): resource-scales jobs against a
                    trailing carbon-intensity target; carbon-only, no
                    cross-region moves, embodied carbon grows with runtime.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core import footprint, telemetry
from repro_torch.core.controller import Decision
from repro_torch.core.problem import Job


def _dummy_solver_result():
    from repro_torch.core import solvers
    return solvers.SolveResult(assign=np.zeros(0, np.int64), objective=0.0,
                               status="optimal", solve_time_s=0.0,
                               penalties=np.zeros(0), backend="rule")


class _RuleScheduler:
    """Shared capacity bookkeeping for the rule-based schemes."""

    name = "rule"

    def __init__(self, tele: telemetry.Telemetry):
        self.tele = tele
        self.solve_times: List[float] = []

    def _pick(self, job: Job, free: np.ndarray, now_s: float) -> int:
        raise NotImplementedError

    def schedule(self, jobs: Sequence[Job], now_s: float,
                 capacity: np.ndarray) -> Decision:
        free = capacity.astype(np.int64).copy()
        scheduled, assign, deferred = [], [], []
        for j in jobs:
            n = self._pick(j, free, now_s)
            if n is not None and free[n] > 0:
                free[n] -= 1
                j.region = n
                scheduled.append(j)
                assign.append(n)
            else:
                deferred.append(j)
        self.solve_times.append(0.0)
        return Decision(scheduled, np.asarray(assign, np.int64), deferred,
                        _dummy_solver_result(), False)


class Baseline(_RuleScheduler):
    name = "baseline"

    def _pick(self, job, free, now_s):
        return job.home_region if free[job.home_region] > 0 else None


class RoundRobin(_RuleScheduler):
    name = "round-robin"

    def __init__(self, tele):
        super().__init__(tele)
        self._next = 0

    def _pick(self, job, free, now_s):
        N = len(free)
        for k in range(N):
            n = (self._next + k) % N
            if free[n] > 0:
                self._next = (n + 1) % N
                return n
        return None


class LeastLoad(_RuleScheduler):
    name = "least-load"

    def _pick(self, job, free, now_s):
        n = int(np.argmax(free))
        return n if free[n] > 0 else None


class GreedyOpt(_RuleScheduler):
    """Carbon-/Water-Greedy-Opt oracle (paper §5, infeasible in practice).

    Has *future* telemetry: for each job it enumerates every (region,
    hourly start slot) that respects Eq 11 — start ≥ submit + L(home, n),
    start ≤ submit + TOL·t — and picks the single-metric minimum, integrating
    the true intensity over the execution window. Greedy in arrival order
    (the paper: "not truly optimal since they make the scheduling decision
    without knowing the characteristics of future job arrivals").

    Sets ``job.planned_start_s`` so the simulator can honor intentional
    delays.
    """

    def __init__(self, tele, metric: str = "carbon",
                 server: footprint.ServerSpec = None):
        super().__init__(tele)
        assert metric in ("carbon", "water")
        self.metric = metric
        self.server = server or footprint.m5_metal()
        self.name = f"{metric}-greedy-opt"

    def _objective(self, job: Job, n: int, start_s: float) -> float:
        te = self.tele
        m = te.mean_between(start_s, start_s + job.exec_time_s)
        if self.metric == "carbon":
            return float(footprint.job_carbon(job.energy_kwh,
                                              job.exec_time_s,
                                              float(m["ci"][n]),
                                              self.server))
        return float(footprint.job_water(job.energy_kwh, job.exec_time_s,
                                         te.pue[n], float(m["ewif"][n]),
                                         float(m["wue"][n]), te.wsf[n],
                                         self.server))

    def _pick(self, job, free, now_s):
        best, best_n, best_start = np.inf, None, now_s
        max_start = job.submit_time_s + job.tolerance * job.exec_time_s
        for n in range(self.tele.num_regions):
            if free[n] <= 0:
                continue
            lat = self.tele.transfer_latency_s(job.package_bytes,
                                               job.home_region, n)
            earliest = now_s + lat
            if earliest > max_start + 1e-9:
                continue                       # Eq 11 arc-infeasible
            starts = np.arange(earliest, max_start + 1e-9, telemetry.HOUR)
            for s in starts:
                obj = self._objective(job, n, float(s))
                if obj < best:
                    best, best_n, best_start = obj, n, float(s)
        if best_n is not None:
            job.planned_start_s = best_start
            return best_n
        # Delay budget exhausted (or every candidate region full): run at home
        # as soon as possible — a job must execute somewhere (the remaining
        # overrun is counted as a violation, exactly like the paper's Table 2
        # oracle rows).
        return job.home_region if free[job.home_region] > 0 else None


class Ecovisor(_RuleScheduler):
    """Customized Ecovisor [50]: home-region execution with a carbon scaler.

    Maintains a trailing carbon-intensity target per region; when the grid is
    dirtier than target, the job's resources are scaled down by
    s = target/ci (floored so the runtime extension stays inside the delay
    tolerance). Work is conserved: runtime ×1/s; energy picks up a static-
    power tax  E' = E·(α + (1−α)/s)  with α=0.7 dynamic fraction. Carbon-only
    (water-unaware), no cross-region moves — the paper's §6 comparison.
    """

    name = "ecovisor"
    alpha = 0.7

    def __init__(self, tele, window: int = 24):
        super().__init__(tele)
        self.window = window

    def _pick(self, job, free, now_s):
        n = job.home_region
        if free[n] <= 0:
            return None
        te = self.tele
        h = te.index(now_s)
        lo = max(h - self.window, 0)
        target = float(te.ci[lo:h + 1, n].mean()) if h > lo else te.ci[h, n]
        ci_now = float(te.ci[h, n])
        if ci_now > target > 0:
            s = max(target / ci_now, 1.0 / (1.0 + job.tolerance))
            job.time_scale = 1.0 / s
            job.energy_scale = self.alpha + (1.0 - self.alpha) / s
        return n


def make_scheduler(name: str, tele, **kw):
    """Deprecated shim over the ``repro_torch.policy`` registry.

    The old lambda table (plus the ``TUNABLE_SCHEDULERS`` /
    ``FORECAST_SCHEDULERS`` frozensets that silently dropped kwargs for
    everything else) is replaced by the declarative ``PolicySpec`` API::

        from repro_torch import policy
        sched = policy.build("waterwise[lam_h2o=0.7,backend=torch]", tele)

    This shim parses ``name`` as a spec string (bracketed params work too)
    and applies ``kw`` as validated overrides, so it produces bit-identical
    schedulers to the registry path — and now *raises* on unknown names or
    params instead of ignoring them.
    """
    from repro_torch import policy
    return policy.build(name, tele, **kw)
