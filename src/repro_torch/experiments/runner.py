"""Core cell runner: one (scenario spec × policy spec × seed) → tidy row
(the port of ``repro/experiments/runner.py``).

Deterministic in the cell's specs — safe to run in a worker process, every
input is rebuilt from primitives — and shared by the executor backends:
``serial``/``process`` call :func:`run_cell` whole. Each entry point takes
the torch ``device`` the policy runs on (None: the CUDA card) and passes it
to ``policy.build``; it is never part of a spec.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import repro_torch.obs as obs
from repro_torch import policy
from repro_torch.experiments.plan import Cell
from repro_torch.experiments.scenario import build_instance
from repro_torch.sim.engine import EventSimulator, SimConfig
from repro_torch.sim.metrics import stress_water_kl, summarize


class CellError(RuntimeError):
    """A cell failed. Carries the failing cell's identity so a sweep
    driver (or a human reading a log) can reproduce it: ``err.scenario``
    and ``err.spec`` are the re-parseable spec strings; when raised by
    ``ExperimentPlan.run(strict=True)`` the completed rows ride along as
    ``err.rows``."""

    def __init__(self, scenario_spec: str, policy_spec: str, cause: str):
        super().__init__(
            f"experiment cell failed: scenario {scenario_spec!r} × "
            f"policy {policy_spec!r}: {cause}")
        self.scenario = scenario_spec
        self.spec = policy_spec
        self.cause = cause
        self.rows: List[Dict] = []


def resolve_policy_spec(cell: Cell, inst) -> policy.PolicySpec:
    """The cell's fully resolved policy spec: ``sched_kwargs``-style
    overrides are already in the spec; a scenario's forecast-error regime
    (bias/noise injection) is folded in here so the row's ``spec`` column
    reproduces the *injected* scheduler exactly."""
    spec = policy.as_spec(cell.policy)
    if policy.get_policy(spec.name).forecast_driven \
            and (inst.forecast_bias != 1.0 or inst.forecast_noise > 0.0):
        spec = spec.with_defaults(forecast_bias=inst.forecast_bias,
                                  forecast_noise=inst.forecast_noise,
                                  forecast_seed=cell.seed_value)
    return spec


def forecast_stats(sched, n_jobs: int) -> Optional[Dict]:
    """Deferral/forecast telemetry of one scheduler instance, if it is
    forecast-driven (``None`` otherwise). Carries the raw job counts so
    shard-merged rows can aggregate job-weighted (``merge_forecast_stats``
    in the reference's ``repro.experiments.shard``) instead of dropping the
    fields."""
    if not hasattr(sched, "forecast_mape"):
        return None
    deferred = int(sched.deferred_jobs)
    return dict(forecast_mape=float(sched.forecast_mape),
                mean_defer_s=float(sched.mean_defer_s),
                deferred_jobs=deferred, jobs=int(n_jobs),
                deferred_pct=100.0 * deferred / max(n_jobs, 1))


def finalize_row(cell: Cell, spec: policy.PolicySpec, inst, result: Dict,
                 wall_s: float, stats: Optional[Dict] = None,
                 return_result: bool = False) -> Dict:
    """Build the tidy row for one executed cell from its engine result."""
    row = dict(scenario=cell.scenario.name, scheduler=spec.name,
               spec=str(spec), scenario_spec=str(cell.resolved_scenario()),
               seed=cell.seed_value, error="", **summarize(result))
    row["wall_s"] = wall_s
    row["unfinished"] = result["unfinished"]
    weight = (inst.water_weight if inst.water_weight is not None
              else np.ones(inst.tele.num_regions))
    row["stress_water_kl"] = stress_water_kl(result, weight)
    if stats is not None:
        row["forecast_mape"] = stats["forecast_mape"]
        row["mean_defer_s"] = stats["mean_defer_s"]
        row["deferred_pct"] = stats["deferred_pct"]
    if return_result:
        row["_result"] = result
    return row


def error_row(cell: Cell, exc: BaseException) -> Dict:
    """Tidy row for a crashed cell: identity columns + the ``error``
    column; metrics stay empty so downstream aggregation skips it."""
    try:
        scenario_spec = str(cell.resolved_scenario())
    except Exception:                       # the scenario spec itself broke
        scenario_spec = str(cell.scenario)
    return dict(scenario=cell.scenario.name, scheduler=cell.policy.name,
                spec=str(cell.policy), scenario_spec=scenario_spec,
                seed=cell.seed_value,
                error=f"{type(exc).__name__}: {exc}")


def execute(cell: Cell, extra_build_kwargs: Optional[Dict] = None,
            device=None):
    """Build and run one cell; returns ``(inst, spec, sched, result,
    wall_s)`` for callers that post-process the raw engine result."""
    from repro_torch.core import solvers

    solvers.available_backends()     # one-time backend imports, off the clock
    inst, cellkw = build_instance(cell.resolved_scenario(),
                                  extra_build_kwargs)
    spec = resolve_policy_spec(cell, inst)
    sched = policy.build(spec, inst.tele, device=device)
    sim = EventSimulator(inst.tele, inst.capacity,
                         SimConfig(window_s=cellkw["window_s"]),
                         capacity_events=inst.capacity_events)
    with obs.timed("cell.run", scenario=cell.scenario.name,
                   scheduler=spec.name, jobs=len(inst.jobs)) as t:
        result = sim.run(inst.jobs, sched)
    return inst, spec, sched, result, t.elapsed_s


def run_cell(cell: Cell, extra_build_kwargs: Optional[Dict] = None,
             return_result: bool = False, device=None) -> Dict:
    """The unsharded cell runner (serial and process backends; also the
    module-level picklable entry point for pool workers)."""
    inst, spec, sched, result, wall = execute(cell, extra_build_kwargs,
                                              device=device)
    return finalize_row(cell, spec, inst, result, wall,
                        stats=forecast_stats(sched, len(inst.jobs)),
                        return_result=return_result)


def run_cell_obs(cell: Cell, device=None) -> Dict:
    """``run_cell`` with obs collection enabled inside the worker process
    (``repro_torch.obs`` registries are per-process, so a fresh pool worker is
    otherwise dark). Ships the worker's metrics snapshot in the private
    ``_obs`` row key — popped and merged into the driver registry by
    ``ProcessExecutor``; ``to_csv``'s fixed column set never sees it."""
    with obs.capture(fold=False) as reg:
        row = run_cell(cell, device=device)
        row["_obs"] = reg.snapshot()
    return row
