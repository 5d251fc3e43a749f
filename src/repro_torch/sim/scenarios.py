"""Scenario registry + fleet-scale sweep runner (the port of
``repro/sim/scenarios.py``: the same scenarios, builders and parameters,
built from the port's own telemetry and trace generators).

A *scenario* is a named, deterministic composition of

  * a telemetry perturbation  (drought, grid decarbonization, …),
  * a trace generator          (Borg-like steady, Alibaba-like bursty, …),
  * a capacity profile         (static, or timed capacity events — outages),
  * an accounting view         (e.g. Wu et al.-style water-stress weighting).

The paper evaluates WaterWise under one telemetry regime; related work shows
conclusions move with the regime (Attenni et al. sweep spatio-temporal
shifting policies across regions/seasons; Wu et al. show water rankings flip
under water-stress weighting). This module makes those regimes first-class:
``sweep(schedulers, scenarios)`` runs the full cross product on the
event-driven engine — optionally fanned out across worker processes — and
returns one tidy row per (scenario, scheduler) cell. Schedulers are
declarative policy specs (``repro_torch.policy``): strings like
``"waterwise-forecast[horizon_slots=8]"`` work anywhere, and every row's
``spec`` column re-parses to the exact policy that produced it.

Adding a scenario::

    @register("heatwave", "2-week heatwave: +8C wet-bulb everywhere")
    def _heatwave(days, seed, jobs_per_day, utilization):
        inst = _base(days, seed, jobs_per_day, utilization)
        return dataclasses.replace(
            inst, tele=scale_wue(inst.tele, 1.9), name="heatwave")

The builder must be deterministic in its arguments (property-tested).

The two workflow scenarios build their DAG traces with the port's
``repro_torch.workflows.generators``. ``run_cell`` and ``sweep`` take the
torch ``device`` the policies run on (None: the CUDA card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.problem import Job
from repro_torch.sim.trace import (DAY, alibaba_trace, borg_trace,
                                   scale_capacity_for_utilization)


@dataclasses.dataclass
class ScenarioInstance:
    """Everything one simulation run needs, fully materialized."""
    name: str
    tele: telemetry.Telemetry
    jobs: List[Job]
    capacity: np.ndarray
    capacity_events: List[Tuple[float, object]] = \
        dataclasses.field(default_factory=list)
    # Per-region weights applied to each record's water footprint when
    # reporting `stress_water_kl` (Wu et al.: liters in a water-stressed
    # basin are not interchangeable with liters in a wet one). None = 1.
    water_weight: Optional[np.ndarray] = None
    # Forecast-error regime (systematic over-/under-prediction × noise):
    # injected into forecast-driven schedulers by ``run_cell``. 1.0/0.0 = off.
    forecast_bias: float = 1.0
    forecast_noise: float = 0.0


#: Help strings for builder params surfaced through the ScenarioSpec
#: grammar (``repro_torch.experiments``); the builder signatures stay the single
#: source of truth for names, types, and defaults.
_PARAM_HELP = {
    "trace": "trace generator (borg / alibaba)",
    "tolerance": "delay tolerance TOL (fraction of exec time of slack)",
    "ewif_table": "water-intensity dataset (macknick / wri)",
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    build: Callable[..., ScenarioInstance]

    @property
    def params(self):
        """Builder-specific typed params (beyond the shared cell params of
        ``repro_torch.experiments.scenario.CELL_PARAMS``), introspected from the
        builder signature. Builders that forward ``**kw`` inherit
        ``_base``'s keyword params (``trace``, ``tolerance``,
        ``ewif_table``); non-spec-expressible arguments (``regions``) stay
        build-kwargs-only. Introspection keeps the documented defaults
        from ever drifting from the code."""
        from repro_torch.spec import has_var_keyword, params_from_signature
        ps = params_from_signature(self.build, drop_positional=4,
                                   help_text=_PARAM_HELP)
        if has_var_keyword(self.build):
            seen = {p.name for p in ps}
            ps += [p for p in params_from_signature(_base, drop_positional=4,
                                                    help_text=_PARAM_HELP)
                   if p.name not in seen]
        return {p.name: p for p in ps}


_REGISTRY: Dict[str, Scenario] = {}


def register(name: str, description: str):
    """Decorator: register a scenario builder under ``name``."""
    def deco(fn):
        _REGISTRY[name] = Scenario(name=name, description=description,
                                   build=fn)
        return fn
    return deco


def get_scenario(name: str) -> Scenario:
    if name not in _REGISTRY:
        from repro_torch.spec import unknown_name_error
        raise unknown_name_error("scenario", name, list(_REGISTRY))
    return _REGISTRY[name]


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


def describe(markdown: bool = False) -> str:
    """Human-readable scenario-registry dump (the ``--list-scenarios``
    surface and the source of the README scenario table). Lists each
    scenario's builder-specific params; the shared cell params (``days``,
    ``seed``, ``jobs_per_day``, ``utilization``, ``window_s``) apply to
    every scenario and are documented once by the experiments API."""
    entries = [_REGISTRY[n] for n in sorted(_REGISTRY)]
    if markdown:
        lines = ["| scenario | extra parameters | description |",
                 "|---|---|---|"]
        for e in entries:
            ps = ", ".join(f"`{p.describe()}`" for p in e.params.values()) \
                or "—"
            lines.append(f"| `{e.name}` | {ps} | {e.description} |")
        return "\n".join(lines)
    lines = []
    for e in entries:
        lines.append(f"{e.name:24s} {e.description}")
        for p in e.params.values():
            doc = f"  — {p.help}" if p.help else ""
            lines.append(f"    {p.describe():28s}{doc}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Telemetry perturbations (pure: Telemetry -> new Telemetry)
# ---------------------------------------------------------------------------

def scale_wue(tele: telemetry.Telemetry, factor: float) -> telemetry.Telemetry:
    return dataclasses.replace(tele, wue=tele.wue * factor)


def raise_wsf(tele: telemetry.Telemetry, gain: float = 1.5,
              floor: float = 0.1) -> telemetry.Telemetry:
    return dataclasses.replace(
        tele, wsf=np.minimum(tele.wsf * gain + floor, 1.0))


def decarbonize(tele: telemetry.Telemetry, regions: Sequence[int],
                onset_frac: float = 0.4, final_scale: float = 0.55,
                horizon_hours: Optional[float] = None) -> telemetry.Telemetry:
    """Grid-decarbonization event: carbon intensity in ``regions`` ramps
    linearly from 1.0× down to ``final_scale``× starting at ``onset_frac``
    of the *simulated* horizon (coal retirement / renewables buildout).

    ``horizon_hours`` is the simulated span; telemetry is generated with
    headroom beyond it (whole days + 1), so anchoring the ramp to the raw
    array length would push the event past the end of short simulations.
    Hours beyond the horizon hold at ``final_scale``."""
    T = tele.num_hours
    H = min(float(horizon_hours) if horizon_hours is not None else T, T)
    onset = int(H * onset_frac)
    end = min(int(np.ceil(H)), T)
    ramp = np.ones(T)
    if onset < end:
        ramp[onset:end] = np.linspace(1.0, final_scale, end - onset)
    ramp[end:] = final_scale
    ci = tele.ci.copy()
    for r in regions:
        ci[:, r] = ci[:, r] * ramp
    return dataclasses.replace(tele, ci=ci)


# ---------------------------------------------------------------------------
# Built-in scenarios
# ---------------------------------------------------------------------------

def _base(days: float, seed: int, jobs_per_day: float, utilization: float,
          *, trace: str = "borg", tolerance: float = 0.5,
          ewif_table: str = "macknick",
          regions: Optional[Sequence] = None) -> ScenarioInstance:
    tele = telemetry.generate(days=max(int(np.ceil(days)) + 1, 2), seed=seed,
                              ewif_table=ewif_table,
                              regions=regions or tuple(telemetry.REGIONS))
    if trace == "borg":
        jobs = borg_trace(days=days, seed=seed, tolerance=tolerance,
                          num_regions=tele.num_regions,
                          target_jobs_per_day=jobs_per_day)
    else:
        # Alibaba keeps its 8.5× burst shape; the multiplier rescales the
        # absolute rate to the requested jobs/day.
        mult = jobs_per_day / (8.5 * 23000.0)
        jobs = alibaba_trace(days=days, seed=seed, tolerance=tolerance,
                             num_regions=tele.num_regions,
                             rate_multiplier=mult)
    cap = scale_capacity_for_utilization(jobs, days, tele.num_regions,
                                         utilization)
    return ScenarioInstance(name="nominal", tele=tele, jobs=jobs,
                            capacity=cap)


@register("nominal", "Borg-like steady trace, unperturbed telemetry")
def _nominal(days, seed, jobs_per_day, utilization, **kw):
    return _base(days, seed, jobs_per_day, utilization, **kw)


@register("diurnal",
          "alias of 'nominal': Borg-like diurnally modulated steady trace, "
          "unperturbed telemetry (the sharding examples' canonical cell)")
def _diurnal(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    return dataclasses.replace(inst, name="diurnal")


@register("drought-summer",
          "Heatwave + drought: cooling WUE +45%, scarcity factors elevated")
def _drought(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    tele = raise_wsf(scale_wue(inst.tele, 1.45), gain=1.4, floor=0.1)
    return dataclasses.replace(inst, name="drought-summer", tele=tele)


@register("decarbonization",
          "Grid-decarbonization event: dirtiest two grids ramp CI to 0.55x "
          "from 40% of the horizon")
def _decarb(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    dirty = list(np.argsort(inst.tele.ci.mean(axis=0))[-2:])
    tele = decarbonize(inst.tele, dirty, horizon_hours=days * 24.0)
    return dataclasses.replace(inst, name="decarbonization", tele=tele)


@register("capacity-loss",
          "Region outage: the greenest region loses all of its servers for "
          "the middle ~15% of the horizon")
def _outage(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    green = int(np.argmin(inst.tele.ci.mean(axis=0)))
    degraded = inst.capacity.copy()
    degraded[green] = 0
    t0, t1 = 0.40 * days * DAY, 0.55 * days * DAY
    events = [(t0, degraded), (t1, inst.capacity.copy())]
    return dataclasses.replace(inst, name="capacity-loss",
                               capacity_events=events)


@register("burst-storm",
          "Alibaba-style burst storm: bursty short-job trace at 25% target "
          "utilization")
def _burst(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, max(utilization, 0.25),
                 trace="alibaba", **kw)
    return dataclasses.replace(inst, name="burst-storm")


@register("water-stress-weighted",
          "Wu et al. accounting: identical physics, but reported water is "
          "weighted by regional scarcity")
def _stress_weighted(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    # Liters weighted by (1 + WSF)^2 relative to fleet mean: water spent in
    # Madrid/Mumbai counts for more than water spent in Zurich.
    w = (1.0 + inst.tele.wsf) ** 2
    w = w / w.mean()
    return dataclasses.replace(inst, name="water-stress-weighted",
                               water_weight=w)


@register("forecast-error",
          "Nominal physics, but forecast-driven schedulers see a +30% biased "
          "and 15%-noisy forecast (systematic over-prediction)")
def _forecast_error(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    return dataclasses.replace(inst, name="forecast-error",
                               forecast_bias=1.30, forecast_noise=0.15)


def heat_derate_events(tele: telemetry.Telemetry, days: float,
                       frac: float = 0.7, wb_quantile: float = 0.85
                       ) -> List[Tuple[float, object]]:
    """Capacity events derived from the telemetry's wet-bulb extremes.

    The fleet-mean wet-bulb series (``Telemetry.wb_c`` — the raw weather;
    WUE itself clips at its physical floor and hides the extremes) locates
    the heat peak: the longest contiguous run of hours above the
    ``wb_quantile`` quantile becomes a relative derate. Regions whose own
    wet-bulb during that window exceeds their horizon median are scaled to
    ``frac`` of base capacity (cooling-limited); the rest keep full
    capacity — no fixed outage window, no absolute vectors.
    """
    wb = tele.wb_c if tele.wb_c is not None else tele.wue
    H = max(int(days * 24), 1)
    fleet = wb[:H].mean(axis=1)
    thresh = np.quantile(fleet, wb_quantile)
    hot = fleet >= thresh
    if not hot.any() or hot.all():
        return []
    # Longest contiguous hot run.
    best, cur, best_span = 0, 0, (0, 0)
    for h, flag in enumerate(hot):
        if flag:
            cur += 1
            if cur > best:
                best, best_span = cur, (h - cur + 1, h + 1)
        else:
            cur = 0
    h0, h1 = best_span
    med = np.median(wb[:H], axis=0)
    peak_wb = wb[h0:h1].mean(axis=0)
    fracs = np.where(peak_wb > med, frac, 1.0)
    return [(h0 * 3600.0, ("scale", fracs)),
            (h1 * 3600.0, ("scale", np.ones(tele.num_regions)))]


@register("heat-derate",
          "Wet-bulb-extreme derate: during the hottest contiguous hours, "
          "cooling-limited regions drop to 70% capacity (relative profile "
          "derived from telemetry, not fixed fractions)")
def _heat_derate(days, seed, jobs_per_day, utilization, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    events = heat_derate_events(inst.tele, days)
    return dataclasses.replace(inst, name="heat-derate",
                               capacity_events=events)


@register("regime-shift",
          "Telemetry regime shift: mid-trace step change flips the CI "
          "ranking (cleanest grid x2.2, dirtiest /2.2) and raises the "
          "shifted region's WUE — commit-at-admission plans go stale, "
          "receding-horizon re-planning wins")
def _regime_shift(days, seed, jobs_per_day, utilization, *,
                  onset_frac: float = 0.5, ci_flip: float = 2.2,
                  wue_step: float = 1.35, **kw):
    inst = _base(days, seed, jobs_per_day, utilization, **kw)
    tele = inst.tele
    onset = int(days * 24.0 * onset_frac)
    # The step persists through the simulated horizon (plus the pricing
    # lookahead) but NOT through the rest of the telemetry array: warm-start
    # forecaster archives are the array's cyclic extension, so a step that
    # ran to the end of the array would dominate the wrapped history and the
    # forecaster would "know" the shift before it happens — exactly the
    # staleness this scenario exists to create. Keeping the tail unshifted
    # keeps the shift unforecastable.
    end = min(int(np.ceil(days * 24.0)) + 8, tele.num_hours)
    green = int(np.argmin(tele.ci.mean(axis=0)))
    dirty = int(np.argmax(tele.ci.mean(axis=0)))
    ci = tele.ci.copy()
    wue = tele.wue.copy()
    ci[onset:end, green] *= ci_flip
    ci[onset:end, dirty] /= ci_flip
    wue[onset:end, green] *= wue_step
    # Telemetry memoizes cumulative integrals (_cum_cache) — never mutate
    # in place; replace() builds a fresh instance with fresh caches.
    tele = dataclasses.replace(tele, ci=ci, wue=wue)
    return dataclasses.replace(inst, name="regime-shift", tele=tele)


# Average tasks per workflow under ``workflows.generators.TEMPLATES``
# (chain/fanout/diamond/montage mix) — converts the shared ``jobs_per_day``
# cell param (which counts *tasks*, like every other scenario) into the
# generator's workflow arrival rate.
_TASKS_PER_WORKFLOW = 6.7


def _workflow_base(days, seed, jobs_per_day, utilization, *,
                   tolerance: float = 0.5, ewif_table: str = "macknick",
                   burst: float = 0.0, name: str = "workflow-diurnal"
                   ) -> ScenarioInstance:
    from repro_torch.workflows import generators
    tele = telemetry.generate(days=max(int(np.ceil(days)) + 1, 2), seed=seed,
                              ewif_table=ewif_table)
    jobs = generators.workflow_trace(
        days=days, seed=seed, num_regions=tele.num_regions,
        tolerance=tolerance,
        workflows_per_day=jobs_per_day / _TASKS_PER_WORKFLOW, burst=burst)
    cap = scale_capacity_for_utilization(jobs, days, tele.num_regions,
                                         utilization)
    return ScenarioInstance(name=name, tele=tele, jobs=jobs, capacity=cap)


@register("workflow-diurnal",
          "Precedence-constrained DAG trace (chain/fan-out/diamond/Montage "
          "mix) with diurnal arrivals; jobs_per_day counts tasks")
def _workflow_diurnal(days, seed, jobs_per_day, utilization, *,
                      tolerance: float = 0.5, ewif_table: str = "macknick"):
    return _workflow_base(days, seed, jobs_per_day, utilization,
                          tolerance=tolerance, ewif_table=ewif_table,
                          name="workflow-diurnal")


@register("workflow-burst",
          "DAG trace with burst-train arrivals (Alibaba-like hot windows): "
          "whole workflows co-arrive, stressing precedence release under "
          "queue pressure")
def _workflow_burst(days, seed, jobs_per_day, utilization, *,
                    tolerance: float = 0.5, ewif_table: str = "macknick",
                    burst: float = 0.5):
    return _workflow_base(days, seed, jobs_per_day, utilization,
                          tolerance=tolerance, ewif_table=ewif_table,
                          burst=burst, name="workflow-burst")


def register_csv_scenario(name: str, path: str, *,
                          column_map: Optional[Dict] = None,
                          unit_scale: Optional[Dict] = None,
                          description: str = "") -> Scenario:
    """Register a scenario whose trace is a real CSV slice.

    The builder drops cell-for-cell into the sweep: the CSV replaces the
    synthetic generator (column mapping + deterministic arrival-rate
    thinning to the cell's ``jobs_per_day``), while telemetry, capacity
    scaling, and accounting views stay identical to ``nominal``. Home
    regions are folded modulo the region count.
    """
    from repro_torch.sim.trace import load_csv, rescale_arrival_rate

    def build(days, seed, jobs_per_day, utilization, *, tolerance=0.5):
        tele = telemetry.generate(days=max(int(np.ceil(days)) + 1, 2),
                                  seed=seed)
        jobs = load_csv(path, tolerance=tolerance, column_map=column_map,
                        unit_scale=unit_scale)
        jobs = [j for j in jobs if j.submit_time_s < days * DAY]
        for j in jobs:
            j.home_region = j.home_region % tele.num_regions
        jobs = rescale_arrival_rate(jobs, days, jobs_per_day, seed=seed)
        for i, j in enumerate(jobs):
            j.job_id = i
        cap = scale_capacity_for_utilization(jobs, days, tele.num_regions,
                                             utilization)
        return ScenarioInstance(name=name, tele=tele, jobs=jobs,
                                capacity=cap)

    register(name, description or f"real trace from {path}")(build)
    return _REGISTRY[name]


# ---------------------------------------------------------------------------
# Sweep runner — thin shims over the declarative experiment API
# ---------------------------------------------------------------------------
# The cell/sweep machinery lives in ``repro_torch.experiments`` now: scenarios are
# addressed by ScenarioSpec strings ("diurnal[days=10,jobs_per_day=1e6]"),
# grids by ExperimentPlan, and execution by interchangeable backends
# (serial / process / sharded). These shims keep the established kwargs
# surface working and produce identical rows.


def run_cell(scenario: str, scheduler, *, days: float = 0.2,
             seed: int = 0, jobs_per_day: float = 23000.0,
             utilization: float = 0.15, window_s: float = 30.0,
             tolerance: Optional[float] = None,
             sched_kwargs: Optional[Dict] = None,
             build_kwargs: Optional[Dict] = None,
             return_result: bool = False, device=None) -> Dict:
    """Build one scenario instance, run one scheduler through it, and return
    a tidy result row (shim over ``repro_torch.experiments.run_cell``).

    ``scheduler`` is a policy spec — a ``repro_torch.policy.PolicySpec`` or its
    string form (``"waterwise[lam_h2o=0.7,backend=torch]"``). ``sched_kwargs``
    are merged into the spec as validated overrides: unknown or ill-typed
    params raise with a did-you-mean message for *every* policy (nothing is
    silently dropped). The row's ``spec`` column is the fully resolved spec
    string and its ``scenario_spec`` column the fully resolved scenario
    spec — re-parsing either reproduces the cell exactly.

    ``tolerance`` overrides the builders' default delay tolerance and
    ``build_kwargs`` forwards further builder kwargs: spec-expressible ones
    (``trace``, ``ewif_table``, ...) fold into the scenario spec; the rest
    (``regions`` objects) stay in-process extras. ``return_result=True``
    attaches the raw engine result dict as ``row["_result"]`` (in-process
    use only; never serialized into sweep CSVs). ``device`` is where the
    policy runs (None: the CUDA card).
    """
    from repro_torch import experiments, policy

    spec = policy.as_spec(scheduler)
    if sched_kwargs:
        spec = spec.with_params(**sched_kwargs)
    params = dict(days=days, seed=seed, jobs_per_day=jobs_per_day,
                  utilization=utilization, window_s=window_s)
    if tolerance is not None:
        params["tolerance"] = tolerance
    from repro_torch.spec import SPEC_TYPES
    schema = experiments.scenario_schema(scenario)
    extra = {}
    for k, v in (build_kwargs or {}).items():
        if k in schema and k not in params and type(v) in SPEC_TYPES:
            params[k] = v
        else:
            extra[k] = v
    cell = experiments.Cell(
        experiments.make_scenario_spec(scenario, **params), spec)
    return experiments.run_cell(cell, extra_build_kwargs=extra or None,
                                return_result=return_result, device=device)


def sweep(schedulers: Sequence, scenarios: Optional[Sequence[str]] = None,
          *, days: float = 0.2, seed: int = 0,
          jobs_per_day: float = 23000.0, utilization: float = 0.15,
          window_s: float = 30.0, tolerance: Optional[float] = None,
          sched_kwargs: Optional[Dict] = None,
          max_workers: Optional[int] = None,
          executor: Optional[str] = None, device=None) -> List[Dict]:
    """Run the schedulers × scenarios cross product; one tidy row per cell
    (shim over ``repro_torch.experiments.ExperimentPlan``).

    ``schedulers`` are policy specs and ``scenarios`` scenario names —
    validated up front so a typo'd name or param fails before any cell
    runs. ``executor`` picks the backend (``"serial"``, ``"process"``,
    ``"sharded[shards=4]"``); by default cells fan out over worker
    processes capped at ``max_workers`` (default ``min(cpu_count,
    cells)``, and at most ``experiments.executor.CARD_WORKERS`` on the
    card; serial and parallel sweeps
    produce identical rows). Within each scenario, savings percentages are
    attached relative to the ``baseline`` scheduler when it is part of the
    sweep.

    A crashed cell no longer aborts the sweep: every other cell finishes,
    the failed cell's row records the failure in its ``error`` column, and
    a ``repro_torch.experiments.CellError`` naming the failing (scenario, spec)
    pair is raised at the end with all rows attached as ``err.rows``.

    ``device`` is where the policies run (None: the CUDA card); it travels
    beside the cells to every worker.
    """
    from repro_torch import experiments, policy
    from repro_torch.experiments.executor import auto_workers

    names = list(scenarios) if scenarios is not None else list_scenarios()
    specs = []
    for s in schedulers:
        sp = policy.as_spec(s)                       # fail fast on typos
        if sched_kwargs:
            sp = sp.with_params(**sched_kwargs)
        specs.append(sp)
    params = dict(days=days, seed=seed, jobs_per_day=jobs_per_day,
                  utilization=utilization, window_s=window_s)
    if tolerance is not None:
        params["tolerance"] = tolerance
    scen_specs = [experiments.make_scenario_spec(n, **params) for n in names]
    plan = experiments.ExperimentPlan(tuple(scen_specs), tuple(specs))
    n_cells = len(scen_specs) * len(specs)
    if executor is None:
        if max_workers is None:
            max_workers = auto_workers(n_cells, device)
        executor = "process" if (max_workers > 1 and n_cells > 1) \
            else "serial"
    options = {}
    if executor.startswith("process") and max_workers is not None:
        options["max_workers"] = max_workers
    return plan.run(executor=executor, strict=True, device=device,
                    **options)


def to_table(rows: Sequence[Dict], cols: Optional[Sequence[str]] = None
             ) -> str:
    """Fixed-width tidy table (shim over ``repro_torch.experiments.to_table``)."""
    from repro_torch import experiments
    return experiments.to_table(rows, cols or experiments.TABLE_COLS)


def to_csv(rows: Sequence[Dict], path: str,
           cols: Optional[Sequence[str]] = None) -> None:
    """Write tidy rows as CSV (shim over ``repro_torch.experiments.to_csv``)."""
    from repro_torch import experiments
    experiments.to_csv(rows, path, cols or experiments.CSV_COLS)
