"""Declarative scenario specs: ``"diurnal[days=10,jobs_per_day=1e6]"``.

The experiment-side counterpart of ``repro_torch.policy``'s ``PolicySpec``: a
*scenario spec* names a registered scenario (``repro_torch.sim.scenarios``) plus
explicitly overridden, typed cell parameters — and round-trips through its
string form exactly (``parse_scenario(str(spec)) == spec``), so an
experiment cell is reproducible from a CSV row, a CLI flag, or a JSON plan
alone.

Two layers of parameters compose a scenario spec's schema:

* **cell params** (``CELL_PARAMS``) — shared by every scenario: the trace
  span (``days``), RNG ``seed``, arrival rate (``jobs_per_day``), capacity
  scaling target (``utilization``), and scheduling-round period
  (``window_s``). These were the positional-kwargs pile of the old
  ``run_cell(scenario, sched, days=..., seed=..., ...)`` surface.
* **builder params** — introspected per scenario from its builder
  signature (``Scenario.params``): ``tolerance``, ``trace``,
  ``ewif_table``, a CSV scenario's own knobs, ... Unknown or ill-typed
  keys fail fast with a did-you-mean, exactly like policy specs.

Builder arguments that cannot be expressed as spec text (e.g. ``regions``
— a list of region objects) remain available in-process through
``build_instance(..., extra_build_kwargs=...)`` and are never serialized.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from repro_torch.sim import scenarios
from repro_torch.spec import (Param, Spec, parse_raw, validate_params)

#: Cell-level parameters shared by every scenario (the former positional
#: kwargs of ``scenarios.run_cell``). ``window_s`` configures the engine,
#: the rest parameterize the builder's four positional arguments.
CELL_PARAMS: Dict[str, Param] = {p.name: p for p in (
    Param("days", float, 0.2, "simulated trace span (days)"),
    Param("seed", int, 0, "trace + telemetry RNG seed"),
    Param("jobs_per_day", float, 23000.0, "target arrival rate (jobs/day)"),
    Param("utilization", float, 0.15,
          "mean fleet utilization the capacity is scaled for"),
    Param("window_s", float, 30.0, "scheduling-round period (seconds)"),
)}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec(Spec):
    """A fully parameterized experiment cell's *environment* as data:
    registered scenario name + explicit typed cell/builder params."""

    def with_params(self, **overrides) -> "ScenarioSpec":
        """New spec with ``overrides`` replacing/adding params (validated)."""
        return make_scenario_spec(self.name, **{**self.params, **overrides})

    def with_defaults(self, **defaults) -> "ScenarioSpec":
        """New spec with ``defaults`` filled only where not already set."""
        return make_scenario_spec(self.name, **{**defaults, **self.params})

    def cell_kwargs(self) -> Dict[str, object]:
        """The five cell-level values, defaults filled in."""
        return {k: self.params.get(k, p.default)
                for k, p in CELL_PARAMS.items()}

    def build_kwargs(self) -> Dict[str, object]:
        """The builder-specific overrides (everything not cell-level)."""
        return {k: v for k, v in self.params.items() if k not in CELL_PARAMS}


SpecLike = Union[str, ScenarioSpec]


def scenario_schema(name: str) -> Dict[str, Param]:
    """Full param schema of one scenario: shared cell params + the
    builder's introspected params (raises with did-you-mean on unknown
    scenario names)."""
    return {**CELL_PARAMS, **scenarios.get_scenario(name).params}


def make_scenario_spec(name: str, **params) -> ScenarioSpec:
    """Validated, coerced ``ScenarioSpec`` (the registry-side constructor)."""
    return ScenarioSpec(name, validate_params(
        "scenario", name, scenario_schema(name), params))


def parse_scenario(text: SpecLike) -> ScenarioSpec:
    """Parse + validate a scenario spec string against the registry.

    Accepts an existing ``ScenarioSpec`` too (re-validated), so every
    consumer can take either form; bare names parse to all-default specs.
    """
    if isinstance(text, ScenarioSpec):
        return make_scenario_spec(text.name, **text.params)
    name, raw = parse_raw(text, kind="scenario")
    return make_scenario_spec(name, **raw)


as_scenario_spec = parse_scenario      # readability alias


def build_instance(spec: SpecLike,
                   extra_build_kwargs: Optional[Dict] = None
                   ) -> Tuple["scenarios.ScenarioInstance", Dict[str, object]]:
    """Materialize a scenario spec: ``(ScenarioInstance, cell_kwargs)``.

    ``extra_build_kwargs`` forwards builder arguments the grammar cannot
    express (``regions`` objects, ...); they are merged *over* the spec's
    builder params and never serialized (in-process figure studies only).
    """
    s = parse_scenario(spec)
    cell = s.cell_kwargs()
    build_kw = s.build_kwargs()
    build_kw.update(extra_build_kwargs or {})
    inst = scenarios.get_scenario(s.name).build(
        cell["days"], cell["seed"], cell["jobs_per_day"],
        cell["utilization"], **build_kw)
    return inst, cell


def describe_scenarios(markdown: bool = False) -> str:
    """Scenario-registry dump including the shared cell params (the
    ``--list-scenarios`` surface and the README scenario table source)."""
    shared = ", ".join(f"`{p.describe()}`" for p in CELL_PARAMS.values())
    if markdown:
        return (f"Shared cell parameters (every scenario): {shared}\n\n"
                + scenarios.describe(markdown=True))
    head = "shared cell params: " + ", ".join(
        p.describe() for p in CELL_PARAMS.values())
    return head + "\n\n" + scenarios.describe(markdown=False)
