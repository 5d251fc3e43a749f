"""Declarative experiment API: scenario specs, plans, executors (the port
of ``repro/experiments``).

The experiment-layer counterpart of ``repro_torch.policy``: *what to run*
is data, not kwargs. A ``ScenarioSpec`` names a registered scenario with
typed, validated cell parameters (``"diurnal[days=10,jobs_per_day=1e6]"``);
an ``ExperimentPlan`` is the (scenarios × policies × seeds) grid, JSON-
serializable; ONE ``Executor`` abstraction runs a plan's cells —
``serial`` or ``process`` (one spawned worker per cell). Both produce
identical tidy rows. The ``sharded`` and ``device`` executors are
registered under the reference's grammar but not ported yet (queue item
[5]), and neither is the sharding module.

Typical use::

    from repro_torch import experiments

    plan = experiments.ExperimentPlan.build(
        scenarios=["diurnal[days=10,jobs_per_day=1e5]", "drought-summer"],
        policies=["baseline", "waterwise[lam_h2o=0.7,backend=fused]"],
        seeds=[0, 1, 2])
    rows = plan.run(executor="process")    # the policies on the CUDA card
    print(experiments.to_table(rows))
    plan.save("plan.json")                 # reviewable, re-runnable artifact

``plan.run(..., device="cpu")`` runs the policies on the host instead.
Everything a spec cannot express (an unknown scenario, a typo'd or
ill-typed param) fails fast with a did-you-mean message, before any cell
runs. ``repro_torch.sim.scenarios.run_cell`` / ``sweep`` are thin shims
over this package.
"""
from repro_torch.experiments.executor import (Executor, ProcessExecutor,
                                              SerialExecutor, ShardedExecutor,
                                              describe_executors, executor_schema,
                                              get_executor, list_executors)
from repro_torch.experiments.plan import (CSV_COLS, TABLE_COLS, Cell,
                                          ExperimentPlan, aggregate_seeds,
                                          attach_savings, seed_group_key, t95,
                                          to_csv, to_table)
from repro_torch.experiments.runner import CellError, run_cell
from repro_torch.experiments.scenario import (CELL_PARAMS, ScenarioSpec,
                                              as_scenario_spec, build_instance,
                                              describe_scenarios,
                                              make_scenario_spec, parse_scenario,
                                              scenario_schema)

__all__ = [
    # scenario specs
    "ScenarioSpec", "parse_scenario", "as_scenario_spec",
    "make_scenario_spec", "scenario_schema", "build_instance",
    "describe_scenarios", "CELL_PARAMS",
    # plans
    "ExperimentPlan", "Cell", "attach_savings", "TABLE_COLS", "CSV_COLS",
    "to_table", "to_csv", "aggregate_seeds", "seed_group_key", "t95",
    # running
    "run_cell", "CellError",
    # executors
    "Executor", "SerialExecutor", "ProcessExecutor", "ShardedExecutor",
    "get_executor", "list_executors", "executor_schema",
    "describe_executors",
]
