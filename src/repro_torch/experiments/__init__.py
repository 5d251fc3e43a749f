"""Declarative experiment API: scenario specs, plans, executors, sharded
execution (the port of ``repro/experiments``).

The experiment-layer counterpart of ``repro_torch.policy``: *what to run*
is data, not kwargs. A ``ScenarioSpec`` names a registered scenario with
typed, validated cell parameters (``"diurnal[days=10,jobs_per_day=1e6]"``);
an ``ExperimentPlan`` is the (scenarios × policies × seeds) grid, JSON-
serializable; ONE ``Executor`` abstraction runs a plan's cells on four
interchangeable backends — ``serial``, ``process`` (one spawned worker per
cell), ``sharded`` (one cell split by arrival time across spawned workers
with engine-state handoff and boundary stitching) and ``device`` (many
cells' fused solves batched over a cell axis into one kernel launch a
round wave). All produce identical tidy rows; carbon/water/violation
totals are bit-identical to the serial run by construction.

Typical use::

    from repro_torch import experiments

    plan = experiments.ExperimentPlan.build(
        scenarios=["diurnal[days=10,jobs_per_day=1e5]", "drought-summer"],
        policies=["baseline", "waterwise[lam_h2o=0.7,backend=fused]"],
        seeds=[0, 1, 2])
    rows = plan.run(executor="device")     # the policies on the CUDA card
    print(experiments.to_table(rows))
    plan.save("plan.json")                 # reviewable, re-runnable artifact

``plan.run(..., device="cpu")`` runs the policies on the host instead.
Everything a spec cannot express (an unknown scenario, a typo'd or
ill-typed param) fails fast with a did-you-mean message, before any cell
runs. ``repro_torch.sim.scenarios.run_cell`` / ``sweep`` are thin shims
over this package.
"""
from repro_torch.experiments.executor import (DeviceExecutor, Executor,
                                              ProcessExecutor, SerialExecutor,
                                              ShardedExecutor,
                                              describe_executors,
                                              executor_schema, get_executor,
                                              list_executors)
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
from repro_torch.experiments.shard import (auto_handoff_s,
                                           merge_forecast_stats,
                                           run_sharded_cell, states_match)

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
    "DeviceExecutor", "get_executor", "list_executors", "executor_schema",
    "describe_executors",
    # sharding
    "run_sharded_cell", "auto_handoff_s", "merge_forecast_stats",
    "states_match",
]
