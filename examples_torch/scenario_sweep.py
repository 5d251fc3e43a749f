"""Scenario sweep on the PyTorch port in ~40 lines: an ExperimentPlan ×
executor backends — the counterpart of ``examples/scenario_sweep.py``.

Runs a small Borg-like trace through three scheduling policies under three
regimes — nominal, a drought summer (elevated WUE + scarcity), and a full
outage of the greenest region — on the event-driven engine, then prints the
tidy results table. Everything is declarative data: schedulers are *policy
specs* (``waterwise[lam_h2o=0.7,backend=torch]``), regimes are *scenario
specs* (``diurnal[days=10,jobs_per_day=1e6,tolerance=0.5]``), the grid is
an ``ExperimentPlan`` (JSON-serializable), and the executor is one of three
interchangeable backends producing identical rows; the ``process`` and
``sharded`` executors spawn their workers, each on the run's device:

  PYTHONPATH=src python examples_torch/scenario_sweep.py
  PYTHONPATH=src python examples_torch/scenario_sweep.py \\
      --schedulers 'baseline,waterwise[lam_h2o=0.7,backend=flow]'
  PYTHONPATH=src python examples_torch/scenario_sweep.py \\
      --scenarios 'diurnal[jobs_per_day=46000.0]' --executor 'sharded[shards=2]'
  PYTHONPATH=src python examples_torch/scenario_sweep.py \\
      --scenarios 'workflow-diurnal,workflow-burst' \\
      --schedulers 'waterwise,waterwise-embodied[lam_embodied=0.35]'
      # precedence-constrained DAG traces (see examples_torch/workflow_run.py)
  PYTHONPATH=src python examples_torch/scenario_sweep.py --device cpu
"""
import argparse

from repro_torch import experiments, policy
from repro_torch.runtime import platform
from repro_torch.spec import split_specs

SCHEDULERS = "baseline,least-load,waterwise"
SCENARIOS = "nominal,drought-summer,capacity-loss"


def run(days: float, schedulers: str, scenarios: str, executor: str,
        seeds: str, device, log=print) -> list:
    """The plan's rows through ``executor`` on ``device``, printed as the
    reference prints them."""
    plan = experiments.ExperimentPlan.build(
        scenarios=[experiments.parse_scenario(s).with_defaults(days=days)
                   for s in split_specs(scenarios)],
        policies=split_specs(schedulers),
        seeds=[int(s) for s in seeds.split(",")] if seeds else None)
    rows = plan.run(executor=executor, device=device)
    log(experiments.to_table(rows))
    for row in rows:
        # Every row is reproducible from its spec columns alone.
        assert policy.parse(row["spec"])
        assert experiments.parse_scenario(row["scenario_spec"])
        if row["scheduler"] == "baseline" or "carbon_savings_pct" not in row:
            continue                         # savings need baseline in sweep
        log(f"{row['spec']} under {row['scenario_spec']}: "
            f"{row['carbon_savings_pct']:.1f}% carbon, "
            f"{row['water_savings_pct']:.1f}% water saved vs baseline")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=0.1)
    ap.add_argument("--schedulers", default=SCHEDULERS,
                    help="comma-separated policy specs (bracketed params OK)")
    ap.add_argument("--scenarios", default=SCENARIOS,
                    help="comma-separated scenario specs (bracketed params "
                         "OK; DAG cells: workflow-diurnal, workflow-burst)")
    ap.add_argument("--executor", default="process",
                    help="serial | process | sharded[shards=N] — all three "
                         "produce identical rows")
    ap.add_argument("--seeds", default="",
                    help="seed axis for multi-seed replication, e.g. '0,1,2'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    run(args.days, args.schedulers, args.scenarios, args.executor,
        args.seeds, platform.device(args.device))


if __name__ == "__main__":
    main()
