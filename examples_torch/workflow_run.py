"""Workflow (DAG) scheduling on the PyTorch port end to end in ~50 lines —
the counterpart of ``examples/workflow_run.py``.

Builds the ``workflow-diurnal`` cell — chain / fan-out / diamond /
Montage-like task graphs with critical-path-derived per-task deadlines —
and replays it through plain ``waterwise`` and the three-way
``waterwise-embodied`` controller. Prints per-policy totals including the
embodied-carbon accounting column, the workflow-deadline miss rate, and
the precedence-violation count (always zero: the engine releases a task
only when every predecessor has finished):

  PYTHONPATH=src python examples_torch/workflow_run.py               # ~30 s
  PYTHONPATH=src python examples_torch/workflow_run.py --days 0.05 --assert-clean
  PYTHONPATH=src python examples_torch/workflow_run.py --device cpu
"""
import argparse
import copy

from repro_torch import policy
from repro_torch.runtime import platform
from repro_torch.sim import metrics
from repro_torch.sim.engine import EventSimulator, SimConfig
from repro_torch.sim.scenarios import get_scenario
from repro_torch.workflows import precedence_violations, workflow_miss_rate

SCHEDULERS = ["waterwise", "waterwise-embodied[lam_embodied=0.35]"]


def run(days: float, seed: int, jobs_per_day: float, device,
        log=print) -> dict:
    """Each scheduler over the cell on ``device``: {spec: (summary,
    precedence violations, workflow miss rate, unfinished)}, with the
    reference's lines."""
    inst = get_scenario("workflow-diurnal").build(days, seed, jobs_per_day,
                                                  0.15)
    n_wf = len({j.workflow_id for j in inst.jobs
                if j.workflow_id is not None})
    log(f"workflow-diurnal: {len(inst.jobs)} tasks / {n_wf} workflows "
        f"({days} days, seed {seed})\n")
    out = {}
    for spec in SCHEDULERS:
        res = EventSimulator(inst.tele, inst.capacity, SimConfig()).run(
            copy.deepcopy(inst.jobs),
            policy.build(spec, inst.tele, device=device))
        s = metrics.summarize(res)
        viol = precedence_violations(res["records"])
        miss, _ = workflow_miss_rate(res["records"])
        log(f"{spec:>42}: operational {s['carbon_kg']:7.2f} kg  "
            f"embodied {s['embodied_kg']:6.2f} kg  "
            f"water {s['water_kl']:.3f} kL  "
            f"cpath_miss {100 * miss:.1f}%  "
            f"precedence_violations {viol}  "
            f"unfinished {res['unfinished']}")
        out[spec] = (s, viol, miss, res["unfinished"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jobs-per-day", type=float, default=6000.0)
    ap.add_argument("--assert-clean", action="store_true",
                    help="exit non-zero on any precedence violation or "
                         "unfinished task (CI smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    out = run(args.days, args.seed, args.jobs_per_day,
              platform.device(args.device))
    clean = all(viol == 0 and unfinished == 0
                for _, viol, _, unfinished in out.values())
    if args.assert_clean and not clean:
        raise SystemExit("assert-clean failed: precedence violation or "
                         "unfinished task")


if __name__ == "__main__":
    main()
