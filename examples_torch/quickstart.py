"""Quickstart: the WaterWise scheduler of the PyTorch port end-to-end in
~30 lines — the counterpart of ``examples/quickstart.py``.

Generates one day of per-region sustainability telemetry, replays two hours
of a Borg-like trace through the carbon+water co-optimizing controller, and
prints the savings against the carbon/water-unaware baseline. Schedulers
are declarative policy specs (``repro_torch.policy``), built for the
CUDA card (their host ``flow`` solver needs none, but the script runs
where the port's entry points run).

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse
import copy

from repro_torch import policy
from repro_torch.core import telemetry
from repro_torch.runtime import platform
from repro_torch.sim import Simulator, borg_trace, savings_vs, summarize
from repro_torch.sim.trace import scale_capacity_for_utilization

DAYS = 0.1
SCHEDULERS = ("baseline", "waterwise", "carbon-greedy-opt",
              "water-greedy-opt")


def compare(days: float, device, log=print) -> dict:
    """{scheduler: summary} over ``days`` of the trace, with the
    reference's lines."""
    tele = telemetry.generate(days=2, seed=0)
    jobs = borg_trace(days=days, seed=0, tolerance=0.5)
    capacity = scale_capacity_for_utilization(jobs, days, 5,
                                              utilization=0.15)
    log(f"{len(jobs)} jobs over {days * 24:.1f} h, "
        f"{capacity.sum()} servers in {tele.num_regions} regions\n")
    results = {}
    for name in SCHEDULERS:
        # Policy specs build through the registry (repro_torch.policy).
        results[name] = summarize(Simulator(tele, capacity).run(
            copy.deepcopy(jobs), policy.build(name, tele, device=device)))
    base = results["baseline"]
    log(f"{'scheduler':20s} {'carbon kg':>10s} {'water kL':>9s} "
        f"{'carbon sav':>10s} {'water sav':>9s} {'svc':>6s} {'viol%':>6s}")
    for name, s in results.items():
        sv = savings_vs(base, s)
        log(f"{name:20s} {s['carbon_kg']:10.1f} {s['water_kl']:9.2f} "
            f"{sv['carbon_savings_pct']:9.1f}% "
            f"{sv['water_savings_pct']:8.1f}% "
            f"{s['mean_service_ratio']:6.3f} {s['violation_pct']:6.2f}")
    log("\nNote the tension: the carbon oracle *hurts* water and vice versa;"
        "\nWaterWise lands near both oracles simultaneously (paper Fig 5).")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    compare(DAYS, platform.device(args.device))


if __name__ == "__main__":
    main()
