"""Forecast-driven temporal shifting on the PyTorch port — the
counterpart of ``examples/forecast_shift.py``.

Runs one delay-tolerant Borg-like cell through the reactive ``waterwise``
controller, the Holt-Winters-driven ``waterwise-forecast`` planner, the
same planner on the *learned* RG-LRU forecaster
(``waterwise-forecast[forecaster=learned]`` — it trains on the warm-start
telemetry archive inside the pricer on the CUDA card, through the fused
RG-LRU kernels, then re-conditions on each hourly refit), and the
true-future ``waterwise-oracle`` upper bound — under nominal telemetry
and under the ``forecast-error`` regime (the planner's forecast is +30%
biased and 15% noisy while physics stay nominal). Prints the tidy table
with the forecast-accuracy and deferral-latency columns, then the
joint-cost summary:

  PYTHONPATH=src python examples_torch/forecast_shift.py              # ~2 min
  PYTHONPATH=src python examples_torch/forecast_shift.py --days 0.05  # CI smoke
  PYTHONPATH=src python examples_torch/forecast_shift.py --device cpu
"""
import argparse

from repro_torch.runtime import platform
from repro_torch.sim import scenarios

SCHEDULERS = ["waterwise", "waterwise-forecast",
              "waterwise-forecast[forecaster=learned]", "waterwise-oracle"]
SCENARIOS = ["nominal", "forecast-error"]
COLS = ("scenario", "scheduler", "jobs", "carbon_kg", "water_kl",
        "violation_pct", "forecast_mape", "mean_defer_s", "deferred_pct",
        "wall_s")


def sweep(days: float, tolerance: float, device) -> list:
    """The SCHEDULERS × SCENARIOS rows, scenario-major, policies on
    ``device``."""
    return scenarios.sweep(SCHEDULERS, SCENARIOS, days=days, seed=0,
                           tolerance=tolerance, device=device)


def summary(rows, log=print) -> None:
    """The tidy table, then each planner's joint cost against the
    reactive controller."""
    log(scenarios.to_table(rows, COLS))
    log("")
    for scen in SCENARIOS:
        # Rows arrive scenario-major in SCHEDULERS order.
        srows = [r for r in rows if r["scenario"] == scen]
        ww = srows[0]
        for spec, r in zip(SCHEDULERS[1:], srows[1:]):
            joint = 0.5 * (r["carbon_kg"] / ww["carbon_kg"]
                           + r["water_kl"] / ww["water_kl"])
            log(f"{scen:>16} {spec}: joint carbon+water cost "
                f"{100 * (1 - joint):+.2f}% vs reactive waterwise "
                f"({r['deferred_pct']:.1f}% of jobs time-shifted, "
                f"forecast MAPE {r['forecast_mape']:.1f}%)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=0.2)
    ap.add_argument("--tolerance", type=float, default=3.0,
                    help="delay tolerance (TOL x exec time of slack) — "
                         "temporal shifting needs slack to shift")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    dev = platform.device(args.device)
    summary(sweep(args.days, args.tolerance, dev))


if __name__ == "__main__":
    main()
