"""The always-on scheduler service of the PyTorch port: a Poisson-burst
arrival storm streamed through the bounded admission queue into the fused
warm-started ``waterwise-forecast`` pipeline on the CUDA card (one
``sinkhorn_anneal_adaptive`` launch a round), one decision round per
boundary, with the full service report (stream accounting, queue depths,
p50/p99 round latency, cold vs warm Sinkhorn iterations) at the end — the
counterpart of ``examples/serve_stream.py``.

  PYTHONPATH=src python examples_torch/serve_stream.py           # ~1 min
  PYTHONPATH=src python examples_torch/serve_stream.py --duration 30 \\
      --round-s 5 --assert-clean                                # CI smoke
  PYTHONPATH=src python examples_torch/serve_stream.py --device cpu

``--queue-bound 20`` makes the storm actually shed (accounted, never
silent — shed jobs are deadline misses in the report); ``--assert-clean``
exits non-zero unless the service finished with zero deadline misses and
non-empty round metrics.
"""
import argparse
import sys

import repro_torch.obs as obs
from repro_torch.core import telemetry
from repro_torch.policy.pipeline import forecast_pipeline
from repro_torch.runtime import platform
from repro_torch.serve import DecisionLoop, PoissonBurstArrivals, ServeConfig
from repro_torch.sim.engine import EventSimulator, SimConfig
from repro_torch.sim.trace import scale_capacity_for_utilization


def serve(duration: float, jobs_per_day: float, round_s: float,
          queue_bound: int, shed_policy: str, burst: float, seed: int,
          device, log=print) -> tuple:
    """Serve ``duration`` simulated seconds of the storm on ``device``:
    (ServeReport, the metrics registry of the run)."""
    tele = telemetry.generate(days=1, seed=0)
    rate = jobs_per_day / 86400.0
    src = PoissonBurstArrivals(rate, seed=seed,
                               num_regions=tele.num_regions, tolerance=4.0,
                               burst=burst, horizon_s=duration)
    probe = PoissonBurstArrivals(rate, seed=seed,
                                 num_regions=tele.num_regions, tolerance=4.0,
                                 burst=burst, horizon_s=duration)
    cap = scale_capacity_for_utilization(probe.poll(duration),
                                         duration / 86400.0,
                                         tele.num_regions, 0.15)
    ctl = forecast_pipeline(tele, forecaster="oracle", risk=0.0,
                            slot_s=1800.0, defer_eps=1e-4, backend="fused",
                            warm=True, device=device)
    loop = DecisionLoop(EventSimulator(tele, cap, SimConfig()), ctl, src,
                        ServeConfig(round_s=round_s, queue_bound=queue_bound,
                                    shed_policy=shed_policy))
    log(f"serving {duration:.0f}s of a {jobs_per_day:.0f} "
        f"jobs/day storm (burst={burst}, round={round_s:.0f}s, "
        f"queue bound {queue_bound}, {shed_policy})")
    with obs.capture(fold=False) as reg:
        rep = loop.run(duration)
    return rep, reg


def verdict(rep, reg, assert_clean: bool, log=print) -> int:
    """The report's lines and the exit code (the reference's rule)."""
    for k, v in sorted(rep.to_dict().items()):
        log(f"  {k:>22} = {v:.3f}" if isinstance(v, float)
            else f"  {k:>22} = {v}")
    rounds = reg.hists.get("serve.round_wall_ms")
    if rep.deadline_misses == 0 and rounds is not None and rounds.count > 0:
        log(f"OK: {rep.placed} jobs placed, zero deadline misses, "
            f"{rounds.count} instrumented rounds")
        return 0
    log(f"service finished with {rep.deadline_misses} deadline misses "
        f"({rep.shed} shed, {rep.violations} over tolerance)")
    return 1 if assert_clean else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=600.0,
                    help="simulated seconds to serve")
    ap.add_argument("--jobs-per-day", type=float, default=1e5)
    ap.add_argument("--round-s", type=float, default=30.0,
                    help="decision-round period (simulated seconds)")
    ap.add_argument("--queue-bound", type=int, default=10_000)
    ap.add_argument("--shed-policy", default="reject-new",
                    choices=["reject-new", "drop-oldest"])
    ap.add_argument("--burst", type=float, default=1.0,
                    help="burst-train amplitude (0 = plain diurnal Poisson)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--assert-clean", action="store_true",
                    help="exit 1 unless zero deadline misses and non-empty "
                         "round metrics (the CI smoke contract)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)
    dev = platform.device(args.device)
    rep, reg = serve(args.duration, args.jobs_per_day, args.round_s,
                     args.queue_bound, args.shed_policy, args.burst,
                     args.seed, dev)
    return verdict(rep, reg, args.assert_clean)


if __name__ == "__main__":
    sys.exit(main())
