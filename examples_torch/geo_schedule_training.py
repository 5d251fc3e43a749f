"""WaterWise scheduling *of training jobs* on the PyTorch port — the
counterpart of ``examples/geo_schedule_training.py``, with the port's dry
run and the card's own power in place of the reference's TPU figures.

Each job is a training run of one assigned architecture; its energy is
derived from the port's dry-run roofline (dominant-term step time × the
card's power limit × the cell's devices × steps) and its migration cost
L[m,n] is its real sharded-checkpoint size over the WAN model. WaterWise
then places/moves jobs across the five regions exactly as it does for
PARSEC jobs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # the cells
    PYTHONPATH=src python examples_torch/geo_schedule_training.py
    PYTHONPATH=src python examples_torch/geo_schedule_training.py \\
        --device cpu --chip-w 700

On the card the power per device is its power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` reports it; on the
CPU it is ``--chip-w``.
"""
import argparse
import copy
import glob
import json
import os
import subprocess

import numpy as np

from repro_torch import policy
from repro_torch.core import telemetry
from repro_torch.core.problem import Job
from repro_torch.runtime import platform
from repro_torch.sim import Simulator, savings_vs, summarize

STEPS = 2000            # steps per training job
DRYRUN_DIR = os.path.join("results", "dryrun_torch")


def card_power() -> tuple:
    """(name, power limit in W) of the first card, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    name, watts = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(watts.strip().split()[0])


def load_cells(directory: str = DRYRUN_DIR) -> list:
    """The port's dry-run cells of train_4k on one pod under the baseline
    rules that ran (not skipped), by file name."""
    cells = []
    for p in sorted(glob.glob(os.path.join(
            directory, "*.train_4k.pod1.baseline.json"))):
        with open(p) as f:
            d = json.load(f)
        if not d.get("skipped"):
            cells.append(d)
    return cells


def job_from_dryrun(cell, job_id, home, submit_s, chip_w: float):
    """Energy/duration from the roofline terms over the cell's devices;
    package = checkpoint bytes (params + fp32 Adam moments)."""
    r = cell["roofline"]
    step_s = max(r["t_compute"], r["t_memory"], r["t_collective"])
    exec_s = step_s * STEPS
    energy_kwh = chip_w * cell["chips"] * exec_s / 3.6e6
    ckpt_bytes = cell["params"] * (2 + 4 + 4)          # bf16 + fp32 mu/nu
    return Job(job_id=job_id, home_region=home, submit_time_s=submit_s,
               exec_time_s=exec_s, energy_kwh=energy_kwh,
               package_bytes=ckpt_bytes, tolerance=0.5,
               arch=cell["arch"])


def make_jobs(cells, chip_w: float, n: int = 60) -> list:
    """``n`` training runs over 2 days, archs in turn, homes and submit
    times from seed 0."""
    rng = np.random.default_rng(0)
    jobs = []
    for i in range(n):
        cell = cells[i % len(cells)]
        jobs.append(job_from_dryrun(cell, i, int(rng.integers(0, 5)),
                                    float(rng.uniform(0, 2 * 86400)),
                                    chip_w))
    return jobs


def schedule(jobs, n_archs: int, device, log=print) -> dict:
    """``baseline`` and ``waterwise`` over 4 days of telemetry, 6 pods a
    region: {name: summary}, with the reference's lines."""
    tele = telemetry.generate(days=4, seed=0)
    cap = np.full(5, 6)                      # 6 pods per region
    log(f"{len(jobs)} training jobs ({n_archs} archs), "
        f"mean duration {np.mean([j.exec_time_s for j in jobs])/3600:.2f} h,"
        f" mean checkpoint "
        f"{np.mean([j.package_bytes for j in jobs])/1e9:.0f} GB\n")
    results = {}
    for name in ("baseline", "waterwise"):
        # Policy-spec strings build through the registry (repro_torch.policy).
        results[name] = summarize(Simulator(tele, cap).run(
            copy.deepcopy(jobs), policy.build(name, tele, device=device)))
    sv = savings_vs(results["baseline"], results["waterwise"])
    b, w = results["baseline"], results["waterwise"]
    log(f"baseline : {b['carbon_kg']:10.1f} kg CO2  {b['water_kl']:8.1f} kL")
    log(f"waterwise: {w['carbon_kg']:10.1f} kg CO2  {w['water_kl']:8.1f} kL"
        f"  (moved {w['moved_pct']:.0f}% of jobs)")
    log(f"savings  : carbon {sv['carbon_savings_pct']:.1f}%  "
        f"water {sv['water_savings_pct']:.1f}%  "
        f"(service ×{w['mean_service_ratio']:.3f}, "
        f"violations {w['violation_pct']:.2f}%)")
    return dict(results, savings=sv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    ap.add_argument("--chip-w", type=float, default=None,
                    help="power per device in W (the CPU path; on the "
                         "card its power limit is read)")
    args = ap.parse_args(argv)
    dev = platform.device(args.device)
    if dev.type == "cuda":
        name, chip_w = card_power()
        print(f"{name}: power limit {chip_w:.2f} W per device")
    elif args.chip_w is None:
        raise SystemExit("--chip-w is needed off the card")
    else:
        chip_w = args.chip_w
    cells = load_cells()
    if not cells:
        print("run `python -m repro_torch.launch.dryrun --all` first")
        return
    schedule(make_jobs(cells, chip_w), len(cells), dev)


if __name__ == "__main__":
    main()
