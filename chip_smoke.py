"""Smoke run of the PyTorch port on one CUDA card (an H100).

Builds the port's kernels from the sources in this checkout, then:

  1. holds the Sinkhorn kernels against their plain PyTorch versions on the
     card, at the shapes the scheduling round gives them: one iteration
     (two launches) at each shape and eps, and the whole annealed solve in
     one launch, which must also equal the loop of 360 iterations bit for
     bit; times all of them;
  2. runs one fused round at storm scale (4095 jobs x 6 columns, bucket
     4096) through the annealed launch and through the plain loop on the
     card;
  3. drives the reactive WaterWise round end to end — ``EventSimulator`` +
     ``reactive_pipeline(backend="fused")`` — on a diurnal Borg-like cell
     of ~50k jobs (1M jobs/day for 0.05 days, 5 regions, 15% load), on the
     card and on the CPU, compares the two (one annealed launch per solve),
     times a round's Sinkhorn stage through the launch and through the
     iteration loop side by side, and holds the iteration kernel against
     its plain version at every row bucket the card run's solves spanned;
  4. holds the RG-LRU scan kernels (forward and backward) against their
     plain versions at the learned forecaster's shapes and times both;
  5. drives the forecast-driven round end to end — ``EventSimulator`` +
     ``forecast_pipeline(forecaster="learned", backend="fused")`` — on the
     same cell, on the card and on the CPU, compares the two, checks the
     kernels' launch counts, and runs ``forecaster="holtwinters"`` on the
     card once;
  6. holds the flash-attention kernels (bf16 D 64/128 on wgmma tensor
     cores; float32 and D 16/256 on the scalar kernel) and the SSD-scan
     kernel against their plain versions on the card (the reference kernel
     tests' shapes, GQA, ragged lengths, and the qwen2-1.5B and mamba2-2.7B
     prefill shapes) and times them beside the plain versions, their bounds
     and, for attention, ``scaled_dot_product_attention``;
  7. serves qwen2-1.5B and mamba2-2.7B at full width and depth 2 in
     float32 through ``Server.generate`` on the card and on the CPU (the
     same weights) and compares logits and tokens;
  8. serves both at full depth in bf16 on the card (B 4, prompt 2048, 32
     new tokens), reports prefill tokens/s, decode ms per step and peak
     memory, and checks that each prefill launched one kernel per layer
     (qwen2-1.5B: the wgmma flash kernel, never the scalar one) and never
     the plain versions.

The LM weights are random, drawn from a seed; the Mamba-2 mixers' conv and
SSM scalars are drawn live (``models.ssm.draw_live_mixer``), since the
reference's zero conv would feed the SSD exact zeros.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import collections
import contextlib
import copy
import glob
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 outside the
# tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Kernel vs plain version on the card: both float32, reductions in another
# order and expf/logf from another library.
KERNEL_ATOL = 1e-4
# Padding rows carry f ~ eps * _NEG (~ -5e6 at eps = 0.005), where a float32
# ulp is ~0.3: held to a relative bound instead.
PAD_RTOL = 1e-6
# End to end, card (kernel order) vs CPU (XLA order): near-ties may round
# differently, so totals are compared, not records.
E2E_RTOL = 5e-3
# RG-LRU scan, kernel vs plain version on the card: the kernel's step is one
# fmaf where the plain version multiplies and adds (two roundings); the
# reference's own kernel test holds its scan to the same 1e-4.
SCAN_ATOL = 1e-4
# The first fit's q50 forecast, card vs CPU (original units, relative):
# 300 float32 AdamW steps through cuBLAS and the kernels against the CPU's
# BLAS and plain loops, then a 15-column inference pass.
Q50_RTOL = 1e-2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, warmup: int = 20, reps: int = 200) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled_device_ms(fn, reps: int = 50):
    """Device time of ``fn()`` in ms from the profiler: the sum of the
    kernels' own device time over ``reps`` calls, per call. None when the
    profiler reports no device time (then it was not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA"))
    return total_us / reps / 1e3 if total_us > 0 else None


def main_path_inputs(M: int, N: int, eps: float, dev, seed: int):
    """(C, g, log_a, log_b) as a round of bucket M feeds the iteration:
    normalized costs with forbidden arcs priced at BIG, a dummy slack row,
    zero-mass padding rows (log_a = _NEG), and g after a few iterations."""
    from repro_torch.core import round as port_round
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref
    rng = np.random.default_rng(seed)
    jobs = max(1, (3 * M) // 4 - 1)
    pad = M - 1 - jobs
    cost = rng.random((jobs, N)) * 10
    allowed = rng.random((jobs, N)) > 0.2
    allowed[np.arange(jobs), rng.integers(0, N, jobs)] = True
    cap = np.full(N, jobs // N + 2, np.float32)
    c_eff = np.pad(cost, ((0, pad), (0, 0))).astype(np.float32)
    mask = np.pad(allowed, ((0, pad), (0, 0)))
    valid = np.arange(M - 1) < jobs
    C, log_a, log_b, _, _ = port_round._prepare_device(
        torch.from_numpy(c_eff).to(dev), torch.from_numpy(mask).to(dev),
        torch.from_numpy(cap).to(dev), torch.from_numpy(valid).to(dev))
    g = torch.zeros(N, dtype=torch.float32, device=dev)
    f = torch.zeros(M, dtype=torch.float32, device=dev)
    for _ in range(3):
        f, g = sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps)
    return C.contiguous(), g, log_a.contiguous(), log_b.contiguous()


def f_error(f_k, f_r, log_a) -> float:
    """max |df| over rows with mass; padding rows are checked relatively."""
    from repro_torch.core.solvers.torch_solver import _NEG
    live = log_a > _NEG / 2
    pad_ok = bool(((f_k - f_r).abs()[~live]
                   <= PAD_RTOL * f_r.abs()[~live]).all())
    if not pad_ok:
        fail("padding-row f disagrees beyond relative 1e-6")
    return (f_k - f_r).abs()[live].max().item()


def tree_sha256() -> str:
    """sha256 over this script and the port's sources (path, then bytes, in
    path order): names the tree a run's numbers came from."""
    paths = [os.path.join(HERE, "chip_smoke.py")] + sorted(
        p for ext in ("py", "cu")
        for p in glob.glob(os.path.join(HERE, "src", "repro_torch", "**",
                                        f"*.{ext}"), recursive=True))
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.relpath(p, HERE).encode() + b"\0")
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def schedule_eps() -> list:
    """The eps of every stage of the fused round's annealed schedule."""
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn.ops import anneal_schedule
    return anneal_schedule(torch_solver.SINKHORN_EPS0, 0.005,
                           torch_solver.SINKHORN_STAGES)


def hold(M: int, N: int, eps: float, seed: int) -> float:
    """Kernel vs plain version at (M, N, eps) on main-path inputs; fails
    beyond KERNEL_ATOL, else returns max(|df|, |dg|)."""
    from repro_torch.kernels.sinkhorn import ops
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref
    C, g, log_a, log_b = main_path_inputs(M, N, eps, torch.device("cuda"),
                                          seed=seed)
    f_k, g_k = ops.sinkhorn_iteration(C, None, g, log_a, log_b, eps)
    f_r, g_r = sinkhorn_iteration_ref(C, None, g, log_a, log_b, eps)
    torch.cuda.synchronize()
    df = f_error(f_k, f_r, log_a)
    dg = (g_k - g_r).abs().max().item()
    if not (np.isfinite(df) and np.isfinite(dg)):
        fail(f"non-finite result at M={M} N={N} eps={eps}")
    print(f"  M={M:6d} N={N:3d} eps={eps:<8.5g} max|df|={df:.3e} "
          f"max|dg|={dg:.3e}", flush=True)
    if df > KERNEL_ATOL or dg > KERNEL_ATOL:
        fail(f"kernel disagrees with plain version at M={M} N={N} "
             f"eps={eps}: {df:.3e} / {dg:.3e}")
    return max(df, dg)


def fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def iteration_loop(C, log_a, log_b, table, iters):
    """The annealed schedule as the per-iteration kernel runs it: 2 launches
    an iteration (the yardstick of the one-launch solve, off the main
    path)."""
    from repro_torch.kernels.sinkhorn import sinkhorn
    f = torch.zeros(C.shape[0], dtype=torch.float32, device=C.device)
    g = torch.zeros(C.shape[1], dtype=torch.float32, device=C.device)
    for eps in table:
        for _ in range(iters):
            f, g = sinkhorn.sinkhorn_iteration_cuda(C, g, log_a, log_b, eps)
    return f, g


def solve_schedule():
    """(eps table, iterations a stage) of the fused round's solve."""
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn.ops import eps_table
    return (eps_table(torch_solver.SINKHORN_EPS0, 0.005,
                      torch_solver.SINKHORN_STAGES),
            torch_solver.SINKHORN_ITERS)


def hold_anneal(M: int, N: int, seed: int) -> float:
    """The one-launch annealed solve at (M, N) on main-path inputs against
    the per-iteration kernel's loop (bitwise: max |d| must be 0) and
    against the plain loop (KERNEL_ATOL; padding rows relative). Returns
    max(|df|, |dg|) against the plain loop."""
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_ref
    C, _, log_a, log_b = main_path_inputs(M, N, 0.5, torch.device("cuda"),
                                          seed=seed)
    table, iters = solve_schedule()
    f_a, g_a = sinkhorn.sinkhorn_solve_cuda(C, log_a, log_b, table, iters)
    f_l, g_l = iteration_loop(C, log_a, log_b, table, iters)
    f_r, g_r = sinkhorn_solve_ref(C, log_a, log_b, table, iters)
    torch.cuda.synchronize()
    bitwise = max((f_a - f_l).abs().max().item(),
                  (g_a - g_l).abs().max().item())
    same = torch.equal(f_a, f_l) and torch.equal(g_a, g_l)
    df = f_error(f_a, f_r, log_a)
    dg = (g_a - g_r).abs().max().item()
    print(f"  anneal M={M:6d} N={N:3d}: vs iteration loop max|d|="
          f"{bitwise:.3e} (bitwise equal: {same}); vs plain max|df|="
          f"{df:.3e} max|dg|={dg:.3e}", flush=True)
    if not same:
        fail(f"annealed launch differs from the iteration loop at M={M} "
             f"N={N}: {bitwise:.3e}")
    if not (np.isfinite(df) and np.isfinite(dg)) or max(df, dg) > \
            KERNEL_ATOL:
        fail(f"annealed launch disagrees with the plain loop at M={M} "
             f"N={N}: {df:.3e} / {dg:.3e}")
    return max(df, dg)


def phase_kernel(dev) -> dict:
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.sinkhorn.ref import (sinkhorn_iteration_ref,
                                                  sinkhorn_solve_ref)
    print("== phase 1: Sinkhorn kernels vs plain versions on the card",
          flush=True)
    worst = 0.0
    for M in (4, 128, 512, 4096, 16384):
        for N in (6, 41):
            for eps in (0.5, 0.005):
                worst = max(worst, hold(M, N, eps, seed=M + N))
    # The temporal grid of the forecast round: 5 regions x 8 slots.
    for M in (512, 4096):
        for eps in schedule_eps():
            worst = max(worst, hold(M, 40, eps, seed=M + 40))
    timings = {}
    # The largest bucket, phase 2's bucket, the bucket most rounds of
    # phase 3 fall into, and that bucket on phase 5's temporal grid.
    for M, N in ((16384, 6), (4096, 6), (512, 6), (512, 40)):
        eps = 0.005
        C, g, log_a, log_b = main_path_inputs(M, N, eps, dev, seed=7)
        def kernel():
            return sinkhorn.sinkhorn_iteration_cuda(C, g, log_a, log_b, eps)

        def plain():
            return sinkhorn_iteration_ref(C, None, g, log_a, log_b, eps)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        device_ms = profiled_device_ms(kernel)
        plain_device_ms = profiled_device_ms(plain)
        # Least device time: each input read once, each output written once
        # (C, g, log_a, log_b in; f, g out), or ~12 float32 operations per
        # element (row and column pass: subtract, divide, max, subtract,
        # exp, add), whichever is larger.
        nbytes = 4 * (M * N + N + M + N + M + N)
        ops_count = 12 * M * N
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_count / FP32_OPS_PER_S * 1e3
        timings[(M, N)] = dict(ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                               plain_device_ms=plain_device_ms,
                               bound_ms=max(bytes_ms, ops_ms),
                               bound_by="bytes" if bytes_ms >= ops_ms
                               else "operations")
        print(f"  timing M={M} N={N}: kernel {ms * 1e3:.2f} us/iteration "
              f"({sinkhorn.LAUNCHES_PER_ITERATION} launches; device "
              f"{fmt_us(device_ms)}), plain {plain_ms * 1e3:.2f} us "
              f"(device {fmt_us(plain_device_ms)}), bound "
              f"{bytes_ms * 1e3:.4f} us (bytes) / {ops_ms * 1e3:.4f} us "
              f"(operations)", flush=True)

    # The annealed solve in one launch, at every shape of the grid above.
    anneal_worst = 0.0
    for M in (4, 128, 512, 4096, 16384):
        for N in (6, 41):
            anneal_worst = max(anneal_worst, hold_anneal(M, N, seed=M + N))
    for M in (512, 4096):
        anneal_worst = max(anneal_worst, hold_anneal(M, 40, seed=M + 40))
    table, iters = solve_schedule()
    n_iter = len(table) * iters
    anneal_t = {}
    for M, N in ((16384, 6), (4096, 6), (512, 6), (512, 40)):
        C, _, log_a, log_b = main_path_inputs(M, N, 0.5, dev, seed=7)

        def kernel():
            return sinkhorn.sinkhorn_solve_cuda(C, log_a, log_b, table, iters)

        def loop():
            return iteration_loop(C, log_a, log_b, table, iters)

        def plain():
            return sinkhorn_solve_ref(C, log_a, log_b, table, iters)
        t = dict(ms=cuda_ms(kernel, warmup=3, reps=20),
                 device_ms=profiled_device_ms(kernel, reps=5),
                 loop_ms=cuda_ms(loop, warmup=1, reps=3),
                 plain_ms=cuda_ms(plain, warmup=1, reps=2),
                 # C, log_a, log_b read once, f and g written once; ~12
                 # float32 operations per element per iteration.
                 **bound(4 * (M * N + M + N + M + N), 12 * M * N * n_iter))
        anneal_t[(M, N)] = t
        print(f"  timing anneal M={M} N={N}: one launch {t['ms'] * 1e3:.2f} "
              f"us/solve (device {fmt_us(t['device_ms'])}), iteration loop "
              f"{t['loop_ms'] * 1e3:.2f} us/solve ({n_iter} iterations x "
              f"{sinkhorn.LAUNCHES_PER_ITERATION} launches), plain "
              f"{t['plain_ms'] * 1e3:.2f} us/solve, bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bound_by']})", flush=True)
    return dict(max_abs_err=worst, timings=timings,
                anneal_max_abs_err=anneal_worst, anneal_timings=anneal_t)


@contextlib.contextmanager
def plain_solve():
    """Run the fused round's kernel-order solve with the plain loop in place
    of the annealed launch (the comparison run of phase 2)."""
    from repro_torch.core import round as port_round
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_ref
    saved = port_round.sinkhorn_solve
    port_round.sinkhorn_solve = sinkhorn_solve_ref
    try:
        yield
    finally:
        port_round.sinkhorn_solve = saved


def phase_round(dev) -> None:
    from repro_torch.core import round as port_round
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn import sinkhorn
    print("== phase 2: one fused round at storm scale (4095 x 6, bucket "
          "4096)", flush=True)
    rng = np.random.default_rng(11)
    M, N = 4095, 6
    cost = rng.random((M, N)) * 10
    allowed = rng.random((M, N)) > 0.2
    allowed[np.arange(M), rng.integers(0, N, M)] = True
    cap = np.full(N, (M + N) // N + 1)

    def counts():
        return (sinkhorn.ANNEAL_LAUNCHES, sinkhorn.LAUNCHES)
    before = counts()
    t0 = time.perf_counter()
    r_k = port_round.fused_solve(cost, allowed, cap, sinkhorn_impl="kernel",
                                 device=dev)
    t_k = time.perf_counter() - t0
    launched = tuple(a - b for a, b in zip(counts(), before))
    with plain_solve():
        t0 = time.perf_counter()
        r_p = port_round.fused_solve(cost, allowed, cap,
                                     sinkhorn_impl="kernel", device=dev)
        t_p = time.perf_counter() - t0
    if tuple(a - b for a, b in zip(counts(), before)) != launched:
        fail("the plain run launched a kernel")
    print(f"  kernel round {t_k:.3f} s, plain round {t_p:.3f} s (host "
          f"rounding included); launches (annealed, per-iteration) "
          f"{launched} (want (1, 0))", flush=True)
    if launched != (1, 0):
        fail(f"kernel round made {launched} launches, want (1, 0)")
    if r_k.status != r_p.status or not np.array_equal(r_k.assign,
                                                      r_p.assign):
        fail(f"kernel and plain rounds disagree: {r_k.status} vs "
             f"{r_p.status}, {int((r_k.assign != r_p.assign).sum())} jobs")
    if not r_k.feasible:
        fail(f"storm round not feasible: {r_k.status}")

    # Duals of the same round, kernel vs plain loop (4095 jobs + the dummy
    # row fill bucket 4096: no padding rows).
    arcs = torch.from_numpy(np.stack([cost, allowed.astype(np.float64)])
                            .astype(np.float32)).to(dev)
    valid = torch.ones(M, dtype=torch.bool, device=dev)
    C, log_a, log_b, _, _ = port_round._prepare_device(
        arcs[0], arcs[1] > 0.5, torch.from_numpy(cap.astype(np.float32))
        .to(dev), valid)
    kw = dict(eps0=torch_solver.SINKHORN_EPS0, eps_min=0.005,
              iters=torch_solver.SINKHORN_ITERS,
              anneal_stages=torch_solver.SINKHORN_STAGES)
    f_k, g_k, _ = port_round._sinkhorn_kernel(C, log_a, log_b, **kw)
    with plain_solve():
        f_p, g_p, _ = port_round._sinkhorn_kernel(C, log_a, log_b, **kw)
    torch.cuda.synchronize()
    df = f_error(f_k, f_p, log_a)
    dg = (g_k - g_p).abs().max().item()
    print(f"  status {r_k.status}, objective {r_k.objective:.6f}, duals "
          f"max|df|={df:.3e} max|dg|={dg:.3e}", flush=True)
    if df > KERNEL_ATOL or dg > KERNEL_ATOL:
        fail(f"round duals disagree: {df:.3e} / {dg:.3e}")


def diurnal_cell():
    """diurnal[days=0.05, jobs_per_day=1e6, tolerance=0.5, seed=3], built
    as the reference's scenario registry builds it."""
    from repro_torch.core import telemetry
    from repro_torch.sim.trace import (borg_trace,
                                       scale_capacity_for_utilization)
    days, seed = 0.05, 3
    tele = telemetry.generate(days=max(int(np.ceil(days)) + 1, 2), seed=seed,
                              ewif_table="macknick",
                              regions=tuple(telemetry.REGIONS))
    jobs = borg_trace(days=days, seed=seed, tolerance=0.5,
                      num_regions=tele.num_regions,
                      target_jobs_per_day=1e6)
    cap = scale_capacity_for_utilization(jobs, days, tele.num_regions, 0.15)
    return tele, jobs, cap


STAGES = ("engine.round", "policy.admit", "policy.build", "policy.forecast",
          "forecast.fit", "forecast.infer", "policy.price",
          "solver.fused_round", "policy.solve", "solver.solve",
          "policy.extract")
SOLVE_SPANS = ("solver.solve", "solver.fused_round")


def run_cell(tele, jobs, cap, device, pipe=None):
    """One traced run of the cell through ``pipe`` (default: the reactive
    pipeline, backend ``fused``, on ``device``). Returns the engine result,
    its summary, wall time, per-stage span totals and the solver buckets
    seen."""
    import tempfile

    import repro_torch.obs as obs
    from repro_torch.policy.pipeline import reactive_pipeline
    from repro_torch.sim.engine import EventSimulator, SimConfig
    from repro_torch.sim.metrics import summarize
    if pipe is None:
        pipe = reactive_pipeline(tele, backend="fused", device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.trace.jsonl")
        with obs.capture(trace_path=path) as reg:
            t0 = time.perf_counter()
            res = EventSimulator(tele, cap, SimConfig()).run(
                copy.deepcopy(jobs), pipe)
            if device is None:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        buckets = collections.Counter(
            ev["args"]["bucket"]
            for ev in obs.iter_spans(obs.read_trace(path))
            if ev["name"] in SOLVE_SPANS
            and "bucket" in ev.get("args", {}))
    rounds = reg.hists["engine.round"]
    stages = {k: reg.hists[k].total for k in STAGES if k in reg.hists}
    return dict(res=res, summary=summarize(res), wall_s=wall, pipe=pipe,
                solves=len(pipe.solve_times), stages=stages,
                buckets=dict(sorted(buckets.items())),
                round_p50_ms=rounds.quantile(50) * 1e3,
                round_p99_ms=rounds.quantile(99) * 1e3)


def identical_share(card: dict, host: dict) -> float:
    """The share of the card run's records (job, region, start, finish)
    that the CPU run has too."""
    def key(r):
        return (r.job.job_id, r.region, r.start_s, r.finish_s)
    same = len({key(r) for r in card["res"]["records"]}
               & {key(r) for r in host["res"]["records"]})
    return same / max(len(card["res"]["records"]), 1)


def sinkhorn_stage(dev, M: int = 512, N: int = 6) -> dict:
    """The Sinkhorn stage of one round at bucket M, host wall (ms, to a
    synchronize; median of 5) and the profiler's device time, through the
    round's one-launch solve and, side by side in the same run, through
    the per-iteration kernel's loop of 720 launches."""
    from repro_torch.core import round as port_round
    from repro_torch.core.solvers import torch_solver
    C, _, log_a, log_b = main_path_inputs(M, N, 0.5, dev, seed=5)
    kw = dict(eps0=torch_solver.SINKHORN_EPS0, eps_min=0.005,
              iters=torch_solver.SINKHORN_ITERS,
              anneal_stages=torch_solver.SINKHORN_STAGES)
    table, iters = solve_schedule()

    def wall_ms(stage):
        stage()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            stage()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3

    def launch():
        return port_round._sinkhorn_kernel(C, log_a, log_b, **kw)

    def loop():
        return iteration_loop(C, log_a, log_b, table, iters)
    out = {}
    for name, stage in (("loop", loop), ("launch", launch),
                        ("launch_again", launch), ("loop_again", loop)):
        out[name] = dict(wall_ms=wall_ms(stage),
                         device_ms=profiled_device_ms(stage, reps=3))
    return out


def phase_e2e(dev) -> dict:
    from repro_torch.kernels.sinkhorn import sinkhorn
    print("== phase 3: reactive WaterWise round end to end", flush=True)
    tele, jobs, cap = diurnal_cell()
    print(f"  cell: {len(jobs)} jobs, {tele.num_regions} regions, capacity "
          f"{cap.tolist()}", flush=True)
    sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES = 0, 0
    card = run_cell(tele, jobs, cap, None)
    launches = sinkhorn.ANNEAL_LAUNCHES
    iteration_launches = sinkhorn.LAUNCHES
    host = run_cell(tele, jobs, cap, "cpu")
    if (sinkhorn.ANNEAL_LAUNCHES, sinkhorn.LAUNCHES) != (
            launches, iteration_launches):
        fail("the CPU run launched a kernel")
    for name, r in (("card", card), ("cpu", host)):
        report_cell(name, r)
    print(f"  Sinkhorn launches in the card run: annealed {launches} for "
          f"{card['solves']} fused solves (want one each), per-iteration "
          f"{iteration_launches} (want 0)", flush=True)
    if launches == 0 or launches != card["solves"] or iteration_launches:
        fail(f"main path launched the annealed kernel {launches} times and "
             f"the per-iteration kernel {iteration_launches} times for "
             f"{card['solves']} solves")

    print(f"  identical records card vs cpu: "
          f"{identical_share(card, host) * 100:.3f}%", flush=True)
    st = sinkhorn_stage(dev)
    print("  Sinkhorn stage of one bucket-512 round on the card (wall: "
          "median of 5; loop, launch, launch, loop): " + "; ".join(
              f"{name} wall {t['wall_ms']:.3f} ms, device "
              f"{fmt_us(t['device_ms'])}" for name, t in st.items()),
          flush=True)
    for k in ("carbon_kg", "water_kl"):
        a, b = card["summary"][k], host["summary"][k]
        if not (np.isfinite(a) and abs(a - b) <= E2E_RTOL * abs(b)):
            fail(f"{k}: card {a} vs cpu {b} beyond {E2E_RTOL:.1%}")
    # The kernel against its plain version at every bucket the card run's
    # fused solves spanned, at every eps of the annealed schedule.
    print("  kernel vs plain at the card run's buckets:", flush=True)
    worst = 0.0
    for M in card["buckets"]:
        for eps in schedule_eps():
            worst = max(worst, hold(M, tele.num_regions + 1, eps, seed=M))
    return dict(launches=launches, iteration_launches=iteration_launches,
                card=card, max_abs_err=worst, stage=st,
                cell=(tele, jobs, cap))


def scan_inputs(B: int, S: int, W: int, dev, seed: int):
    """(a, bx, w) as the learned forecaster feeds the scan: decays in
    (0, 0.95), gated inputs and an output cotangent, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand((B, S, W), generator=gen) * 0.95
    bx = torch.randn((B, S, W), generator=gen)
    w = torch.randn((B, S, W), generator=gen)
    return a.to(dev), bx.to(dev), w.to(dev)


def scan_grads(scan, a, bx, w):
    """(da, dbx) of sum(w * scan(a, bx)) by autograd."""
    a = a.clone().requires_grad_(True)
    bx = bx.clone().requires_grad_(True)
    torch.autograd.backward((w * scan(a, bx)).sum())
    return a.grad, bx.grad


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> dict:
    """The least time for the work: bytes over the HBM rate or operations
    over the peak rate of their type, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / ops_per_s * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                nbytes=nbytes, nops=nops)


def phase_scan(dev) -> dict:
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)
    print("== phase 4: RG-LRU scan kernels vs plain versions on the card",
          flush=True)
    worst = dict(fwd=0.0, bwd=0.0)
    # Training, validation and inference shapes of the learned forecaster,
    # then the reference kernel tests' odd shapes and a wide one.
    for shape in ((64, 48, 16), (75, 48, 16), (16, 48, 16), (5, 29, 16),
                  (2, 7, 15), (2, 128, 128)):
        a, bx, _ = scan_inputs(*shape, dev, seed=sum(shape))
        err = (ops.rglru_scan(a, bx) - rglru_scan_ref(a, bx)).abs().max()
        err = err.item()
        print(f"  fwd {shape}: max|dy|={err:.3e}", flush=True)
        if not np.isfinite(err) or err > SCAN_ATOL:
            fail(f"scan forward disagrees at {shape}: {err:.3e}")
        worst["fwd"] = max(worst["fwd"], err)
    for shape in ((64, 48, 16), (2, 7, 15)):
        a, bx, w = scan_inputs(*shape, dev, seed=sum(shape) + 1)
        before = dict(rk.LAUNCHES)
        da_k, dbx_k = scan_grads(ops.rglru_scan, a, bx, w)
        if rk.LAUNCHES["bwd"] != before["bwd"] + 1:
            fail("the backward did not launch its kernel once")
        da_r, dbx_r = scan_grads(rglru_scan_ref, a, bx, w)
        err = max((da_k - da_r).abs().max().item(),
                  (dbx_k - dbx_r).abs().max().item())
        print(f"  bwd {shape}: max|d grad|={err:.3e} (autograd through "
              f"the plain version)", flush=True)
        if not np.isfinite(err) or err > SCAN_ATOL:
            fail(f"scan backward disagrees at {shape}: {err:.3e}")
        worst["bwd"] = max(worst["bwd"], err)
    timings = {}
    for name, shape in (("fwd", (64, 48, 16)), ("fwd", (16, 48, 16)),
                        ("bwd", (64, 48, 16))):
        a, bx, gy = scan_inputs(*shape, dev, seed=3)
        n = a.numel()
        if name == "fwd":
            kernel = lambda: rk.rglru_scan_fwd_cuda(a, bx)
            plain = lambda: rglru_scan_ref(a, bx)
            # a, bx in, y out; one multiply-add per element.
            b = bound(3 * 4 * n, 2 * n)
        else:
            y = rk.rglru_scan_fwd_cuda(a, bx)
            kernel = lambda: rk.rglru_scan_bwd_cuda(a, y, gy)
            plain = lambda: rglru_scan_bwd_ref(a, y, gy)
            # a, y, gy in, da, dbx out; a multiply-add and a multiply.
            b = bound(5 * 4 * n, 3 * n)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        t = dict(ms=ms, plain_ms=plain_ms, device_ms=profiled_device_ms(kernel),
                 plain_device_ms=profiled_device_ms(plain), **b)
        timings[(name, shape)] = t
        print(f"  timing {name} {shape}: kernel {ms * 1e3:.2f} us/call "
              f"(device {fmt_us(t['device_ms'])}), plain "
              f"{plain_ms * 1e3:.2f} us (device "
              f"{fmt_us(t['plain_device_ms'])}), bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bound_by']})", flush=True)
    return dict(worst=worst, timings=timings)


def forecast_cell(tele, jobs, cap, device, forecaster: str) -> dict:
    """One run of the cell through ``forecast_pipeline(backend="fused")``,
    recording the first fit's q50 forecast and the number of fits."""
    from repro_torch.policy.pipeline import forecast_pipeline
    pipe = forecast_pipeline(tele, forecaster=forecaster, backend="fused",
                             device=device)
    pricer = pipe.pricer
    seen = dict(fits=0, q50=None)
    refresh = pricer._refresh_forecast

    def counted(now_s):
        hour = pricer._fit_hour
        refresh(now_s)
        if pricer._fit_hour != hour:
            seen["fits"] += 1
            if seen["q50"] is None:
                seen["q50"] = pricer._forecast.mean.copy()
    pricer._refresh_forecast = counted
    r = run_cell(tele, jobs, cap, device, pipe=pipe)
    r.update(seen)
    r["forecaster"] = pricer._forecaster_obj
    r["deferred_pct"] = 100.0 * pipe.deferred_jobs / max(len(jobs), 1)
    return r


def report_cell(name: str, r: dict) -> None:
    s = r["summary"]
    print(f"  {name}: {s['jobs']} jobs in {r['wall_s']:.3f} s = "
          f"{s['jobs'] / r['wall_s']:.1f} jobs/s; rounds "
          f"{r['res']['rounds']}, solves {r['solves']}; round p50 "
          f"{r['round_p50_ms']:.3f} ms p99 {r['round_p99_ms']:.3f} ms; "
          f"carbon {s['carbon_kg']:.6f} kg water {s['water_kl']:.6f} kL; "
          f"unfinished {r['res']['unfinished']}", flush=True)
    print("    stage totals (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["stages"].items()), flush=True)
    print("    solves by bucket: " + ", ".join(
        f"{b}: {n}" for b, n in r["buckets"].items()), flush=True)
    if r["res"]["unfinished"] != 0:
        fail(f"{name} run left {r['res']['unfinished']} jobs unfinished")


def phase_forecast(tele, jobs, cap) -> dict:
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.sinkhorn import sinkhorn
    print("== phase 5: forecast-driven WaterWise round end to end "
          "(learned forecaster)", flush=True)
    sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES = 0, 0
    rk.LAUNCHES.update(fwd=0, bwd=0)
    card = forecast_cell(tele, jobs, cap, None, "learned")
    launches = dict(sinkhorn=sinkhorn.ANNEAL_LAUNCHES,
                    sinkhorn_iteration=sinkhorn.LAUNCHES, **rk.LAUNCHES)
    host = forecast_cell(tele, jobs, cap, "cpu", "learned")
    if (sinkhorn.ANNEAL_LAUNCHES, sinkhorn.LAUNCHES, rk.LAUNCHES) != (
            launches["sinkhorn"], launches["sinkhorn_iteration"],
            dict(fwd=launches["fwd"], bwd=launches["bwd"])):
        fail("the CPU run launched a kernel")
    for name, r in (("card", card), ("cpu", host)):
        report_cell(name, r)
        f = r["forecaster"]
        print(f"    learned: {f.train_count} training run(s) of "
              f"{f.train_steps} steps, {r['fits']} fits; scan "
              f"{f.scan_impl}; kept snapshot after step {f.best_step} "
              f"(-1: the init), validation loss {f.best_val_loss:.6f}, "
              f"last training loss {f.last_loss:.6f}; forecast MAPE "
              f"{r['pipe'].forecast_mape:.4f} %; deferred "
              f"{r['deferred_pct']:.3f} % of jobs", flush=True)
    f = card["forecaster"]
    steps = f.train_steps
    evals = 1 + sum(1 for s in range(steps)
                    if s % 10 == 9 or s == steps - 1)
    want_fwd = f.train_count * (steps + evals) + card["fits"]
    want_bwd = f.train_count * steps
    print(f"  launches in the card run: sinkhorn_anneal "
          f"{launches['sinkhorn']} for {card['solves']} solves (want one "
          f"each), per-iteration {launches['sinkhorn_iteration']} (want 0), "
          f"rglru_scan fwd {launches['fwd']} (want {want_fwd} = "
          f"{f.train_count} x ({steps} steps + {evals} validation passes) "
          f"+ {card['fits']} fits), bwd {launches['bwd']} (want "
          f"{want_bwd})", flush=True)
    if launches["fwd"] == 0 or launches["bwd"] == 0:
        fail("the card run launched no RG-LRU scan kernel")
    if launches["fwd"] != want_fwd or launches["bwd"] != want_bwd:
        fail("RG-LRU launch counts differ from the training schedule")
    if launches["sinkhorn"] != card["solves"] or \
            launches["sinkhorn_iteration"]:
        fail(f"sinkhorn launched {launches} for {card['solves']} solves")
    print(f"  identical records card vs cpu: "
          f"{identical_share(card, host) * 100:.3f}%", flush=True)
    for k in ("carbon_kg", "water_kl"):
        a, b = card["summary"][k], host["summary"][k]
        if not (np.isfinite(a) and abs(a - b) <= E2E_RTOL * abs(b)):
            fail(f"{k}: card {a} vs cpu {b} beyond {E2E_RTOL:.1%}")
    q_card, q_host = card["q50"], host["q50"]
    dq = float(np.max(np.abs(q_card - q_host) / np.abs(q_host)))
    print(f"  first fit's q50 forecast, card vs cpu: max relative "
          f"|dq| {dq:.3e} (limit {Q50_RTOL:.0e}) over shape "
          f"{list(q_card.shape)}", flush=True)
    if not (np.all(np.isfinite(q_card)) and dq <= Q50_RTOL):
        fail("first-fit q50 forecast disagrees card vs cpu")

    print("== phase 5b: forecast-driven round with holtwinters on the card",
          flush=True)
    sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES = 0, 0
    rk.LAUNCHES.update(fwd=0, bwd=0)
    hw = forecast_cell(tele, jobs, cap, None, "holtwinters")
    report_cell("card", hw)
    print(f"    holtwinters: {hw['fits']} fits; forecast MAPE "
          f"{hw['pipe'].forecast_mape:.4f} %; deferred "
          f"{hw['deferred_pct']:.3f} % of jobs; sinkhorn_anneal launches "
          f"{sinkhorn.ANNEAL_LAUNCHES}, per-iteration {sinkhorn.LAUNCHES}, "
          f"rglru_scan {rk.LAUNCHES}", flush=True)
    if sinkhorn.ANNEAL_LAUNCHES != hw["solves"] or sinkhorn.LAUNCHES:
        fail("the holtwinters run did not solve through the annealed "
             "launch")
    return dict(launches=launches, card=card,
                hw_sinkhorn=sinkhorn.ANNEAL_LAUNCHES)

# --- The LM serving path (phases 6-8) -----------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), at 700 W: the
# rate of the type the attention and SSD inputs come in.
BF16_OPS_PER_S = 989e12
# Flash attention, kernel vs plain version: the reference kernel tests'
# tolerances (float32 2e-5, bf16 2e-2); the model-layout GQA wrapper
# against the blocked twin, 3e-5 as in test_flash_attention_gqa.
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GQA_ATOL = 3e-5
# SSD scan, kernel vs plain chunked version: the reference's 2e-3; in bf16
# both round their float32 results to bf16 on their own, so one bf16 step
# on top (bf16 keeps 8 significant bits: a step is at most 2^-7 of the
# value).
SSD_ATOL = 2e-3
BF16_RTOL = 2.0 ** -7
# Phase 7, card vs CPU, float32 at full width and depth 2: cuBLAS and the
# CPU's BLAS sum d = 1536-5120 products in other orders and the kernels
# sum in their own; the differences expected are ~1e-5, while a kernel off
# by one mask row or chunk moves logits by far more than 1e-3.
LM_LOGITS_ATOL = 1e-3
# Greedy tokens may part only at a near-tie: the reference's
# test_decode_matches_forward rule (the other device's logit of the token
# chosen is within 0.15 of its max).
TIE_GAP = 0.15
ARCHS = ("qwen2_1_5b", "mamba2_2_7b")


def check(name: str, err: float, limit: float) -> float:
    if not np.isfinite(err) or err > limit:
        fail(f"{name}: max |d| {err:.3e} beyond {limit:.1e}")
    return err


def flash_case(BH, S, D, causal, window, dtype, group, seed):
    """Kernel vs plain version on standard-normal q, k, v; checks that the
    call launched the kernel ``variant`` chooses once; returns
    (max |d|, (q, k, v))."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((BH, S, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((BH // group, S, D), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    kind = fk.variant(dtype, D)
    before = dict(fk.LAUNCHES_BY_VARIANT)
    out = fops.flash_attention_bh(q, k, v, causal=causal, window=window,
                                  group=group)
    ref = flash_attention_bh_ref(q, k, v, causal=causal, window=window,
                                 group=group)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  flash BH={BH} S={S} D={D} causal={causal} window={window} "
          f"{str(dtype)[6:]} group={group} ({kind} kernel): "
          f"max|do|={err:.3e}", flush=True)
    if fk.LAUNCHES_BY_VARIANT != {**before, kind: before[kind] + 1}:
        fail(f"flash attention did not launch its {kind} kernel once")
    check("flash attention", err, FLASH_ATOL[dtype])
    return err, (q, k, v)


def flash_timing(D: int, seed: int) -> dict:
    """At the qwen2-1.5B prefill shape ([48, 2048, D] bf16, group 6,
    causal): the wgmma kernel, the scalar kernel on the same inputs in
    float32, the plain version and scaled_dot_product_attention, by CUDA
    events and by the profiler, beside each kernel's bound."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    BHq, S, group = 48, 2048, 6
    q = torch.randn((BHq, S, D), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((BHq // group, S, D), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    kernel = lambda: fk.flash_attention_bh_cuda(q, k, v, causal=True,
                                                group=group)
    scalar = lambda: fk.flash_attention_bh_cuda(q32, k32, v32, causal=True,
                                                group=group)
    plain = lambda: flash_attention_bh_ref(q, k, v, causal=True, group=group)
    q4, k4, v4 = (t.view(4, -1, S, D) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)
    ref = plain().float()
    err = (kernel().float() - ref).abs().max().item()
    lib_err = (library().reshape(BHq, S, D).float() - ref).abs().max().item()
    check("flash attention (wgmma) at the timed shape", err,
          FLASH_ATOL[torch.bfloat16])
    pairs = BHq * S * (S + 1) // 2             # the causal triangle
    elems = q.numel() + k.numel() + v.numel() + q.numel()
    t = dict(ms=cuda_ms(kernel, warmup=5, reps=50),
             device_ms=profiled_device_ms(kernel, reps=10),
             scalar_ms=cuda_ms(scalar, warmup=2, reps=5),
             scalar_device_ms=profiled_device_ms(scalar, reps=2),
             plain_ms=cuda_ms(plain, warmup=2, reps=5),
             plain_device_ms=profiled_device_ms(plain, reps=2),
             library_ms=cuda_ms(library, warmup=5, reps=50),
             library_device_ms=profiled_device_ms(library, reps=10),
             max_abs_err=err, library_err=lib_err,
             scalar_bound=bound(4 * elems, 4 * pairs * D),
             **bound(2 * elems, 4 * pairs * D, BF16_OPS_PER_S))
    print(f"  timing flash at [48, 2048, {D}] group 6, causal: wgmma kernel "
          f"(bf16) {t['ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['device_ms'])}; max|d| vs plain {err:.3e}), scalar "
          f"kernel (float32) {t['scalar_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['scalar_device_ms'])}; bound "
          f"{t['scalar_bound']['bound_ms'] * 1e3:.2f} us at the float32 "
          f"rate), plain {t['plain_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['plain_device_ms'])}), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['library_device_ms'])}; max|d| vs plain "
          f"{lib_err:.3e}), bound {t['bound_ms'] * 1e3:.2f} us "
          f"({t['bound_by']}: {t['nops'] / 1e9:.2f} GFLOP at the bf16 "
          f"tensor-core rate, {t['nbytes'] / 1e6:.2f} MB)", flush=True)
    return t


def ssd_inputs(b, S, H, P, G, N, dtype, seed, model_like):
    """(x, dt, A, B, C) on the card. model_like: as the Mamba-2 block hands
    them to the scan — x, B, C are SiLU outputs of unit-normal
    pre-activations (the causal conv's output), dt = softplus(N(0, 0.5^2)
    + dt_bias) and A = -exp(A_log) at Mamba-2's init ranges
    (``draw_live_mixer``). Otherwise test_ssd_scan_sweep's draws."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.common import softplus
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if model_like:
        cfg = get_config("mamba2_2_7b").replace(
            d_inner=H * P, ssm_head_dim=P, ssm_groups=G, ssm_state=N)
        mix = ssm.draw_live_mixer(np.random.default_rng(seed), cfg)
        x = F.silu(randn(b, S, H, P)).to(dtype)
        dt = softplus(0.5 * randn(b, S, H) + torch.from_numpy(
            mix["dt_bias"]).cuda())
        A = -torch.exp(torch.from_numpy(mix["A_log"]).cuda())
        Bm, Cm = (F.silu(randn(b, S, G, N)).to(dtype) for _ in range(2))
    else:
        x = randn(b, S, H, P).to(dtype)
        dt = torch.rand((b, S, H), generator=gen, device="cuda") * 0.5 + 0.1
        A = -torch.rand(H, generator=gen, device="cuda") - 0.2
        Bm, Cm = (randn(b, S, G, N).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


def ssd_case(b, S, H, P, G, N, chunk, dtype, seed, model_like=False):
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    args = ssd_inputs(b, S, H, P, G, N, dtype, seed, model_like)
    y, st = sops.ssd_scan(*args, chunk=chunk)
    yr, sr = ssd_ref(*args, chunk=min(chunk, S))
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    # max |d| beyond the bf16 rounding allowance, plus that allowance's
    # use: the check is |d| <= atol + rtol |ref|.
    err = max(((y.float() - yr.float()).abs()
               - rtol * yr.float().abs()).max().item(),
              ((st.float() - sr.float()).abs()
               - rtol * sr.float().abs()).max().item())
    raw = max((y.float() - yr.float()).abs().max().item(),
              (st.float() - sr.float()).abs().max().item())
    print(f"  ssd b={b} S={S} H={H} P={P} G={G} N={N} chunk={chunk} "
          f"{str(dtype)[6:]}{' model-like' if model_like else ''}: "
          f"max|d(y, state)|={raw:.3e} (beyond rtol {rtol:.2e}: "
          f"{err:.3e}); max|y|={yr.float().abs().max().item():.3e}",
          flush=True)
    check("ssd scan", err, SSD_ATOL)
    if yr.float().abs().max().item() == 0.0:
        fail("ssd scan output is zero")
    return raw, args


def phase_lm_kernels(dev) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models import attention
    print("== phase 6: flash attention and SSD scan kernels vs plain "
          "versions on the card", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = dict(flash=0.0, flash_sm90=0.0, ssd=0.0)
    # test_flash_attention_sweep's six shapes, ragged S = 1000 (GQA,
    # sliding, full), then the qwen2-1.5B prefill shape (B 4, S 2048) and
    # the same at D 64. bf16 at D 64 and 128 takes the wgmma kernel, the
    # rest the scalar one.
    for i, case in enumerate([
            (4, 256, 64, True, 0, f32, 1), (2, 512, 128, True, 0, f32, 1),
            (2, 256, 64, False, 0, f32, 1), (2, 512, 64, True, 100, f32, 1),
            (2, 256, 128, True, 0, bf16, 1), (1, 128, 256, True, 64, f32, 1),
            (8, 1000, 64, True, 0, f32, 4), (4, 1000, 128, True, 300, bf16, 2),
            (12, 1000, 64, True, 300, bf16, 6),
            (4, 1000, 64, False, 0, bf16, 2),
            (6, 1000, 128, False, 0, bf16, 6),
            (48, 2048, 64, True, 0, bf16, 6),
            (48, 2048, 128, True, 0, bf16, 6)]):
        err, _ = flash_case(*case, seed=i)
        key = ("flash_sm90" if fk.variant(case[5], case[2]) == "wgmma"
               else "flash")
        worst[key] = max(worst[key], err)
    # test_flash_attention_gqa: the model-layout wrapper vs the blocked twin.
    for G in (1, 2, 4):
        gen = torch.Generator(device="cuda").manual_seed(10 + G)
        B, S, Kh, D = 2, 256, 2, 64
        q = torch.randn((B, S, Kh, G, D), generator=gen, device="cuda")
        k, v = (torch.randn((B, S, Kh, D), generator=gen, device="cuda")
                for _ in range(2))
        pos = torch.arange(S, device="cuda")
        err = (fops.flash_attention(q, k, v) - attention.blocked_attention(
            q, k, v, pos, pos, block_kv=128)).abs().max().item()
        print(f"  flash GQA G={G} (model layout) vs blocked_attention: "
              f"max|do|={err:.3e}", flush=True)
        worst["flash"] = max(worst["flash"], check("flash GQA", err,
                                                   GQA_ATOL))
    flash_t = {D: flash_timing(D, seed=40 + D) for D in (128, 64)}
    # test_ssd_scan_sweep's three shapes, a ragged S, then the mamba2-2.7B
    # prefill shape (b 4, S 2048) in bf16 and in float32.
    for i, case in enumerate([(2, 64, 4, 16, 2, 8, 16, f32),
                              (2, 128, 2, 32, 1, 16, 32, f32),
                              (2, 64, 8, 64, 8, 8, 64, f32),
                              (2, 100, 4, 16, 2, 8, 16, f32)]):
        err, _ = ssd_case(*case, seed=20 + i)
        worst["ssd"] = max(worst["ssd"], err)
    err, _ = ssd_case(4, 2048, 80, 64, 1, 128, 256, f32, seed=30,
                      model_like=True)
    worst["ssd"] = max(worst["ssd"], err)
    err, args = ssd_case(4, 2048, 80, 64, 1, 128, 256, bf16, seed=31,
                         model_like=True)
    worst["ssd"] = max(worst["ssd"], err)
    x, dt, A, Bm, Cm = args
    b, S, H, P = x.shape
    N, L = Bm.shape[3], 256
    nc = -(-S // L)
    # Causal intra-chunk products L(L+1)/2 (N + P), inter term and state
    # update 2 L N P, per (b, h, chunk); bytes: x, dt, A, B, C read, y and
    # the state written.
    nops = 2 * b * H * nc * (L * (L + 1) // 2 * (N + P) + 2 * L * N * P)
    nbytes = (2 * x.numel() * 2 + dt.numel() * 4 + A.numel() * 4
              + 2 * Bm.numel() * 2 + b * H * P * N * 2)
    kernel = lambda: sk.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=L)
    plain = lambda: ssd_ref(x, dt, A, Bm, Cm, chunk=L)
    ssd_t = dict(ms=cuda_ms(kernel, warmup=3, reps=20),
                 device_ms=profiled_device_ms(kernel, reps=5),
                 plain_ms=cuda_ms(plain, warmup=2, reps=5),
                 plain_device_ms=profiled_device_ms(plain, reps=2),
                 library_ms=None, **bound(nbytes, nops, BF16_OPS_PER_S))
    print(f"  timing ssd at mamba2-2.7B prefill (4, 2048, 80, 64; G 1, N "
          f"128, L 256) bf16: kernel {ssd_t['ms']:.4f} ms (device "
          f"{fmt_us(ssd_t['device_ms'])}), plain {ssd_t['plain_ms']:.4f} ms "
          f"(device {fmt_us(ssd_t['plain_device_ms'])}), bound "
          f"{ssd_t['bound_ms'] * 1e3:.2f} us ({ssd_t['bound_by']}: "
          f"{nops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); library call: "
          f"none (no PyTorch call computes the chunked SSD)", flush=True)
    return dict(worst=worst, flash=flash_t, ssd=ssd_t)


def lm_params(cfg, gen, seed):
    """The port's init drawn from ``gen`` (on its device), with the
    Mamba-2 mixers' conv and SSM scalars from ``draw_live_mixer`` (the
    reference's zero conv would feed the SSD exact zeros)."""
    from repro_torch.models import ssm
    from repro_torch.models.model import Model
    params = Model(cfg).init(gen)
    if cfg.ssm:
        rng = np.random.default_rng(seed)
        for lp in params["layers"]:
            for k, v in ssm.draw_live_mixer(rng, cfg).items():
                old = lp["mixer"][k]
                lp["mixer"][k] = torch.from_numpy(v).to(old.device, old.dtype)
    return params


@contextlib.contextmanager
def scan_recorder():
    """Record max |y| of every SSD scan the model runs (kernel or plain)."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import ssm
    seen = []
    saved = (sops.ssd_scan, ssm.ssd_chunked)

    def wrap(fn):
        def rec(*args, **kw):
            y, st = fn(*args, **kw)
            seen.append(y.float().abs().max().item())
            return y, st
        return rec
    sops.ssd_scan, ssm.ssd_chunked = wrap(saved[0]), wrap(saved[1])
    try:
        yield seen
    finally:
        sops.ssd_scan, ssm.ssd_chunked = saved


def serve_logits(model, params, toks, stream, device) -> list:
    """Prefill ``toks`` then decode along ``stream`` (teacher forced):
    the [B, V] logits of every step, as float32 numpy."""
    from repro_torch.runtime.serve_loop import _splice
    with torch.inference_mode():
        t = torch.as_tensor(toks, dtype=torch.int64, device=device)
        B, S = t.shape
        cache = model.init_cache(B, S + stream.shape[1], device)
        last, built = model.prefill(params, dict(tokens=t))
        cache = _splice(cache, built)
        out = [last.float().cpu().numpy()]
        for i in range(stream.shape[1] - 1):
            tok = torch.as_tensor(stream[:, i:i + 1], dtype=torch.int64,
                                  device=device)
            logits, cache = model.decode(params, cache, tok, S + i)
            out.append(logits.float().cpu().numpy())
    return out


def phase_lm_parity(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models.model import Model, to_device
    from repro_torch.runtime.serve_loop import Server
    print("== phase 7: LM serving, card vs CPU (full width, depth 2, "
          "float32)", flush=True)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).replace(n_layers=2, dtype="float32",
                                       param_dtype="float32")
        model = Model(cfg)
        t0 = time.perf_counter()
        host_params = lm_params(cfg, torch.Generator().manual_seed(0), 7)
        card_params = to_device(host_params, dev)
        init_s = time.perf_counter() - t0
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 320))
        fk.LAUNCHES_BY_VARIANT.update(wgmma=0, scalar=0)
        with scan_recorder() as card_scans:
            card_tokens = Server(model, card_params).generate(
                dict(tokens=toks), max_new=8)
        flash_launches = dict(fk.LAUNCHES_BY_VARIANT)
        want = dict(wgmma=0, scalar=0 if cfg.ssm else cfg.n_layers)
        if flash_launches != want:
            fail(f"{arch}: float32 serving launched the flash kernels "
                 f"{flash_launches}, want {want}")
        with scan_recorder() as host_scans:
            host_tokens = Server(model, host_params, device="cpu").generate(
                dict(tokens=toks), max_new=8)
        card_steps = serve_logits(model, card_params, toks, host_tokens, dev)
        host_steps = serve_logits(model, host_params, toks, host_tokens,
                                  "cpu")
        errs = [float(np.abs(a - b).max()) for a, b in zip(card_steps,
                                                           host_steps)]
        live = np.ones(2, bool)
        for t, (a, b) in enumerate(zip(card_steps, host_steps)):
            ai, bi = a.argmax(-1), b.argmax(-1)
            gap = b[np.arange(2), bi] - b[np.arange(2), ai]
            if not ((ai == bi) | (gap <= TIE_GAP)).all():
                fail(f"{arch} step {t}: card argmax {ai} vs cpu {bi}, gap "
                     f"{gap}")
            same = card_tokens[:, t] == host_tokens[:, t]
            if not (same | ~live | (ai != bi)).all():
                fail(f"{arch}: card and cpu tokens part without a near-tie "
                     f"at step {t}")
            live &= same
        print(f"  {arch}: {model.param_count() / 1e9:.3f} B parameters at "
              f"depth 2 (drawn on the CPU in {init_s:.1f} s); prompt "
              f"(2, 320), 8 new tokens; card tokens {card_tokens.tolist()}; "
              f"cpu tokens {host_tokens.tolist()}; max |d logits| card vs "
              f"cpu per step {['%.2e' % e for e in errs]} (limit "
              f"{LM_LOGITS_ATOL:.0e}); flash launches in the card's "
              f"generate {flash_launches}", flush=True)
        check(f"{arch} logits card vs cpu", max(errs), LM_LOGITS_ATOL)
        if cfg.ssm:
            print(f"    SSD max |y| per scan: card "
                  f"{['%.3e' % s for s in card_scans]}, cpu "
                  f"{['%.3e' % s for s in host_scans]}", flush=True)
            if not card_scans or min(card_scans + host_scans) <= 0.0:
                fail(f"{arch}: the SSD carried zeros")
        out[arch] = dict(max_logits_err=max(errs), flash=flash_launches,
                         tokens_equal=bool(np.array_equal(card_tokens,
                                                          host_tokens)))
        del card_params, host_params
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_call_counter():
    """Count calls of the two kernels' plain versions on the model path."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import attention, ssm
    calls = collections.Counter()
    targets = [(attention, "blocked_attention"),
               (fops, "flash_attention_bh_ref"), (ssm, "ssd_chunked"),
               (sops, "ssd_ref")]
    saved = [getattr(mod, name) for mod, name in targets]

    def wrap(fn, name):
        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return counted
    for (mod, name), fn in zip(targets, saved):
        setattr(mod, name, wrap(fn, name))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


def prefill_profile(model, params, toks) -> dict:
    """The profiler's device time of one prefill, by kernel name, and the
    host wall around it."""
    from torch.profiler import ProfilerActivity, profile
    t = torch.as_tensor(toks, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, dict(tokens=t))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    by_name = {ev.key: ev.self_device_time_total / 1e3
               for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")
               and ev.self_device_time_total > 0}
    # The port's own kernels among them, by the kernel's function name.
    ours = {label: sum(ms for name, ms in by_name.items() if key in name)
            for label, key in (("flash_attention_sm90", "flash_fwd_sm90"),
                               ("flash_attention", "flash_fwd<"),
                               ("ssd_scan", "ssd_fwd"))}
    return dict(wall_ms=wall * 1e3, device_ms=sum(by_name.values()),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:6],
                ours=ours)


def phase_lm_serve(dev) -> dict:
    import repro_torch.obs as obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import Server
    print("== phase 8: LM serving at full depth on the card (bf16, B 4, "
          "prompt 2048, 32 new tokens)", flush=True)
    B, S, NEW = 4, 2048, 32
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        model = Model(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           8)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S))
        server = Server(model, params)
        # Warm-up at the measured shapes, so the allocator's pool and the
        # libraries' handles are set up outside the measured run.
        server.generate(dict(tokens=toks), max_new=2)
        torch.cuda.reset_peak_memory_stats()
        with plain_call_counter() as plain_calls:
            fk.LAUNCHES, sk.LAUNCHES = 0, 0
            fk.LAUNCHES_BY_VARIANT.update(wgmma=0, scalar=0)
            with obs.capture() as reg:
                tokens = server.generate(dict(tokens=toks), max_new=NEW)
            launches = dict(flash_attention=fk.LAUNCHES, ssd_scan=sk.LAUNCHES,
                            **fk.LAUNCHES_BY_VARIANT)
        peak = torch.cuda.max_memory_allocated()
        prefill_s = reg.hists["serve.prefill"].total
        decode_s = reg.hists["serve.decode"].total
        # One flash launch per layer of qwen2-1.5B's prefill, all on the
        # tensor-core kernel (bf16, D 128); none of the scalar kernel.
        want = dict(flash_attention=0 if cfg.ssm else cfg.n_layers,
                    ssd_scan=cfg.n_layers if cfg.ssm else 0,
                    wgmma=0 if cfg.ssm else cfg.n_layers, scalar=0)
        prof = prefill_profile(model, params, toks)
        print(f"  {arch}: {model.param_count() / 1e9:.4f} B parameters, "
              f"{cfg.n_layers} layers, drawn on the card in {init_s:.1f} s; "
              f"prefill {prefill_s * 1e3:.1f} ms = "
              f"{B * S / prefill_s:.0f} tokens/s; decode "
              f"{decode_s / (NEW - 1) * 1e3:.2f} ms per token of each "
              f"sequence (one step of {B} tokens; {NEW - 1} steps in "
              f"{decode_s * 1e3:.1f} ms = "
              f"{B * (NEW - 1) / decode_s:.1f} tokens/s); peak memory "
              f"{peak / 2 ** 30:.2f} GiB; launches {launches} (want {want}); "
              f"plain-version calls {dict(plain_calls)}", flush=True)
        print(f"    one profiled prefill: wall {prof['wall_ms']:.1f} ms, "
              f"device {prof['device_ms']:.1f} ms (busy "
              f"{prof['device_ms'] / prof['wall_ms'] * 100:.1f} %); the "
              "port's kernels (device ms): " + ", ".join(
                  f"{k} {ms:.2f}" for k, ms in prof["ours"].items())
              + "; top kernels (device ms): " + "; ".join(
                  f"{name[:60]} {ms:.2f}" for name, ms in prof["top"]),
              flush=True)
        print(f"    first tokens: {tokens[:, :8].tolist()}", flush=True)
        if launches != want:
            fail(f"{arch}: launches {launches}, want {want}")
        if sum(plain_calls.values()):
            fail(f"{arch}: the plain versions ran on the card's main path: "
                 f"{dict(plain_calls)}")
        if tokens.shape != (B, NEW) or tokens.min() < 0 or \
                tokens.max() >= cfg.vocab:
            fail(f"{arch}: tokens out of range {tokens.min()}.."
                 f"{tokens.max()} or shape {tokens.shape}")
        out[arch] = dict(launches=launches, prefill_s=prefill_s,
                         decode_s=decode_s, peak_bytes=peak,
                         params=model.param_count(), profile=prof)
        del params, server
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device available")
    from repro_torch.kernels import _build
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.runtime import platform
    dev = platform.device()
    print(f"tree sha256 {tree_sha256()} (chip_smoke.py + src/repro_torch "
          f"*.py, *.cu)", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; hopper={platform.on_hopper()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sources = ["sinkhorn", "rglru_scan", "flash_attention",
               "flash_attention_sm90", "ssd_scan"]
    _build.build(sources)
    for name in sources:
        _build.library(name)
    print(f"built the {', '.join(sources)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)",
          flush=True)

    def timed(label, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        print(f"  [{label}: {time.perf_counter() - start:.1f} s of wall]",
              flush=True)
        return result
    k = timed("phase 1", phase_kernel, dev)
    timed("phase 2", phase_round, dev)
    e2e = timed("phase 3", phase_e2e, dev)
    scan = timed("phase 4", phase_scan, dev)
    fc = timed("phase 5", phase_forecast, *e2e["cell"])
    lmk = timed("phase 6", phase_lm_kernels, dev)
    parity = timed("phase 7", phase_lm_parity, dev)
    serve = timed("phase 8", phase_lm_serve, dev)
    a = k["anneal_timings"][(512, 6)]    # the bucket of phase 3's rounds
    kernels = [dict(
        name="sinkhorn_anneal", route="cuda",
        source="src/repro_torch/csrc/sinkhorn.cu",
        replaces="src/repro/kernels/sinkhorn/sinkhorn.py:83",
        launches=e2e["launches"],
        launches_forecast_round=fc["launches"]["sinkhorn"],
        max_abs_err=k["anneal_max_abs_err"], ms=a["ms"],
        plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        device_ms=a["device_ms"], bound_by=a["bound_by"], library_ms=None,
        shape=[512, 6], iteration_loop_ms=a["loop_ms"], launches_per_call=1,
        main_path="every fused solve of phases 3 and 5",
        forecast_shape=dict(shape=[512, 40],
                            **k["anneal_timings"][(512, 40)]))]
    t = k["timings"][(512, 6)]
    kernels.append(dict(
        name="sinkhorn_iteration", route="cuda",
        source="src/repro_torch/csrc/sinkhorn.cu",
        replaces="src/repro/kernels/sinkhorn/sinkhorn.py:83",
        launches=e2e["iteration_launches"],
        launches_forecast_round=fc["launches"]["sinkhorn_iteration"],
        max_abs_err=max(k["max_abs_err"], e2e["max_abs_err"]),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        device_ms=t["device_ms"], plain_device_ms=t["plain_device_ms"],
        bound_by=t["bound_by"], library_ms=None, shape=[512, 6],
        launches_per_call=sinkhorn.LAUNCHES_PER_ITERATION,
        main_path="none: the round's solve is sinkhorn_anneal; the bitwise "
                  "yardstick of phase 1",
        forecast_shape=dict(shape=[512, 40], **k["timings"][(512, 40)])))
    for name, direction, replaces in (
            ("rglru_scan_fwd", "fwd",
             "src/repro/kernels/rglru_scan/rglru_scan.py:49"),
            ("rglru_scan_bwd", "bwd",
             "src/repro/kernels/rglru_scan/ops.py:40")):
        t = scan["timings"][(direction, (64, 48, 16))]
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/rglru_scan.cu", replaces=replaces,
            launches=fc["launches"][direction],
            max_abs_err=scan["worst"][direction], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            device_ms=t["device_ms"], plain_device_ms=t["plain_device_ms"],
            bound_by=t["bound_by"], library_ms=None, shape=[64, 48, 16],
            launches_per_call=1))
    infer = scan["timings"][("fwd", (16, 48, 16))]
    kernels[2]["infer_shape"] = dict(shape=[16, 48, 16], **infer)
    f128, f64 = lmk["flash"][128], lmk["flash"][64]
    flash = "src/repro/kernels/flash_attention/flash_attention.py:104"
    kernels.append(dict(
        name="flash_attention_sm90", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces=flash,
        launches=serve["qwen2_1_5b"]["launches"]["wgmma"],
        max_abs_err=lmk["worst"]["flash_sm90"], ms=f128["ms"],
        plain_ms=f128["plain_ms"], bound_ms=f128["bound_ms"],
        device_ms=f128["device_ms"], plain_device_ms=f128["plain_device_ms"],
        bound_by=f128["bound_by"], library_ms=f128["library_ms"],
        shape=[48, 2048, 128], dtype="bfloat16", launches_per_call=1,
        main_path="qwen2_1_5b Server.generate, bf16 (phase 8)",
        d64=dict(shape=[48, 2048, 64], **{
            key: f64[key] for key in ("ms", "device_ms", "plain_ms",
                                      "library_ms", "bound_ms",
                                      "max_abs_err")})))
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu", replaces=flash,
        launches=parity["qwen2_1_5b"]["flash"]["scalar"],
        max_abs_err=lmk["worst"]["flash"], ms=f128["scalar_ms"],
        plain_ms=f128["plain_ms"],
        bound_ms=f128["scalar_bound"]["bound_ms"],
        device_ms=f128["scalar_device_ms"],
        bound_by=f128["scalar_bound"]["bound_by"],
        library_ms=f128["library_ms"], shape=[48, 2048, 128],
        dtype="float32", launches_per_call=1,
        main_path="qwen2_1_5b Server.generate, float32 at depth 2 (phase 7)"))
    t = lmk["ssd"]
    kernels.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:93",
        launches=serve["mamba2_2_7b"]["launches"]["ssd_scan"],
        max_abs_err=lmk["worst"]["ssd"], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        device_ms=t["device_ms"], plain_device_ms=t["plain_device_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        shape=[4, 2048, 80, 64], launches_per_call=1,
        main_path="mamba2_2_7b Server.generate"))
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
