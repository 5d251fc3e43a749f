"""Smoke run of the PyTorch port on one CUDA card (an H100).

Builds the port's kernels from the sources in this checkout, then:

  1. holds each kernel against its plain PyTorch version on the card, at the
     shapes the scheduling round gives it, and times both;
  2. runs one fused round at storm scale (4095 jobs x 6 columns, bucket
     4096) through the kernel and through the plain loop on the card;
  3. drives the reactive WaterWise round end to end — ``EventSimulator`` +
     ``reactive_pipeline(backend="fused")`` — on a diurnal Borg-like cell
     of ~50k jobs (1M jobs/day for 0.05 days, 5 regions, 15% load), on the
     card and on the CPU, compares the two, and holds the kernel against
     its plain version at every row bucket the card run's solves spanned;
  4. holds the RG-LRU scan kernels (forward and backward) against their
     plain versions at the learned forecaster's shapes and times both;
  5. drives the forecast-driven round end to end — ``EventSimulator`` +
     ``forecast_pipeline(forecaster="learned", backend="fused")`` — on the
     same cell, on the card and on the CPU, compares the two, checks the
     kernels' launch counts, and runs ``forecaster="holtwinters"`` on the
     card once.

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
    eps0, eps_min = torch_solver.SINKHORN_EPS0, 0.005
    stages = torch_solver.SINKHORN_STAGES
    decay = (eps_min / eps0) ** (1.0 / max(stages - 1, 1))
    return [eps0 * decay ** s for s in range(stages)]


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


def phase_kernel(dev) -> dict:
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref
    print("== phase 1: kernel vs plain version on the card", flush=True)
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
    return dict(max_abs_err=worst, timings=timings)


@contextlib.contextmanager
def plain_iteration():
    """Run the fused round's kernel-order loop with the plain version in
    place of the kernel (the comparison run of phase 2)."""
    from repro_torch.core import round as port_round
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref
    saved = port_round.sinkhorn_iteration
    port_round.sinkhorn_iteration = sinkhorn_iteration_ref
    try:
        yield
    finally:
        port_round.sinkhorn_iteration = saved


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
    iters = torch_solver.SINKHORN_ITERS * torch_solver.SINKHORN_STAGES

    before = sinkhorn.LAUNCHES
    t0 = time.perf_counter()
    r_k = port_round.fused_solve(cost, allowed, cap, sinkhorn_impl="kernel",
                                 device=dev)
    t_k = time.perf_counter() - t0
    launched = sinkhorn.LAUNCHES - before
    with plain_iteration():
        t0 = time.perf_counter()
        r_p = port_round.fused_solve(cost, allowed, cap,
                                     sinkhorn_impl="kernel", device=dev)
        t_p = time.perf_counter() - t0
    if sinkhorn.LAUNCHES - before != launched:
        fail("the plain run launched the kernel")
    want = iters * sinkhorn.LAUNCHES_PER_ITERATION
    print(f"  kernel round {t_k:.3f} s, plain round {t_p:.3f} s (host "
          f"rounding included); launches {launched} (want {want})",
          flush=True)
    if launched != want:
        fail(f"kernel round made {launched} launches, want {want}")
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
    with plain_iteration():
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


def sinkhorn_stage(dev, M: int = 512, N: int = 6) -> dict:
    """The Sinkhorn stage of one round at bucket M through the kernel:
    host wall (ms, to a synchronize) and the profiler's device time."""
    from repro_torch.core import round as port_round
    from repro_torch.core.solvers import torch_solver
    C, _, log_a, log_b = main_path_inputs(M, N, 0.5, dev, seed=5)
    kw = dict(eps0=torch_solver.SINKHORN_EPS0, eps_min=0.005,
              iters=torch_solver.SINKHORN_ITERS,
              anneal_stages=torch_solver.SINKHORN_STAGES)

    def stage():
        return port_round._sinkhorn_kernel(C, log_a, log_b, **kw)
    stage()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        stage()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return dict(wall_ms=float(np.median(walls)) * 1e3,
                device_ms=profiled_device_ms(stage, reps=3))


def phase_e2e(dev) -> dict:
    from repro_torch.kernels.sinkhorn import sinkhorn
    print("== phase 3: reactive WaterWise round end to end", flush=True)
    tele, jobs, cap = diurnal_cell()
    print(f"  cell: {len(jobs)} jobs, {tele.num_regions} regions, capacity "
          f"{cap.tolist()}", flush=True)
    sinkhorn.LAUNCHES = 0
    card = run_cell(tele, jobs, cap, None)
    launches = sinkhorn.LAUNCHES
    host = run_cell(tele, jobs, cap, "cpu")
    if sinkhorn.LAUNCHES != launches:
        fail("the CPU run launched the kernel")
    per_round = 360 * sinkhorn.LAUNCHES_PER_ITERATION
    for name, r in (("card", card), ("cpu", host)):
        report_cell(name, r)
    print(f"  kernel launches in the card run: {launches} "
          f"({launches / per_round:.0f} fused solves x {per_round})",
          flush=True)
    if launches == 0 or launches != card["solves"] * per_round:
        fail(f"main path launched the kernel {launches} times for "
             f"{card['solves']} solves")

    def key(r):
        return (r.job.job_id, r.region, r.start_s, r.finish_s)
    same = len({key(r) for r in card["res"]["records"]}
               & {key(r) for r in host["res"]["records"]})
    share = same / max(len(card["res"]["records"]), 1)
    print(f"  identical records card vs cpu: {share * 100:.3f}%", flush=True)
    st = sinkhorn_stage(dev)
    print(f"  Sinkhorn stage of one bucket-512 round on the card: wall "
          f"{st['wall_ms']:.3f} ms (median of 5), device "
          f"{fmt_us(st['device_ms'])}", flush=True)
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
    return dict(launches=launches, card=card, max_abs_err=worst,
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


def bound(nbytes: float, nops: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


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
    sinkhorn.LAUNCHES = 0
    rk.LAUNCHES.update(fwd=0, bwd=0)
    card = forecast_cell(tele, jobs, cap, None, "learned")
    launches = dict(sinkhorn=sinkhorn.LAUNCHES, **rk.LAUNCHES)
    host = forecast_cell(tele, jobs, cap, "cpu", "learned")
    if (sinkhorn.LAUNCHES, rk.LAUNCHES) != (
            launches["sinkhorn"], dict(fwd=launches["fwd"],
                                       bwd=launches["bwd"])):
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
    per_solve = 360 * sinkhorn.LAUNCHES_PER_ITERATION
    print(f"  launches in the card run: sinkhorn {launches['sinkhorn']} "
          f"({launches['sinkhorn'] / per_solve:.0f} solves x {per_solve}), "
          f"rglru_scan fwd {launches['fwd']} (want {want_fwd} = "
          f"{f.train_count} x ({steps} steps + {evals} validation passes) "
          f"+ {card['fits']} fits), bwd {launches['bwd']} (want "
          f"{want_bwd})", flush=True)
    if launches["fwd"] == 0 or launches["bwd"] == 0:
        fail("the card run launched no RG-LRU scan kernel")
    if launches["fwd"] != want_fwd or launches["bwd"] != want_bwd:
        fail("RG-LRU launch counts differ from the training schedule")
    if launches["sinkhorn"] != card["solves"] * per_solve:
        fail(f"sinkhorn launched {launches['sinkhorn']} times for "
             f"{card['solves']} solves")
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
    sinkhorn.LAUNCHES = 0
    rk.LAUNCHES.update(fwd=0, bwd=0)
    hw = forecast_cell(tele, jobs, cap, None, "holtwinters")
    report_cell("card", hw)
    print(f"    holtwinters: {hw['fits']} fits; forecast MAPE "
          f"{hw['pipe'].forecast_mape:.4f} %; deferred "
          f"{hw['deferred_pct']:.3f} % of jobs; sinkhorn launches "
          f"{sinkhorn.LAUNCHES}, rglru_scan {rk.LAUNCHES}", flush=True)
    if sinkhorn.LAUNCHES != hw["solves"] * per_solve:
        fail("the holtwinters run did not solve through the kernel")
    return dict(launches=launches, card=card, hw_sinkhorn=sinkhorn.LAUNCHES)


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
    _build.build(["sinkhorn", "rglru_scan"])
    _build.library("sinkhorn")
    _build.library("rglru_scan")
    print(f"built the sinkhorn and rglru_scan kernels in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)",
          flush=True)
    k = phase_kernel(dev)
    phase_round(dev)
    e2e = phase_e2e(dev)
    scan = phase_scan(dev)
    fc = phase_forecast(*e2e["cell"])
    t = k["timings"][(512, 6)]           # the bucket of phase 3's rounds
    kernels = [dict(
        name="sinkhorn_iteration", route="cuda",
        source="src/repro_torch/csrc/sinkhorn.cu",
        replaces="src/repro/kernels/sinkhorn/sinkhorn.py:83",
        launches=e2e["launches"],
        launches_forecast_round=fc["launches"]["sinkhorn"],
        max_abs_err=max(k["max_abs_err"], e2e["max_abs_err"]),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        device_ms=t["device_ms"], plain_device_ms=t["plain_device_ms"],
        bound_by=t["bound_by"], library_ms=None, shape=[512, 6],
        launches_per_call=sinkhorn.LAUNCHES_PER_ITERATION,
        forecast_shape=dict(shape=[512, 40], **k["timings"][(512, 40)]))]
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
    kernels[1]["infer_shape"] = dict(shape=[16, 48, 16], **infer)
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
