"""Smoke run of the PyTorch port on one CUDA card (an H100).

Builds the port's kernels from the sources in this checkout, then:

  1. holds the Sinkhorn kernels against their plain PyTorch versions on the
     card, at the shapes the scheduling round gives them: one iteration
     (two launches) at each shape and eps, and the whole annealed solve in
     one launch, which must also equal the loop of 360 iterations bit for
     bit; the warm-started, convergence-exit launch, cold at (512, 6),
     (512, 40) and (16384, 40) (a 64-block grid, waited on under a
     timeout) and warm from a drifted instance at (512, 40) and (2048, 40),
     which must equal the host loop of iteration launches under the same
     exit rule in f, g and iterations used, bit for bit; times all of them
     (the adaptive launch cold and warm beside the fixed 360-iteration
     launch on the same inputs);
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
  4. holds the RG-LRU kernels against their plain versions, forward and
     backward: the fused layer (gate math + recurrence, one launch each
     way) and the scan alone, at the learned forecaster's shapes, the
     reference tests' odd shapes, a case at the sqrt factor's 1e-12 clamp
     and griffin's [4, 2048, 2560] (recurrentgemma-2b's prefill, phase 8's
     path); times them beside the eager
     composition the fused pair replaces (gate math + scan kernel), the
     plain versions and their bounds;
  5. drives the forecast-driven round end to end — ``EventSimulator`` +
     ``forecast_pipeline(forecaster="learned", backend="fused")`` — on the
     same cell, on the card and on the CPU, compares the two, checks the
     fused kernels' launch counts against the training schedule, profiles
     one training step (device kernels, aten operations, wall), and runs
     ``forecaster="holtwinters"`` on the card once;
  6. holds the flash-attention kernels (bf16 D 64/128/256 on wgmma tensor
     cores; float32 and bf16 D 16 on the scalar kernel) and the SSD-scan
     kernels (bf16 P 64 on the chunk-parallel wgmma kernel; float32 and
     other shapes on the scalar kernel) against their plain versions on
     the card (the reference kernel tests' shapes, GQA, ragged lengths,
     windows, non-causal, chunks of 64 to 256, the qwen2-1.5B and
     mamba2-2.7B prefill shapes, the latter at B 4 and B 1, and the gemma
     models' per-call D 256 prefill shapes, where the scalar flash kernel
     is held and timed on the same bf16 inputs as the yardstick it was;
     the flash wrapper on the model layout, which the wgmma kernel reads
     and writes in place: MLA's unequal head dims on the wgmma kernel's
     own (96, 64) and (192, 128) instantiations in bf16 (zero-padded to
     D 128 and 256 for the scalar kernel in float32), non-causal calls
     with Sq != Skv under GQA, in both types, and the five newer models'
     prefill calls at B 4, S 2048 — minicpm3-4B's and DeepSeek-V2's MLA,
     DBRX, the vision model's self- and cross-attention to 4096 image
     tokens, SeamlessM4T's encoder, cross- and self-attention — with
     mutants the holds must catch: MLA's RoPE columns dropped, MLA at
     1/sqrt(D_v), a non-causal call's last kv tile dropped) and times
     them beside the plain versions, their bounds and, for attention,
     ``scaled_dot_product_attention``; the two SSD kernels on the same
     bf16 inputs; both SSD kernels from an initial state h0 (mamba2-2.7B's
     prefill shape, a ragged S, float32 on the scalar kernel) against the
     plain version with the same ``init_state``, timed beside the call
     from zero and the final-state-from-zero entry (``ssd_final_cuda``,
     held to the plain final from zero); a sequence of 32768 positions at
     mamba2-2.7B's widths split after 28672 (the tail, 16 chunks, from
     the head's float32 final) against the whole run, and from the bf16
     final (printed); the calls without h0 bitwise their outputs before
     h0 (``PARENT_SSD_DIGESTS``); checks that a causal or sliding prefill
     attention with Sq != Skv raises, that both kernels' launchers refuse
     an input that requires grad under grad (they are forward-only), and
     that their public wrappers carry its gradient;
  7. serves qwen2-1.5B and mamba2-2.7B at depth 2, gemma3-4B at depth 6
     (five local layers, one global), recurrentgemma-2B at depth 4 (one
     group of two RG-LRU layers and a local attention layer, then one
     RG-LRU layer), minicpm3-4B at depth 2, DeepSeek-V2 at depth 2 (its
     dense layer and one MoE layer), DBRX at depth 1, llama-3.2-vision-11B
     at depth 5 (one cross layer with live gates and four decoder layers;
     4096 image tokens) and SeamlessM4T-large-v2 at 1 + 1 layers (400
     frames), all at full width in float32, through ``Server.generate`` on
     the card and on the CPU (the same weights) and compares logits and
     tokens, with one scalar flash call per prefill attention and no call
     of a plain version in the card's generate;
  8. serves all nine in bf16 on the card (B 4, prompt 2048, 32 new
     tokens; full depth but DeepSeek-V2 cut to its dense layer and six MoE
     layers and DBRX to eight layers, to fit one card; 2048 frames and
     4096 image tokens), reports prefill tokens/s, decode ms per step,
     peak memory and the profiled prefill's busy share, and checks the
     kernel calls of each prefill (one wgmma flash call per prefill
     attention, counted by (D_qk, D_v) and causality: 128 for qwen2-1.5B,
     DBRX and the vision model, 256 for the gemma models, 64 for
     SeamlessM4T, (96, 64) for minicpm3-4B's MLA and (192, 128) for
     DeepSeek-V2's; one
     wgmma SSD call a layer for mamba2-2.7B, one fused RG-LRU launch a
     recurrent layer for recurrentgemma-2B, no scalar flash call), that
     no plain version ran and that the vision model's cross layers change
     its logits;
  9. runs the paper's comparison on the cell of phases 3 and 5, built by
     the port's scenario registry, through a serial ``ExperimentPlan`` of
     policy specs (the six §5 rule schedulers, ``waterwise[backend=fused]``
     and ``waterwise-forecast[forecaster=learned,backend=fused]``) on the
     card: prints the tidy table with savings against ``baseline`` and each
     cell's wall time, checks that the two pipeline rows equal phases 3 and
     5 (totals and kernel launch counts), runs four policies again through
     the auto-sized ``"process"`` executor (spawned workers, at most
     ``CARD_WORKERS`` on the card; rows equal the serial ones, no kernel
     rebuilt; the device memory the pool held is printed), checks that the ``scipy`` backend is
     registered, and validates phase 3's trace with
     ``python -m repro_torch.obs.report``;
 10. many cells on one card: holds the cell-batched annealed Sinkhorn
     launch bitwise against one single-cell launch a cell (B 1, 3, 8 at
     buckets 512 and 4096 with 6 columns and bucket 512 with 40; 20 cells
     at bucket 16384, which must split into several launches) and against
     its plain version, and times 8 cells in one launch beside 8 single
     launches; runs ``waterwise[backend=fused]`` on the cell over 8 seeds
     plus ``baseline`` through the ``serial`` and the ``device`` executor
     (rows equal, launch counts and walls printed); runs the cell through
     ``"sharded[shards=2]"`` for ``baseline`` (speculative, spawned
     workers) and ``waterwise[backend=fused]`` (chained handoff), rows
     equal to phase 9's serial ones; and records every window of the cell
     (``record_windows=true``) and replays them through ``solve_many`` on
     the card;
 11. the live service (``repro_torch.serve``) on the card: (a) the cell of
     phases 3 and 5 streamed through a ``DecisionLoop`` over
     ``ReplayArrivals`` with ``waterwise-forecast[forecaster=holtwinters,
     backend=fused,warm=true]`` — records equal to the batch run of the
     same policy, totals within 0.5 % of ``warm=false``, one warm-started
     Sinkhorn launch a round; (b) a Poisson burst storm (11.57 jobs/s,
     bursts x5, tolerance 4, 1.2 hours) with re-planning and a bounded
     drop-oldest admission queue — every shed job accounted; (c) a
     workflow (DAG) cell under ``waterwise[backend=fused]``, streamed and
     in batch — records equal, no task started before a predecessor ended.
 12. LM training through ``make_train_step`` (AdamW, remat "full"): (a)
     one float32 step of qwen2-1.5B at depth 2, recurrentgemma-2B at depth
     3 and mamba2-2.7B at depth 2 (full width, B 2, S 256) on the card
     and on the CPU from the same weights and tokens — loss, grad_norm,
     first moments and updates compared; (b) qwen2-1.5B at full width and
     depth in bf16, 6 steps of ``SyntheticTokens`` at global batch 8 x
     2048 in two microbatches at AdamW's default schedule — every later
     step's loss below the first's, exactly 112 wgmma
     flash launches a step, the plain versions only inside the wrappers'
     backwards; step wall, tokens/s, 6 N tokens/s against the bf16 peak,
     peak memory, the plain backwards' device time, a profiled step's busy
     share and top kernels; (c) one bf16 step each of recurrentgemma-2B
     (6 layers), mamba2-2.7B (4), minicpm3-4B (2) and SeamlessM4T (1 + 1,
     400 frames) at B 2, S 2048 — exact launch counts of the D 256 flash,
     the fused RG-LRU pair, the wgmma SSD, MLA's (96, 64) flash and the
     D 64 flash, every gradient leaf finite and not all zero.
 13. distribution: (a) qwen2-72B at full width, its depth cut to 16 of 80
     layers, served in bf16 as phase 8 serves (B 4, prompt 2048, 32 new
     tokens) — exactly 16 wgmma flash launches a prefill at 64 query
     heads over 8 kv heads, the first call held against the plain
     version, prefill tokens/s, decode ms a token, peak memory; (b) the
     sharded ``make_train_step`` on a one-rank NCCL process group and a
     (1, 1) ("data", "model") mesh — qwen2-1.5B at depth 2 in float32,
     every parameter and moment a DTensor on the card, loss, grad_norm and
     every leaf bitwise the unsharded step's, phase 12(a)'s launches, and
     a checkpoint of the sharded state restored onto the mesh bit for
     bit; (d) on the same mesh, the sharded ``make_prefill_step`` /
     ``make_decode_step`` (parameters and caches as DTensors placed by
     their logical axes) of qwen2-1.5B at full depth, mamba2-2.7B at 4
     layers and recurrentgemma-2B at 3, bf16, B 4, prompt 2048, 32 new
     tokens — the prefill logits and every token bitwise the unsharded
     steps', the same kernel launches (28 wgmma flash calls a qwen2-1.5B
     prefill, the wgmma SSD, ``rglru_layer_fwd``), no plain version;
     (e) qwen2-72B whole as rank 0 of an 8-way tensor-parallel
     deployment over a fake process group (its collectives return at
     once: one rank's compute), B 4 x 2048 prefill and 32 decode steps —
     80 wgmma flash launches at the rank's 8 q heads, no plain version,
     the rank's logits blocks finite; (f) DeepSeek-V2-236B whole, 60
     layers, the same way as rank 0 of 8 (MLA at 16 of 128 heads, 20 of
     160 routed experts: 60 ``flash_fwd_sm90<192, 128>`` launches); (g)
     mamba2-2.7B (4 layers) and recurrentgemma-2B (3) at full width as
     rank 0 of 2 (the wgmma SSD at 40 heads, ``rglru_layer_fwd`` at 1280
     channels, the D 256 flash at 5 q heads) — each first kernel call
     held against its plain version and timed at its shape beside its
     bound; (i) context parallelism: both flash kernels at query offsets
     (off the tile grid, windows, MLA, float32) against the plain version,
     and at offset 0 bitwise their outputs before the offset (digests);
     then qwen2-72B at 16 layers, bf16, a batch-1 prefill of 32768
     positions as the last of 8 sequence segments over ``data`` (rank 7
     of the fake process group) — 16 ``flash_fwd_sm90<128, 128>``
     launches of 4096 queries at offset 28672 against 32768 keys, no
     plain version, the first held against the plain version and timed
     beside it, SDPA with the offset-causal mask and its bound; (j)
     mamba2-2.7B at all 64 layers the same way, bf16, the last of 8
     segments of a 32768-position prefill — each layer's SSD one launch
     of the final-state-from-zero entry and one wgmma scan from the
     carried state (64 + 64), no plain version, the first from h0 held
     against the plain version; (c) the
     dry run of qwen2-72B train_4k on the 16x16 and 2x16x16
     production meshes: per-device bytes, and per-device FLOPs, bytes,
     collectives and roofline at 2 of 80 layers from ``python -m
     repro_torch.launch.dryrun`` over a fake process group.

The LM weights are random, drawn from a seed; the Mamba-2 mixers' conv and
SSM scalars, the RG-LRU blocks' conv, gate biases and decay and the vision
cross layers' gates are drawn live (``models.ssm.draw_live_mixer``,
``models.rglru.draw_live_block``, ``models.transformer.draw_live_gates``),
since the reference's zero convs would feed both recurrences exact zeros
and its zero gates make every cross layer the identity.

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
import shutil
import subprocess
import sys
import tempfile
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
# RG-LRU kernels vs plain versions on the card: the kernels' steps are one
# fmaf where the plain version multiplies and adds (two roundings), and
# their chunk carries come from the combine; the reference's own kernel
# test holds its scan to the same 1e-4.
SCAN_ATOL = 1e-4
# At the clamp (pre_r <= -40, 1 - exp(2 log_a) = 0) every gradient through
# the gates is at most ~1e-5, so each is held relative to its largest
# element: the sqrt factor's slope is 0 in both, the rest is exp's and
# sigmoid's last bits in two libraries.
CLAMP_RTOL = 1e-3
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


def device_us_by_kernel(fn, reps: int = 10) -> dict:
    """Device us per call of each kernel ``fn()`` launches, by the
    profiler: {kernel name: us} (the port's SSD kernels by their own
    names)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            name = re.search(r"ssd_[a-z_]+", ev.key)
            name = name.group(0) if name else ev.key[:40]
            out[name] = round(ev.self_device_time_total / reps, 2)
    return out


def main_path_inputs(M: int, N: int, eps: float, dev, seed: int,
                     drift: float = 0.0):
    """(C, g, log_a, log_b) as a round of bucket M feeds the iteration:
    normalized costs with forbidden arcs priced at BIG, a dummy slack row,
    zero-mass padding rows (log_a = _NEG), and g after a few iterations.
    ``drift`` multiplies the raw costs by ``1 + drift * noise`` (the next
    round of a drifting service)."""
    from repro_torch.core import round as port_round
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_iteration_ref
    rng = np.random.default_rng(seed)
    jobs = max(1, (3 * M) // 4 - 1)
    pad = M - 1 - jobs
    cost = rng.random((jobs, N)) * 10
    allowed = rng.random((jobs, N)) > 0.2
    allowed[np.arange(jobs), rng.integers(0, N, jobs)] = True
    cap = np.full(N, jobs // N + 2, np.float32)
    cost = cost * (1 + drift * np.random.default_rng(seed + 1)
                   .standard_normal(cost.shape))
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


def synchronize_within(seconds: float, what: str) -> None:
    """Wait for the card's work so far, failing after ``seconds``: a
    cooperative grid whose blocks disagree on an exit waits at a grid sync
    forever, and a plain synchronize would wait with it."""
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            print(f"FAIL: {what} did not finish within {seconds} s",
                  flush=True)
            os._exit(1)
        time.sleep(0.001)


def adaptive_loop(C, log_a, log_b, g0, tol, table, iters):
    """The warm-started solve's exit rule read on the host over launches of
    the iteration kernel (2 launches and one device-to-host read an
    iteration): the bitwise yardstick of the one-launch adaptive solve."""
    from repro_torch.kernels.sinkhorn import sinkhorn
    tol32 = torch.tensor(tol, dtype=torch.float32)
    f, g, used = torch.zeros_like(log_a), g0, 0
    for eps in table:
        for _ in range(iters):
            f, g_new = sinkhorn.sinkhorn_iteration_cuda(C, g, log_a, log_b,
                                                        eps)
            delta = (g_new - g).abs().max()
            g, used = g_new, used + 1
            if not bool(delta.cpu() > tol32):
                break
    return f, g, used


def adaptive_case(M: int, N: int, dev, seed: int, warm: bool):
    """(C, log_a, log_b, g0, table, iters) of the warm-started solve as the
    forecast round runs it: cold, from g = 0 over the 6 x 60 schedule; or
    warm, one final-eps stage capped at 360 on the instance drifted by 3 %,
    from the cold solve's g."""
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn import sinkhorn
    C, _, log_a, log_b = main_path_inputs(M, N, 0.5, dev, seed)
    g0 = torch.zeros(N, dtype=torch.float32, device=dev)
    table = torch_solver.eps_schedule(torch_solver.SINKHORN_EPS0, 0.005,
                                      torch_solver.SINKHORN_STAGES).tolist()
    if not warm:
        return C, log_a, log_b, g0, table, torch_solver.SINKHORN_ITERS
    _, g_cold, _ = sinkhorn.sinkhorn_solve_adaptive_cuda(
        C, log_a, log_b, g0, torch_solver.SINKHORN_TOL, table,
        torch_solver.SINKHORN_ITERS)
    C, _, log_a, log_b = main_path_inputs(M, N, 0.5, dev, seed, drift=0.03)
    return (C, log_a, log_b, g_cold, table[-1:],
            torch_solver.SINKHORN_ITERS * torch_solver.SINKHORN_STAGES)


def hold_adaptive(M: int, N: int, seed: int, warm: bool) -> tuple:
    """The warm-started, convergence-exit launch at (M, N) against the host
    loop of iteration launches under the same exit rule (f, g and the
    iterations used: bitwise) and against the plain loop (KERNEL_ATOL;
    padding rows relative). Returns (max(|df|, |dg|) against the plain
    loop, iterations used)."""
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_adaptive_ref
    tol = torch_solver.SINKHORN_TOL
    C, log_a, log_b, g0, table, iters = adaptive_case(
        M, N, torch.device("cuda"), seed, warm)
    f_a, g_a, used = sinkhorn.sinkhorn_solve_adaptive_cuda(
        C, log_a, log_b, g0, tol, table, iters)
    synchronize_within(120.0, f"the adaptive launch at M={M} N={N}")
    f_l, g_l, used_l = adaptive_loop(C, log_a, log_b, g0, tol, table, iters)
    f_r, g_r, used_r = sinkhorn_solve_adaptive_ref(C, log_a, log_b, g0, tol,
                                                   table, iters)
    torch.cuda.synchronize()
    same = torch.equal(f_a, f_l) and torch.equal(g_a, g_l) and \
        int(used) == used_l
    df = f_error(f_a, f_r, log_a)
    dg = (g_a - g_r).abs().max().item()
    name = "warm" if warm else "cold"
    print(f"  adaptive {name} M={M:6d} N={N:3d} ({-(-M // 256)} blocks): "
          f"{int(used)} iterations, the iteration loop {used_l} (f, g "
          f"bitwise equal: {torch.equal(f_a, f_l) and torch.equal(g_a, g_l)})"
          f"; vs plain ({int(used_r)} iterations) max|df|={df:.3e} "
          f"max|dg|={dg:.3e}", flush=True)
    if not same:
        fail(f"adaptive launch differs from the iteration loop at M={M} "
             f"N={N} ({name})")
    if not (np.isfinite(df) and np.isfinite(dg)) or max(df, dg) > \
            KERNEL_ATOL:
        fail(f"adaptive launch disagrees with the plain loop at M={M} "
             f"N={N} ({name}): {df:.3e} / {dg:.3e}")
    return max(df, dg), int(used)


def time_adaptive(M: int, N: int, warm: bool, dev) -> dict:
    """The adaptive launch at (M, N), cold or warm, by events and device
    time, beside the fixed-schedule launch on the same C and the plain
    loop; the bound counts the iterations this solve used."""
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_adaptive_ref
    tol = torch_solver.SINKHORN_TOL
    C, log_a, log_b, g0, table, iters = adaptive_case(M, N, dev, seed=7,
                                                      warm=warm)
    fixed_table, fixed_iters = solve_schedule()

    def kernel():
        return sinkhorn.sinkhorn_solve_adaptive_cuda(C, log_a, log_b, g0, tol,
                                                     table, iters)

    def fixed():
        return sinkhorn.sinkhorn_solve_cuda(C, log_a, log_b, fixed_table,
                                            fixed_iters)

    def plain():
        return sinkhorn_solve_adaptive_ref(C, log_a, log_b, g0, tol, table,
                                           iters)
    used = int(kernel()[2])
    # C, log_a, log_b and g0 read once, f, g and the count written once;
    # ~12 float32 operations per element per iteration used.
    t = dict(used=used, ms=cuda_ms(kernel, warmup=3, reps=20),
             device_ms=profiled_device_ms(kernel, reps=5),
             fixed_ms=cuda_ms(fixed, warmup=1, reps=10),
             fixed_device_ms=profiled_device_ms(fixed, reps=3),
             ms_again=cuda_ms(kernel, warmup=1, reps=20),
             plain_ms=cuda_ms(plain, warmup=1, reps=2),
             **bound(4 * (M * N + M + N + N + M + N) + 4,
                     12 * M * N * used))
    print(f"  timing adaptive {'warm' if warm else 'cold'} M={M} N={N}: "
          f"{used} iterations in one launch {t['ms'] * 1e3:.2f} us/solve "
          f"({t['ms_again'] * 1e3:.2f} us again; device "
          f"{fmt_us(t['device_ms'])}); the fixed 360-iteration launch "
          f"{t['fixed_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['fixed_device_ms'])}); plain loop "
          f"{t['plain_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.4f} us "
          f"({t['bound_by']})", flush=True)
    return t


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
    # The warm-started, convergence-exit launch (the live service's round):
    # cold at the round's buckets and at 16384 (a 64-block grid, every
    # block deciding each exit alone), warm from a drifted instance.
    adaptive_worst = 0.0
    for M, N, warm in ((512, 6, False), (512, 40, False), (16384, 40, False),
                       (512, 40, True), (2048, 40, True)):
        err, _ = hold_adaptive(M, N, seed=M + N, warm=warm)
        adaptive_worst = max(adaptive_worst, err)
    adaptive_t = {(warm, M, N): time_adaptive(M, N, warm, dev)
                  for warm, M, N in ((False, 512, 40), (True, 512, 40),
                                     (True, 2048, 40))}
    return dict(max_abs_err=worst, timings=timings,
                anneal_max_abs_err=anneal_worst, anneal_timings=anneal_t,
                adaptive_max_abs_err=adaptive_worst,
                adaptive_timings=adaptive_t)


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


# The cell of phases 3, 5 and 9, as a scenario spec of the port's registry.
CELL = "diurnal[days=0.05,jobs_per_day=1e6,tolerance=0.5,seed=3]"


def diurnal_cell():
    """``CELL`` built by the port's scenario registry: (telemetry, jobs,
    capacity)."""
    from repro_torch import experiments
    inst, _ = experiments.build_instance(CELL)
    return inst.tele, inst.jobs, inst.capacity


STAGES = ("engine.round", "policy.admit", "policy.build", "policy.forecast",
          "forecast.fit", "forecast.infer", "policy.price",
          "solver.fused_round", "policy.solve", "solver.solve",
          "policy.extract")
SOLVE_SPANS = ("solver.solve", "solver.fused_round")


def run_cell(tele, jobs, cap, device, pipe=None, trace_path=None):
    """One traced run of the cell through ``pipe`` (default: the reactive
    pipeline, backend ``fused``, on ``device``). Returns the engine result,
    its summary, wall time, per-stage span totals and the solver buckets
    seen. The trace is kept at ``trace_path`` when one is given."""
    import tempfile

    import repro_torch.obs as obs
    from repro_torch.policy.pipeline import reactive_pipeline
    from repro_torch.sim.engine import EventSimulator, SimConfig
    from repro_torch.sim.metrics import summarize
    if pipe is None:
        pipe = reactive_pipeline(tele, backend="fused", device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "run.trace.jsonl")
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


def phase_e2e(dev, trace_path: str) -> dict:
    from repro_torch.kernels.sinkhorn import sinkhorn
    print("== phase 3: reactive WaterWise round end to end", flush=True)
    tele, jobs, cap = diurnal_cell()
    print(f"  cell {CELL}: {len(jobs)} jobs, {tele.num_regions} regions, "
          f"capacity {cap.tolist()}", flush=True)
    sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES = 0, 0
    card = run_cell(tele, jobs, cap, None, trace_path=trace_path)
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
                cell=(tele, jobs, cap), trace=trace_path)


def scan_inputs(B: int, S: int, W: int, dev, seed: int):
    """(a, bx, w) as the scan takes them: decays in (0, 0.95), gated
    inputs and an output cotangent, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand((B, S, W), generator=gen) * 0.95
    bx = torch.randn((B, S, W), generator=gen)
    w = torch.randn((B, S, W), generator=gen)
    return a.to(dev), bx.to(dev), w.to(dev)


def layer_inputs(B: int, S: int, W: int, dev, seed: int,
                 clamp: bool = False):
    """(pre_r, pre_i, x, lam, w) as the learned forecaster's block feeds
    the fused layer (gate pre-activations of unit scale, lam of scale 0.5)
    and an output cotangent, from a seed. ``clamp`` shifts pre_r to
    [-60, -40], where 1 - exp(2 log_a) is 0 and takes the 1e-12 floor."""
    gen = torch.Generator().manual_seed(seed)
    pre_r = torch.randn((B, S, W), generator=gen) - (50.0 if clamp else 0.0)
    pre_i = torch.randn((B, S, W), generator=gen)
    x = torch.randn((B, S, W), generator=gen)
    lam = torch.randn((W,), generator=gen) * 0.5
    w = torch.randn((B, S, W), generator=gen)
    return tuple(t.to(dev) for t in (pre_r, pre_i, x, lam, w))


def grads(fn, inputs, w):
    """(output, gradients of sum(w * fn(*inputs)) in every input)."""
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*inputs)
    g = torch.autograd.grad((w * y).sum(), inputs)
    return y.detach(), g


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> dict:
    """The least time for the work: bytes over the HBM rate or operations
    over the peak rate of their type, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / ops_per_s * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                nbytes=nbytes, nops=nops)


# Phase 4's shapes: the learned forecaster's training, validation and
# inference batches, the reference kernel tests' odd shapes, a wide one,
# and griffin's lru_width at B 4, S 2048 (recurrentgemma_2b's prefill).
SCAN_SHAPES = ((64, 48, 16), (75, 48, 16), (16, 48, 16), (5, 29, 16),
               (2, 7, 15), (2, 128, 128), (4, 2048, 2560))
GRIFFIN = (4, 2048, 2560)
# Operations an element, counting each exp, log1p, sqrt and division as
# one: the fused forward's gate math and step (17), its backward's
# recomputed gates, reverse step and chain rule (40); the scan alone's step
# (2) and its backward's step and da (3).
LAYER_FWD_OPS, LAYER_BWD_OPS, SCAN_FWD_OPS, SCAN_BWD_OPS = 17, 40, 2, 3


def hold_layer(shape, clamp: bool, dev, seed: int) -> tuple:
    """The fused layer, forward and backward (one launch each), against
    autograd through its plain version on the card. Returns (max|dy|, the
    gradients' max|d|, the gradient error held to its limit): the max|d|
    over the four gradients, held to SCAN_ATOL, or in the clamp case, where
    every gradient through the gates is tiny, max|d| / max|ref| for each
    gradient, held to CLAMP_RTOL."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.rglru_scan.ref import rglru_layer_ref
    *inputs, w = layer_inputs(*shape, dev, seed=seed, clamp=clamp)
    before = dict(rk.LAUNCHES)
    y_k, g_k = grads(ops.rglru_layer, inputs, w)
    if (rk.LAUNCHES["layer_fwd"], rk.LAUNCHES["layer_bwd"]) != (
            before["layer_fwd"] + 1, before["layer_bwd"] + 1):
        fail(f"the fused layer did not launch once each way at {shape}")
    y_r, g_r = grads(rglru_layer_ref, inputs, w)
    fwd = (y_k - y_r).abs().max().item()
    bwd_abs = max((k - r).abs().max().item() for k, r in zip(g_k, g_r))
    if clamp:
        bwd = max((k - r).abs().max().item() / r.abs().max().item()
                  for k, r in zip(g_k, g_r))
        what = f", max|d| / max|ref| {bwd:.3e} (limit {CLAMP_RTOL:.0e})"
        limit = CLAMP_RTOL
    else:
        bwd, limit, what = bwd_abs, SCAN_ATOL, f" (limit {SCAN_ATOL:.0e})"
    print(f"  layer {shape}{' at the clamp' if clamp else ''}: max|dy| "
          f"{fwd:.3e}; grads (pre_r, pre_i, x, lam) max|d| {bwd_abs:.3e}"
          f"{what}", flush=True)
    if not (np.isfinite(fwd) and fwd <= SCAN_ATOL):
        fail(f"fused forward disagrees at {shape}: {fwd:.3e}")
    if not (np.isfinite(bwd) and bwd <= limit):
        fail(f"fused backward disagrees at {shape}: {bwd:.3e}")
    return fwd, bwd_abs, bwd


def hold_scan(shape, dev, seed: int) -> tuple:
    """The scan alone, forward and backward, against autograd through the
    plain loop on the card: (forward error, gradient error)."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    a, bx, w = scan_inputs(*shape, dev, seed=seed)
    before = dict(rk.LAUNCHES)
    y_k, g_k = grads(ops.rglru_scan, (a, bx), w)
    if (rk.LAUNCHES["fwd"], rk.LAUNCHES["bwd"]) != (before["fwd"] + 1,
                                                    before["bwd"] + 1):
        fail(f"the scan did not launch once each way at {shape}")
    y_r, g_r = grads(rglru_scan_ref, (a, bx), w)
    fwd = (y_k - y_r).abs().max().item()
    bwd = max((k - r).abs().max().item() for k, r in zip(g_k, g_r))
    print(f"  scan {shape}: max|dy| {fwd:.3e}, max|d grad| {bwd:.3e}",
          flush=True)
    if not all(np.isfinite(e) and e <= SCAN_ATOL for e in (fwd, bwd)):
        fail(f"scan disagrees at {shape}: {fwd:.3e} / {bwd:.3e}")
    return fwd, bwd


def time_kernel(kernel, plain, b: dict, composition=None,
                plain_reps: int = 200) -> dict:
    """Events and profiled device time of ``kernel``, of ``plain`` and of
    ``composition`` (the eager gate math around the scan-only kernel that
    the fused kernel replaces), with the bound ``b``."""
    t = dict(ms=cuda_ms(kernel), device_ms=profiled_device_ms(kernel),
             plain_ms=cuda_ms(plain, warmup=min(20, plain_reps),
                              reps=plain_reps),
             plain_device_ms=profiled_device_ms(plain,
                                                reps=min(50, plain_reps)),
             **b)
    if composition is not None:
        t.update(composition_ms=cuda_ms(composition),
                 composition_device_ms=profiled_device_ms(composition))
    return t


def report_timing(name: str, shape, t: dict) -> None:
    comp = ("" if "composition_ms" not in t else
            f", gates + scan kernel {t['composition_ms'] * 1e3:.2f} us "
            f"(device {fmt_us(t['composition_device_ms'])})")
    print(f"  timing {name} {shape}: kernel {t['ms'] * 1e3:.2f} us/call "
          f"(device {fmt_us(t['device_ms'])}){comp}, plain "
          f"{t['plain_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['plain_device_ms'])}), bound "
          f"{t['bound_ms'] * 1e3:.4f} us ({t['bound_by']})", flush=True)


def phase_scan(dev) -> dict:
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.rglru_scan.ref import (rglru_gates,
                                                    rglru_layer_ref,
                                                    rglru_scan_bwd_ref,
                                                    rglru_scan_ref)
    print("== phase 4: RG-LRU kernels (the fused layer, the scan alone) vs "
          "plain versions on the card", flush=True)
    worst = dict(layer_fwd=0.0, layer_bwd=0.0, fwd=0.0, bwd=0.0)
    for shape in SCAN_SHAPES:
        fwd, bwd, _ = hold_layer(shape, False, dev, seed=sum(shape))
        worst["layer_fwd"] = max(worst["layer_fwd"], fwd)
        worst["layer_bwd"] = max(worst["layer_bwd"], bwd)
    fwd, bwd_abs, clamp_rel = hold_layer((4, 48, 16), True, dev, seed=7)
    worst["layer_fwd"] = max(worst["layer_fwd"], fwd)
    worst["layer_bwd"] = max(worst["layer_bwd"], bwd_abs)
    for shape in SCAN_SHAPES:
        fwd, bwd = hold_scan(shape, dev, seed=sum(shape) + 1)
        worst["fwd"] = max(worst["fwd"], fwd)
        worst["bwd"] = max(worst["bwd"], bwd)
    timings = {}
    for shape in ((64, 48, 16), (16, 48, 16), GRIFFIN):
        pre_r, pre_i, x, lam, gy = layer_inputs(*shape, dev, seed=3)
        n, W = pre_r.numel(), shape[-1]
        # The plain versions at griffin's shape take seconds a call: one
        # warm-up and one timed call each.
        reps = 1 if shape == GRIFFIN else 200
        # Forward: pre_r, pre_i, x, lam in, y out.
        timings[("layer_fwd", shape)] = time_kernel(
            lambda: rk.rglru_layer_fwd_cuda(pre_r, pre_i, x, lam),
            lambda: rglru_layer_ref(pre_r, pre_i, x, lam),
            bound(4 * (4 * n + W), LAYER_FWD_OPS * n),
            composition=lambda: rk.rglru_scan_fwd_cuda(
                *rglru_gates(pre_r, pre_i, x, lam)), plain_reps=reps)
        # The scan alone on the gates of the same inputs: a, bx in, y out.
        a, bx = rglru_gates(pre_r, pre_i, x, lam)
        timings[("fwd", shape)] = time_kernel(
            lambda: rk.rglru_scan_fwd_cuda(a, bx),
            lambda: rglru_scan_ref(a, bx),
            bound(3 * 4 * n, SCAN_FWD_OPS * n), plain_reps=reps)
        # Backward: pre_r, pre_i, x, y, gy (and lam) in, d_pre_r, d_pre_i,
        # d_x (and d_lam) out. The plain and composed backwards replay a
        # graph built once.
        y = rk.rglru_layer_fwd_cuda(pre_r, pre_i, x, lam)
        live = [t.clone().requires_grad_(True) for t in (pre_r, pre_i, x,
                                                         lam)]
        y_plain = rglru_layer_ref(*live)
        a_l, bx_l = rglru_gates(*live)
        y_comp = ops.rglru_scan(a_l, bx_l)
        timings[("layer_bwd", shape)] = time_kernel(
            lambda: rk.rglru_layer_bwd_cuda(pre_r, pre_i, x, lam, y, gy),
            lambda: torch.autograd.grad(y_plain, live, gy,
                                        retain_graph=True),
            bound(4 * (8 * n + 2 * W), LAYER_BWD_OPS * n),
            composition=lambda: torch.autograd.grad(y_comp, live, gy,
                                                    retain_graph=True),
            plain_reps=reps)
        ys = rk.rglru_scan_fwd_cuda(a, bx)
        timings[("bwd", shape)] = time_kernel(
            lambda: rk.rglru_scan_bwd_cuda(a, ys, gy),
            lambda: rglru_scan_bwd_ref(a, ys, gy),
            bound(5 * 4 * n, SCAN_BWD_OPS * n), plain_reps=reps)
    for (name, shape), t in timings.items():
        report_timing(name, shape, t)
    return dict(worst=worst, clamp_rel=clamp_rel,
                timings=timings)


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


def train_step_profile(steps: int = 20, profiled: int = 5) -> dict:
    """AdamW steps of the learned forecaster on the card as ``fit`` takes
    them (the default config, a [64, 48] batch, ``scan_impl`` "kernel"):
    per step, the device kernels (copies and fills not counted), their
    device time and the forward's top-level aten operations (the backward's
    run under autograd nodes) over ``profiled`` profiled steps, and the
    median host wall of ``steps`` steps, each to a synchronize. Uses only
    names the forecaster has had since it was ported, so ``kernel_probe.py
    steps`` runs it on an older tree too."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.forecast import learned
    from repro_torch.optim import adamw, cosine_schedule
    f = learned.LearnedForecaster()
    dev = f.device
    params = learned.init_params(0, f.d_model, f.horizon, dev)
    opt = adamw(lr=cosine_schedule(f.lr, 30, 300),
                weight_decay=f.weight_decay)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    xb = torch.randn((f.batch, f.window), generator=gen).to(dev)
    yb = torch.randn((f.batch, f.horizon), generator=gen).to(dev)

    def step():
        return learned._train_step(opt, params, state, xb, yb, f.horizon,
                                   f.period, f.scan_impl)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    device = [ev for ev in prof.events()
              if str(ev.device_type).endswith("CUDA")
              and not ev.name.startswith(("Memcpy", "Memset"))]
    ops = sum(1 for ev in prof.events()
              if str(ev.device_type).endswith("CPU")
              and ev.name.startswith("aten::") and ev.cpu_parent is None)
    return dict(kernels=len(device) / profiled, ops=ops / profiled,
                device_ms=sum(ev.device_time_total for ev in device) / profiled
                / 1e3, steps=steps, wall_ms=float(np.median(walls)) * 1e3)


def phase_forecast(tele, jobs, cap) -> dict:
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.sinkhorn import sinkhorn
    print("== phase 5: forecast-driven WaterWise round end to end "
          "(learned forecaster)", flush=True)
    sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES = 0, 0
    rk.LAUNCHES.update(dict.fromkeys(rk.LAUNCHES, 0))
    card = forecast_cell(tele, jobs, cap, None, "learned")
    launches = dict(sinkhorn=sinkhorn.ANNEAL_LAUNCHES,
                    sinkhorn_iteration=sinkhorn.LAUNCHES, **rk.LAUNCHES)
    host = forecast_cell(tele, jobs, cap, "cpu", "learned")
    if dict(sinkhorn=sinkhorn.ANNEAL_LAUNCHES,
            sinkhorn_iteration=sinkhorn.LAUNCHES, **rk.LAUNCHES) != launches:
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
          f"rglru_layer fwd {launches['layer_fwd']} (want {want_fwd} = "
          f"{f.train_count} x ({steps} steps + {evals} validation passes) "
          f"+ {card['fits']} fits), bwd {launches['layer_bwd']} (want "
          f"{want_bwd}), scan alone fwd {launches['fwd']} bwd "
          f"{launches['bwd']} (want 0)", flush=True)
    if launches["layer_fwd"] == 0 or launches["layer_bwd"] == 0:
        fail("the card run launched no fused RG-LRU kernel")
    if (launches["layer_fwd"], launches["layer_bwd"], launches["fwd"],
            launches["bwd"]) != (want_fwd, want_bwd, 0, 0):
        fail("RG-LRU launch counts differ from the training schedule")
    step = train_step_profile()
    print(f"  a training step of the learned forecaster ([64, 48] batch, "
          f"profiled): {step['kernels']:.1f} device kernels of "
          f"{step['device_ms']:.3f} ms device time, {step['ops']:.1f} "
          f"top-level aten operations in the forward, "
          f"{step['wall_ms']:.3f} ms of wall (median of {step['steps']}); "
          f"forecast.fit {card['stages']['forecast.fit']:.3f} s of the "
          f"card run", flush=True)
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
    rk.LAUNCHES.update(dict.fromkeys(rk.LAUNCHES, 0))
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
    return dict(launches=launches, card=card, step=step,
                hw_sinkhorn=sinkhorn.ANNEAL_LAUNCHES)

# --- The LM serving path (phases 6-8) -----------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), at 700 W: the
# rate of the type the attention and SSD inputs come in.
BF16_OPS_PER_S = 989e12
# Flash attention, kernel vs plain version: the reference kernel tests'
# tolerances (float32 2e-5, bf16 2e-2); the model-layout GQA wrapper
# against the blocked twin, 3e-5 as in test_flash_attention_gqa.
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# ... and, relative to the output, RMS(d) / RMS(plain): where Skv is long
# and the mask full, an output element is ~sqrt(e / Skv) (0.026 at 4096),
# so FLASH_ATOL alone is as large as what it compares. bf16's output
# rounding alone reads ~1e-3; an MLA call at the wrong scale or without
# its RoPE columns, or a dropped kv tile, reads 1e-1 or more
# (``model_flash_timing`` launches them and fails if the limit would pass
# one).
FLASH_RRMS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
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
ARCHS = ("qwen2_1_5b", "mamba2_2_7b", "gemma3_4b", "recurrentgemma_2b",
         "minicpm3_4b", "deepseek_v2_236b", "dbrx_132b",
         "llama_3_2_vision_11b", "seamless_m4t_large_v2")
# Phase 7's depths: the smallest that hold every kind of layer. gemma3-4B's
# 6 is five local layers and one global; recurrentgemma-2B's 4 is one
# group (two RG-LRU layers, one local attention layer) and a one-layer
# tail; DeepSeek-V2's 2 its dense layer and one MoE layer; the vision
# model's 5 one group (a cross layer and four decoder layers);
# SeamlessM4T's 1 one decoder layer after one encoder layer.
PARITY_DEPTH = dict(qwen2_1_5b=2, mamba2_2_7b=2, gemma3_4b=6,
                    recurrentgemma_2b=4, minicpm3_4b=2, deepseek_v2_236b=2,
                    dbrx_132b=1, llama_3_2_vision_11b=5,
                    seamless_m4t_large_v2=1)
# Phase 8's depth cuts, to fit one card in bf16: DeepSeek-V2 keeps its
# dense layer and six MoE layers (a MoE layer is 3.97 B parameters, 7.9
# GB), DBRX eight layers (3.26 B, 6.5 GB each). The others run at full
# depth.
SERVE_DEPTH = dict(deepseek_v2_236b=7, dbrx_132b=8)
# Phase 7's encoder frames (Sq != Skv in the cross-attention) and phase
# 8's; vision's patches are the config's n_img_tokens (4096).
PARITY_FRAMES, SERVE_FRAMES = 400, 2048


def check(name: str, err: float, limit: float) -> float:
    if not np.isfinite(err) or err > limit:
        fail(f"{name}: max |d| {err:.3e} beyond {limit:.1e}")
    return err


def flash_diff(out, ref) -> tuple:
    """(max |d|, RMS(d) / RMS(ref)) of two same-shaped outputs, in
    float32."""
    d = out.float() - ref.float()
    rel = d.square().mean().sqrt() / ref.float().square().mean().sqrt()
    return d.abs().max().item(), rel.item()


def hold_flash(name: str, out, ref, dtype) -> tuple:
    """Holds ``out`` to the plain version's ``ref`` within FLASH_ATOL and
    FLASH_RRMS; returns (max |d|, relative RMS)."""
    err, rel = flash_diff(out, ref)
    check(name, err, FLASH_ATOL[dtype])
    if not np.isfinite(rel) or rel > FLASH_RRMS[dtype]:
        fail(f"{name}: RMS(d) / RMS(plain) {rel:.3e} beyond "
             f"{FLASH_RRMS[dtype]:.1e}")
    return err, rel


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
    err, rel = flash_diff(out, ref)
    print(f"  flash BH={BH} S={S} D={D} causal={causal} window={window} "
          f"{str(dtype)[6:]} group={group} ({kind} kernel): "
          f"max|do|={err:.3e}, rel RMS {rel:.3e}", flush=True)
    if fk.LAUNCHES_BY_VARIANT != {**before, kind: before[kind] + 1}:
        fail(f"flash attention did not launch its {kind} kernel once")
    hold_flash("flash attention", out, ref, dtype)
    return err, (q, k, v)


def flash_timing(D: int, seed: int) -> dict:
    """At the qwen2-1.5B prefill shape ([48, 2048, D] bf16, group 6,
    causal): the wgmma kernel, the scalar kernel on the same inputs in
    float32 (held to the plain version there), the plain version and
    scaled_dot_product_attention, each in both types, by CUDA events and
    by the profiler, beside each kernel's bound."""
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
    plain32 = lambda: flash_attention_bh_ref(q32, k32, v32, causal=True,
                                             group=group)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(*(t.view(4, -1, S, D) for t in (q, k, v)),
                           is_causal=True, enable_gqa=True)
    library32 = lambda: sdpa(*(t.view(4, -1, S, D) for t in (q32, k32, v32)),
                             is_causal=True, enable_gqa=True)
    ref = plain().float()
    err = (kernel().float() - ref).abs().max().item()
    lib_err = (library().reshape(BHq, S, D).float() - ref).abs().max().item()
    check("flash attention (wgmma) at the timed shape", err,
          FLASH_ATOL[torch.bfloat16])
    ref32 = plain32()
    scalar_err = (scalar() - ref32).abs().max().item()
    check("flash attention (scalar, float32) at the timed shape",
          scalar_err, FLASH_ATOL[torch.float32])
    del ref, ref32
    pairs = BHq * S * (S + 1) // 2             # the causal triangle
    elems = q.numel() + k.numel() + v.numel() + q.numel()
    t = dict(ms=cuda_ms(kernel, warmup=5, reps=50),
             device_ms=profiled_device_ms(kernel, reps=10),
             scalar_ms=cuda_ms(scalar, warmup=2, reps=5),
             scalar_device_ms=profiled_device_ms(scalar, reps=2),
             plain_ms=cuda_ms(plain, warmup=2, reps=5),
             plain_device_ms=profiled_device_ms(plain, reps=2),
             plain32_ms=cuda_ms(plain32, warmup=2, reps=5),
             library_ms=cuda_ms(library, warmup=5, reps=50),
             library_device_ms=profiled_device_ms(library, reps=10),
             library32_ms=cuda_ms(library32, warmup=3, reps=20),
             library32_device_ms=profiled_device_ms(library32, reps=5),
             max_abs_err=err, library_err=lib_err, scalar_err=scalar_err,
             scalar_bound=bound(4 * elems, 4 * pairs * D),
             **bound(2 * elems, 4 * pairs * D, BF16_OPS_PER_S))
    print(f"  timing flash at [48, 2048, {D}] group 6, causal: wgmma kernel "
          f"(bf16) {t['ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['device_ms'])}; max|d| vs plain {err:.3e}), scalar "
          f"kernel (float32) {t['scalar_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['scalar_device_ms'])}; max|d| vs plain "
          f"{scalar_err:.3e}; bound "
          f"{t['scalar_bound']['bound_ms'] * 1e3:.2f} us at the float32 "
          f"rate), plain {t['plain_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['plain_device_ms'])}; float32 "
          f"{t['plain32_ms'] * 1e3:.2f} us), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['library_device_ms'])}; max|d| vs plain "
          f"{lib_err:.3e}; float32 {t['library32_ms'] * 1e3:.2f} us, "
          f"device {fmt_us(t['library32_device_ms'])}), bound "
          f"{t['bound_ms'] * 1e3:.2f} us "
          f"({t['bound_by']}: {t['nops'] / 1e9:.2f} GFLOP at the bf16 "
          f"tensor-core rate, {t['nbytes'] / 1e6:.2f} MB)", flush=True)
    return t


# The gemma models' per-call flash shapes at B 4, S 2048, D 256 in bf16,
# which the wgmma kernel takes: gemma3-4B's 32 query heads over 16 kv
# heads on its 29 local layers (window 1024) and on its 5 global ones (the
# reference's BIG_WINDOW, 1 << 30: the causal mask at any S below it);
# recurrentgemma-2B's 40 over 4 (MQA, group 10) at window 2048, on its 8
# attention layers. Keys: (model, BHq, group, window).
GEMMA_FLASH = (("gemma3_4b local", 32, 2, 1024),
               ("gemma3_4b global", 32, 2, 1 << 30),
               ("recurrentgemma_2b", 40, 10, 2048))


def gemma_flash_timing(BHq: int, group: int, window: int, seed: int
                       ) -> dict:
    """At a gemma prefill shape ([BHq, 2048, 256] bf16, causal, ``window``):
    holds the wgmma kernel against the plain version (``flash_case``) and
    the scalar kernel, launched directly on the same inputs as the
    yardstick it was on this path, too; then times the wgmma kernel, the
    scalar kernel, the plain version and
    ``scaled_dot_product_attention(enable_gqa=True)`` (causal, or with an
    explicit boolean window mask where the window is shorter than S) by
    CUDA events and by the profiler, beside the function's bound at the
    bf16 tensor-core rate (and at the float32 rate the scalar kernel's
    FMAs run at)."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    S, D = 2048, 256
    err, (q, k, v) = flash_case(BHq, S, D, True, window, torch.bfloat16,
                                group, seed)
    args = dict(causal=True, window=window, group=group)
    kernel = lambda: fk.flash_attention_bh_cuda(q, k, v, **args)
    scalar = lambda: fk._launch("scalar", q, k, v, scale=None, **args)
    plain = lambda: flash_attention_bh_ref(q, k, v, **args)
    q4, k4, v4 = (t.view(4, -1, S, D) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window >= S:
        name = "SDPA causal"
        library = lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
    else:
        name = "SDPA with an explicit boolean window mask"
        pos = torch.arange(S, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[:, None] - pos[None, :] < window))
        library = lambda: sdpa(q4, k4, v4, attn_mask=mask, enable_gqa=True)
    ref = plain().float()
    scalar_err = (scalar().float() - ref).abs().max().item()
    print(f"  flash BH={BHq} S={S} D={D} window={window} bf16 group={group} "
          f"(the scalar kernel, launched directly): max|do|="
          f"{scalar_err:.3e}", flush=True)
    check("flash attention (scalar) at a gemma shape", scalar_err,
          FLASH_ATOL[torch.bfloat16])
    lib_err = (library().reshape(BHq, S, D).float() - ref).abs().max().item()
    del ref
    # Query-key pairs under the mask, each 2 D multiply-adds (Q K^T, P V).
    w = min(window, S)
    pairs = BHq * (w * (w + 1) // 2 + (S - w) * w)
    elems = 2 * q.numel() + k.numel() + v.numel()
    t = dict(ms=cuda_ms(kernel, warmup=5, reps=50),
             device_ms=profiled_device_ms(kernel, reps=10),
             scalar_ms=cuda_ms(scalar, warmup=1, reps=5),
             scalar_device_ms=profiled_device_ms(scalar, reps=2),
             plain_ms=cuda_ms(plain, warmup=1, reps=3),
             plain_device_ms=profiled_device_ms(plain, reps=2),
             library_ms=cuda_ms(library, warmup=3, reps=20),
             library_device_ms=profiled_device_ms(library, reps=5),
             library=name, max_abs_err=err, scalar_err=scalar_err,
             library_err=lib_err, shape=[BHq, S, D], group=group,
             window=window, fp32_bound=bound(2 * elems, 4 * pairs * D),
             **bound(2 * elems, 4 * pairs * D, BF16_OPS_PER_S))
    print(f"  timing flash at [{BHq}, {S}, {D}] bf16 group {group}, window "
          f"{window}: wgmma kernel {t['ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['device_ms'])}; max|d| vs plain {err:.3e}), scalar "
          f"kernel {t['scalar_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['scalar_device_ms'])}), plain "
          f"{t['plain_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['plain_device_ms'])}), {name} "
          f"{t['library_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['library_device_ms'])}; max|d| vs plain "
          f"{lib_err:.3e}), bound {t['bound_ms'] * 1e3:.2f} us "
          f"({t['bound_by']}: {t['nops'] / 1e9:.2f} GFLOP at the bf16 "
          f"tensor-core rate, {t['nbytes'] / 1e6:.2f} MB; at the float32 "
          f"rate {t['fp32_bound']['bound_ms'] * 1e3:.2f} us)", flush=True)
    return t


# The new models' per-call prefill shapes at B 4, S 2048 in bf16 (the
# prompt of phase 8), in the model's layout: (name, Hq, Hkv, Sq, Skv, D_qk,
# D_v, causal). MLA (minicpm3-4B 96/64, DeepSeek-V2 192/128) on the wgmma
# kernel's own instantiations; DBRX's GQA 48 over 8 at D 128; llama-3.2-vision's self-attention (32 over 8) and its
# cross-attention to 4096 image tokens (non-causal, Sq != Skv);
# SeamlessM4T's encoder and decoder cross-attention (non-causal, 16 heads
# at D 64, 2048 frames) and its causal decoder self-attention.
MODEL_FLASH = (("minicpm3_4b mla", 40, 40, 2048, 2048, 96, 64, True),
               ("deepseek_v2_236b mla", 128, 128, 2048, 2048, 192, 128,
                True),
               ("dbrx_132b", 48, 8, 2048, 2048, 128, 128, True),
               ("llama_3_2_vision_11b self", 32, 8, 2048, 2048, 128, 128,
                True),
               ("llama_3_2_vision_11b cross", 32, 8, 2048, 4096, 128, 128,
                False),
               ("seamless_m4t_large_v2 encoder, cross", 16, 16, 2048, 2048,
                64, 64, False),
               ("seamless_m4t_large_v2 self", 16, 16, 2048, 2048, 64, 64,
                True))


def model_flash_case(B, Hq, Hkv, Sq, Skv, D, Dv, causal, dtype, seed):
    """The model-layout wrapper (``ops.flash_attention``: the wgmma kernel
    reading q, k and v in place at its (D, Dv) pairs, else heads first and
    zero-padded) against the plain version on the unpadded inputs, at
    MLA's numpy scale where D != Dv; checks one launch of the kernel
    ``kernel_call`` names, keyed by (variant, D_qk, D_v). Returns (max
    |d|, relative RMS, inputs, scale, (variant, D_qk, D_v))."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    G = Hq // Hkv
    q = torch.randn((B, Sq, Hkv, G, D), generator=gen,
                    device="cuda").to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, Hkv, Dv), generator=gen,
                    device="cuda").to(dtype)
    scale = 1.0 / np.sqrt(D) if D != Dv else None
    call = fops.kernel_call(dtype, D, Dv)
    with flash_call_recorder() as seen:
        out = fops.flash_attention(q, k, v, causal=causal, scale=scale)
    if dict(seen) != {(*call, causal): 1}:
        fail(f"the flash wrapper at D {D}/{Dv} launched {dict(seen)} by "
             f"(variant, D_qk, D_v, causal), want one {call}")
    bh = model_to_bh(q, k, v)
    ref = flash_attention_bh_ref(*bh, causal=causal, scale=scale, group=G)
    out = out_to_bh(out)
    err, rel = flash_diff(out, ref)
    print(f"  flash (model layout) B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} "
          f"Skv={Skv} D={D}/{Dv} causal={causal} {str(dtype)[6:]} "
          f"({call[0]} kernel at {call[1]}/{call[2]}): max|do|={err:.3e}, "
          f"rel RMS {rel:.3e}", flush=True)
    hold_flash("flash attention (model layout)", out, ref, dtype)
    return err, rel, (q, k, v), scale, call


def out_to_bh(o):
    """The wrapper's [B, Sq, Kh, G, Dv] output -> [BH, Sq, Dv]."""
    return o.permute(0, 2, 3, 1, 4).reshape(-1, o.shape[1], o.shape[-1])


def flash_mutants(q, k, v, causal, scale, ref, d_nope=None) -> dict:
    """What the hold reads on launches that are wrong on purpose, against
    the plain version's ``ref`` of the sound call: at MLA's unequal head
    dims, the call with the RoPE columns dropped (q and k cut to their
    first ``d_nope`` columns, a strided view, at the same scale) and the
    call at 1/sqrt(D_v) instead of 1/sqrt(D_qk); where the mask is full,
    the call with the last kv tile (128 keys) left out. Fails if
    FLASH_RRMS would pass one. Returns {mutant: (max |d|, relative
    RMS)}."""
    from repro_torch.kernels.flash_attention import ops as fops
    D, Dv = k.shape[-1], v.shape[-1]
    runs = {}
    if D != Dv:
        runs["RoPE columns dropped"] = lambda: fops.flash_attention(
            q[..., :d_nope], k[..., :d_nope], v, causal=causal, scale=scale)
        runs[f"scale 1/sqrt({Dv})"] = lambda: fops.flash_attention(
            q, k, v, causal=causal, scale=1.0 / np.sqrt(Dv))
    if not causal:
        runs["last kv tile dropped"] = lambda: fops.flash_attention(
            q, k[:, :-128], v[:, :-128], causal=False, scale=scale)
    out = {}
    for name, run in runs.items():
        out[name] = flash_diff(out_to_bh(run()), ref)
        print(f"  mutant ({name}): max|do|={out[name][0]:.3e}, rel RMS "
              f"{out[name][1]:.3e} (limits {FLASH_ATOL[q.dtype]:.1e}, "
              f"{FLASH_RRMS[q.dtype]:.1e})", flush=True)
        if not out[name][1] > FLASH_RRMS[q.dtype]:
            fail(f"the flash hold would pass a launch with {name}")
    return out


def model_to_bh(q, k, v):
    """Model layout -> the kernel's [BH, S, D], contiguous, unpadded."""
    B, Sq, Hkv, G, D = q.shape
    return (q.permute(0, 2, 3, 1, 4).reshape(B * Hkv * G, Sq, D)
            .contiguous(),
            k.permute(0, 2, 1, 3).reshape(B * Hkv, k.shape[1], D)
            .contiguous(),
            v.permute(0, 2, 1, 3).reshape(B * Hkv, v.shape[1], v.shape[-1])
            .contiguous())


def flash_kernel_device_ms(fn, reps: int = 10):
    """The profiler's device ms per call of ``fn()`` in the flash kernels
    alone (``flash_fwd``), and in every kernel it launches (the wrapper's
    layout and padding copies too): (kernel, all) or (None, None)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if str(ev.device_type).endswith("CUDA")
           and ev.self_device_time_total > 0]
    total = sum(ev.self_device_time_total for ev in evs) / reps / 1e3
    flash = sum(ev.self_device_time_total for ev in evs
                if "flash_fwd" in ev.key) / reps / 1e3
    return (flash or None, total or None)


def model_flash_timing(name, Hq, Hkv, Sq, Skv, D, Dv, causal, seed) -> dict:
    """At a new model's prefill call shape (B 4, bf16): holds the wrapper
    against the plain version (``model_flash_case``) and its mutants
    (``flash_mutants``), then times the wrapper (the kernel reading and
    writing the model layout in place: no copy) by CUDA events, the flash
    kernel alone and the whole call by the profiler, the plain version,
    and ``scaled_dot_product_attention(enable_gqa=True)`` on heads-first
    copies of the unpadded inputs (MLA's D_v != D_qk included, where SDPA
    takes it; else on the inputs padded to ``padded_dim``), beside the
    function's bound: the unmasked query-key pairs, 2 (D_qk + D_v) flops
    each, at the bf16 tensor-core rate, or q, k, v and o once at the HBM
    rate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    B, G = 4, Hq // Hkv
    err, rel, (q, k, v), scale, call = model_flash_case(
        B, Hq, Hkv, Sq, Skv, D, Dv, causal, torch.bfloat16, seed)
    kind = call[0]
    kernel = lambda: fops.flash_attention(q, k, v, causal=causal,
                                          scale=scale)
    bh = model_to_bh(q, k, v)
    plain = lambda: flash_attention_bh_ref(*bh, causal=causal, scale=scale,
                                           group=G)
    d_nope = get_config(name.split()[0]).d_nope if D != Dv else None
    mutants = flash_mutants(q, k, v, causal, scale, plain(), d_nope)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(B, -1, t.shape[1], t.shape[2]) for t in bh)
    kw = dict(is_causal=causal, enable_gqa=True,
              scale=float(scale) if scale is not None else None)
    library = lambda: sdpa(q4, k4, v4, **kw)
    took = "unpadded"
    try:
        lib_out = library()
    except RuntimeError:
        # SDPA refused D_v != D_qk: pad to one head dim.
        Dp = fops.padded_dim(D, Dv)
        q4, k4, v4 = (torch.nn.functional.pad(t, (0, Dp - t.shape[-1]))
                      for t in (q4, k4, v4))
        library = lambda: sdpa(q4, k4, v4, **kw)[..., :Dv]
        took = f"padded to D {Dp}"
        lib_out = library()
    ref = plain().float()
    lib_err = (lib_out.reshape(-1, Sq, Dv).float() - ref).abs().max().item()
    del ref, lib_out
    pairs = B * Hq * (Sq * (Sq + 1) // 2 if causal else Sq * Skv)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * Hq * Sq * Dv)
    kernel_dev, call_dev = flash_kernel_device_ms(kernel)
    t = dict(name=name, shape=dict(B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv,
                                   D=D, Dv=Dv, causal=causal),
             kernel_dims=list(call[1:]), kernel=kind,
             ms=cuda_ms(kernel, warmup=5, reps=30),
             device_ms=kernel_dev, call_device_ms=call_dev,
             plain_ms=cuda_ms(plain, warmup=1, reps=3),
             library_ms=cuda_ms(library, warmup=3, reps=20),
             library_device_ms=profiled_device_ms(library, reps=5),
             library=f"SDPA ({took})", max_abs_err=err, rel_rms=rel,
             mutants=mutants, library_err=lib_err,
             **bound(nbytes, 2 * pairs * (D + Dv), BF16_OPS_PER_S))
    print(f"  timing flash, {name}: wrapper {t['ms'] * 1e3:.2f} us "
          f"(flash kernel on the device {fmt_us(t['device_ms'])}, whole "
          f"call {fmt_us(t['call_device_ms'])}; {kind} at "
          f"{call[1]}/{call[2]}), plain "
          f"{t['plain_ms'] * 1e3:.2f} us, SDPA ({took}) "
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
    from repro_torch.numerics import softplus
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


def ssd_err(got, ref, rtol: float):
    """(max |d|, max |d| beyond the bf16 rounding allowance) over y and
    the state: the check is |d| <= atol + rtol |ref|."""
    raw = max((g.float() - r.float()).abs().max().item()
              for g, r in zip(got, ref))
    err = max(((g.float() - r.float()).abs() - rtol * r.float().abs())
              .max().item() for g, r in zip(got, ref))
    return raw, err


def ssd_case(b, S, H, P, G, N, chunk, dtype, seed, model_like=False):
    """Kernel vs plain version; checks that the call took the kernel
    ``variant`` chooses, once; returns (max |d|, variant, inputs)."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    args = ssd_inputs(b, S, H, P, G, N, dtype, seed, model_like)
    kind = sk.variant(dtype, P, N, min(chunk, S))
    before = dict(sk.LAUNCHES_BY_VARIANT)
    y, st = sops.ssd_scan(*args, chunk=chunk)
    if sk.LAUNCHES_BY_VARIANT != {**before, kind: before[kind] + 1}:
        fail(f"ssd scan did not call its {kind} kernel once")
    yr, sr = ssd_ref(*args, chunk=min(chunk, S))
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    raw, err = ssd_err((y, st), (yr, sr), rtol)
    print(f"  ssd b={b} S={S} H={H} P={P} G={G} N={N} chunk={chunk} "
          f"{str(dtype)[6:]}{' model-like' if model_like else ''} ({kind} "
          f"kernel): "
          f"max|d(y, state)|={raw:.3e} (beyond rtol {rtol:.2e}: "
          f"{err:.3e}); max|y|={yr.float().abs().max().item():.3e}",
          flush=True)
    check("ssd scan", err, SSD_ATOL)
    if yr.float().abs().max().item() == 0.0:
        fail("ssd scan output is zero")
    return raw, kind, args


def ssd_timing(args, L: int) -> dict:
    """At a mamba2-2.7B prefill shape, bf16 inputs: the wgmma kernel (and
    each of its three launches), the scalar kernel on the same inputs
    (held to the plain version at the card's limit) and on their float32
    copies, and the plain version on both, by CUDA events and by the
    profiler, beside the function's bound (at the bf16 tensor-core rate; the
    float32 call's at the float32 rate)."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    x, dt, A, Bm, Cm = args
    b, S, H, P = x.shape
    N = Bm.shape[3]
    nc = -(-S // L)
    # Causal intra-chunk products L(L+1)/2 (N + P), inter term and state
    # update 2 L N P, per (b, h, chunk); bytes: x, dt, A, B, C read, y and
    # the state written.
    nops = 2 * b * H * nc * (L * (L + 1) // 2 * (N + P) + 2 * L * N * P)
    elems = 2 * x.numel() + 2 * Bm.numel() + b * H * P * N
    small = dt.numel() * 4 + A.numel() * 4
    x32, B32, C32 = (t.float() for t in (x, Bm, Cm))
    wgmma = lambda: sk.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=L)
    # The scalar kernel on a call the wgmma kernel takes: past the
    # dispatch, straight to its launch.
    scalar = lambda: sk._launch("scalar", x, dt, A, Bm, Cm, L)
    scalar32 = lambda: sk.ssd_scan_cuda(x32, dt, A, B32, C32, chunk=L)
    plain = lambda: ssd_ref(x, dt, A, Bm, Cm, chunk=L)
    plain32 = lambda: ssd_ref(x32, dt, A, B32, C32, chunk=L)
    raw, scalar_err = ssd_err(scalar(), plain(), BF16_RTOL)
    print(f"  ssd b={b} S={S} H={H} P={P} N={N} chunk={L} bfloat16 "
          f"model-like (scalar kernel, same inputs): max|d(y, state)|="
          f"{raw:.3e} (beyond rtol {BF16_RTOL:.2e}: {scalar_err:.3e})",
          flush=True)
    check("ssd scan (scalar kernel, bf16)", scalar_err, SSD_ATOL)
    t = dict(ms=cuda_ms(wgmma, warmup=5, reps=50),
             device_ms=profiled_device_ms(wgmma, reps=10),
             launch_device_us=device_us_by_kernel(wgmma),
             scalar_ms=cuda_ms(scalar, warmup=2, reps=10),
             scalar_device_ms=profiled_device_ms(scalar, reps=3),
             scalar32_ms=cuda_ms(scalar32, warmup=2, reps=10),
             scalar32_device_ms=profiled_device_ms(scalar32, reps=3),
             plain_ms=cuda_ms(plain, warmup=2, reps=5),
             plain_device_ms=profiled_device_ms(plain, reps=2),
             plain32_ms=cuda_ms(plain32, warmup=2, reps=5),
             scalar_raw_err=raw, library_ms=None,
             scalar32_bound=bound(4 * elems + small, nops),
             **bound(2 * elems + small, nops, BF16_OPS_PER_S))
    print(f"  timing ssd at mamba2-2.7B prefill ({b}, {S}, {H}, {P}; G 1, "
          f"N {N}, L {L}) bf16: wgmma kernel {t['ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['device_ms'])}; by launch {t['launch_device_us']}), "
          f"scalar kernel on the same bf16 inputs {t['scalar_ms'] * 1e3:.2f} "
          f"us (device {fmt_us(t['scalar_device_ms'])}), scalar kernel in "
          f"float32 {t['scalar32_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['scalar32_device_ms'])}; bound "
          f"{t['scalar32_bound']['bound_ms'] * 1e3:.2f} us at the float32 "
          f"rate), plain {t['plain_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['plain_device_ms'])}; on the float32 copies "
          f"{t['plain32_ms'] * 1e3:.2f} us), bound "
          f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: {nops / 1e9:.2f} "
          f"GFLOP at the bf16 tensor-core rate, {t['nbytes'] / 1e6:.2f} MB); "
          f"library call: none (no PyTorch call computes the chunked SSD)",
          flush=True)
    return t


# The SSD kernels from an initial state h0 (the state a context-parallel
# segment receives): (b, S, H, P, G, N, chunk, dtype). The wgmma kernel at
# mamba2-2.7B's prefill shape and at a ragged S; the scalar kernel in
# float32 at the same prefill shape and at a small ragged one.
SSD_H0_CASES = [(4, 2048, 80, 64, 1, 128, 256, torch.bfloat16),
                (2, 1100, 80, 64, 1, 128, 256, torch.bfloat16),
                (4, 2048, 80, 64, 1, 128, 256, torch.float32),
                (2, 300, 4, 16, 2, 8, 16, torch.float32)]
# The split-versus-whole check: one sequence of SPLIT_S positions at
# mamba2-2.7B's widths, bf16, cut after SPLIT_HEAD (the last of 8 segments
# of 4096 positions, 16 chunks of 256, runs from the state of the first
# 28672).
SPLIT_S, SPLIT_HEAD = 32768, 28672


def ssd_state_of(b, S, H, P, G, N, chunk, dtype, seed):
    """A realistic incoming state: the float32 final of the kernel's scan
    from zero over another model-like draw of the same shape."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    with torch.no_grad():
        return sk.ssd_final_cuda(*ssd_inputs(b, S, H, P, G, N, dtype, seed,
                                             True), chunk=chunk)


def ssd_h0_case(b, S, H, P, G, N, chunk, dtype, seed) -> dict:
    """The kernel ``variant`` chooses from h0 (``ssd_state_of``) against
    the plain chunked version with the same ``init_state``: y and the
    state in x's dtype, at the SSD's limits; one call of the variant,
    counted as a call from a state; the state carried (y moves against
    the call from zero); and the ``ssd_final_cuda`` entry against the
    plain final from zero (``ssd_final_ref``) at the same limit. Returns
    the errors and the inputs."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_final_ref, ssd_ref
    args = ssd_inputs(b, S, H, P, G, N, dtype, seed, True)
    h0 = ssd_state_of(b, S, H, P, G, N, chunk, dtype, seed + 1000)
    L = min(chunk, S)
    kind = sk.variant(dtype, P, N, L)
    before = (dict(sk.LAUNCHES_BY_VARIANT), dict(sk.LAUNCHES_FROM_STATE))
    y, st = sk.ssd_scan_cuda(*args, chunk=chunk, h0=h0)
    if (sk.LAUNCHES_BY_VARIANT, sk.LAUNCHES_FROM_STATE) != (
            {**before[0], kind: before[0][kind] + 1},
            {**before[1], kind: before[1][kind] + 1}):
        fail(f"ssd scan from h0 did not call its {kind} kernel once")
    yr, sr = ssd_ref(*args, chunk=L, init_state=h0)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    raw, err = ssd_err((y, st), (yr, sr), rtol)
    y0, _ = sk.ssd_scan_cuda(*args, chunk=chunk)
    moved = (y.float() - y0.float()).abs().max().item()
    final = sk.ssd_final_cuda(*args, chunk=chunk)
    final_err = (final - ssd_final_ref(*args, chunk=L)).abs().max().item()
    torch.cuda.synchronize()
    print(f"  ssd from h0 b={b} S={S} H={H} P={P} G={G} N={N} chunk={chunk} "
          f"{str(dtype)[6:]} model-like ({kind} kernel): max|d(y, state)|="
          f"{raw:.3e} (beyond rtol {rtol:.2e}: {err:.3e}); max|y - y from "
          f"zero|={moved:.3e}; the final-from-zero entry: max|d| to the "
          f"plain final {final_err:.3e}", flush=True)
    check("ssd scan from h0", err, SSD_ATOL)
    check("ssd final from zero vs plain", final_err, SSD_ATOL)
    if moved < 1e-2:
        fail(f"ssd scan from h0: y moved {moved:.3e} from the call from "
             f"zero; the state was not carried")
    return dict(raw=raw, err=err, final_err=final_err, kind=kind,
                args=args, h0=h0)


def ssd_h0_timing(args, h0, L: int) -> dict:
    """The kernel ``variant`` chooses from h0 beside the same call from
    zero, the final-from-zero entry and the plain versions of both, by
    CUDA events and by the profiler (the wgmma kernel's launches by name
    too), beside each one's bound: the scan's (h0 read too) as
    ``ssd_timing`` counts it; the final's x, dt, A and B read and the
    float32 state written, 2 L N P operations per (b, h, chunk), at the
    inputs' type's rate."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_final_ref, ssd_ref
    x, dt, A, Bm, Cm = args
    b, S, H, P = x.shape
    N = Bm.shape[3]
    nc = -(-S // L)
    kind = sk.variant(x.dtype, P, N, L)
    rate = BF16_OPS_PER_S if x.dtype == torch.bfloat16 else FP32_OPS_PER_S
    item = x.element_size()
    nops = 2 * b * H * nc * (L * (L + 1) // 2 * (N + P) + 2 * L * N * P)
    small = dt.numel() * 4 + A.numel() * 4
    scan_bytes = item * (2 * x.numel() + 2 * Bm.numel() + b * H * P * N) \
        + small + h0.numel() * 4
    final_bytes = item * (x.numel() + Bm.numel()) + small + h0.numel() * 4
    calls = dict(
        h0=lambda: sk.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=L, h0=h0),
        zero=lambda: sk.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=L),
        final=lambda: sk.ssd_final_cuda(x, dt, A, Bm, Cm, chunk=L),
        plain=lambda: ssd_ref(x, dt, A, Bm, Cm, chunk=L, init_state=h0),
        plain_final=lambda: ssd_final_ref(x, dt, A, Bm, Cm, chunk=L))
    reps = 50 if kind == "wgmma" else 10
    t = {}
    for name, fn in calls.items():
        plain = name.startswith("plain")
        t[f"{name}_ms"] = cuda_ms(fn, warmup=2 if plain else 5,
                                  reps=5 if plain else reps)
        t[f"{name}_device_ms"] = profiled_device_ms(fn, reps=2 if plain
                                                    else 10)
    if kind == "wgmma":
        t["h0_launch_device_us"] = device_us_by_kernel(calls["h0"])
        t["final_launch_device_us"] = device_us_by_kernel(calls["final"])
    t["h0_bound"] = bound(scan_bytes, nops, rate)
    t["final_bound"] = bound(final_bytes, 2 * b * H * nc * L * N * P, rate)
    print(f"  timing ssd from h0 at ({b}, {S}, {H}, {P}; N {N}, L {L}) "
          f"{str(x.dtype)[6:]} ({kind} kernel): from h0 "
          f"{t['h0_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['h0_device_ms'])}), from zero "
          f"{t['zero_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['zero_device_ms'])}), final from zero "
          f"{t['final_ms'] * 1e3:.2f} us (device "
          f"{fmt_us(t['final_device_ms'])}), plain from h0 "
          f"{t['plain_ms'] * 1e3:.2f} us, plain final "
          f"{t['plain_final_ms'] * 1e3:.2f} us; bounds: the scan "
          f"{t['h0_bound']['bound_ms'] * 1e3:.2f} us "
          f"({t['h0_bound']['bound_by']}), the final "
          f"{t['final_bound']['bound_ms'] * 1e3:.2f} us "
          f"({t['final_bound']['bound_by']}); by launch "
          f"{t.get('h0_launch_device_us')} / "
          f"{t.get('final_launch_device_us')}; library call: none",
          flush=True)
    return t


def ssd_split_check() -> dict:
    """The carried state across a segment boundary of 16 chunks on the
    card: the wgmma kernel over SPLIT_S positions at mamba2-2.7B's widths
    (bf16, batch 1), against the last SPLIT_S - SPLIT_HEAD positions run
    from the float32 final of the first SPLIT_HEAD (``ssd_final_cuda``):
    the tail's y and final state within the SSD's limits of the whole
    run's (and whether bitwise). The same from the bf16 final (the state
    in x's dtype, as the context-parallel path took it before the
    float32 final): printed, nothing gated on it."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    args = ssd_inputs(1, SPLIT_S, 80, 64, 1, 128, torch.bfloat16, 36, True)
    head = [t[:, :SPLIT_HEAD].contiguous() if t.dim() > 1 else t
            for t in args]
    tail = [t[:, SPLIT_HEAD:].contiguous() if t.dim() > 1 else t
            for t in args]
    with torch.no_grad():
        y, st = sk.ssd_scan_cuda(*args, chunk=256)
        h32 = sk.ssd_final_cuda(*head, chunk=256)
        yt, stt = sk.ssd_scan_cuda(*tail, chunk=256, h0=h32)
        _, h16 = sk.ssd_scan_cuda(*head, chunk=256)
        y16, st16 = sk.ssd_scan_cuda(*tail, chunk=256, h0=h16.float())
    torch.cuda.synchronize()
    want = (y[:, SPLIT_HEAD:], st)
    raw, err = ssd_err((yt, stt), want, BF16_RTOL)
    raw16, err16 = ssd_err((y16, st16), want, BF16_RTOL)
    bitwise = torch.equal(yt, want[0]) and torch.equal(stt, want[1])
    print(f"  ssd split vs whole at (1, {SPLIT_S}, 80, 64), N 128, L 256, "
          f"bf16: the last {SPLIT_S - SPLIT_HEAD} positions from the "
          f"float32 final of the first {SPLIT_HEAD} ({SPLIT_HEAD // 256} "
          f"chunks) vs the whole run's: max|d(y, state)| {raw:.3e} "
          f"(beyond rtol {err:.3e}), bitwise {bitwise}; from the bf16 "
          f"final instead: max|d| {raw16:.3e} (beyond rtol {err16:.3e}; "
          f"not gated)", flush=True)
    check("ssd split vs whole", err, SSD_ATOL)
    return dict(max_abs_err=raw, err_beyond_rtol=err, bitwise=bitwise,
                bf16_final_max_abs_err=raw16, bf16_final_beyond_rtol=err16)


# The SSD kernels' outputs with no h0, from before the initial state: sha256
# of each SSD_DIGEST_CASES call's (y, state) bytes on its fixed inputs,
# from ``kernel_probe.py digest`` on the tree before h0 (NVIDIA H100 80GB
# HBM3, 700.00 W). The kernels hold no atomics and no order that depends
# on timing, so an output is a function of its inputs.
PARENT_SSD_DIGESTS = {
    "wgmma 600 N128 L256":
        "8e57129ed74f13dc6b75e53ba21a459c00d88af64d249132206ecc9128084548",
    "wgmma 300 G2 N64 L64":
        "56c4aa5305a7a7675a9f55ca37630a61cfbd0367f257281345e043140191435c",
    "wgmma mamba2 b1":
        "7adcacdbab04f134e4f378075ee294fde239b2b2dadea2853c3ad696b88ded63",
    "scalar f32 100":
        "ca13941a53e6d4c8bf9f27d64739478c489cfadf5e048367becb0b01c0dd2e19",
    "scalar f32 mamba2 b1":
        "dbe0e3debb74af640b3e7b558476e83d1a6067c9edbc00de5cf6d60320863518",
    "scalar bf16 160 P32":
        "10b81bfa30c83cd42da2d584ba499c2e80f846d8b58804ca7b6fd57e8d3428d7",
    "scalar bf16 600 N128":
        "fbbcbe139c511471333e8c90c4ec92b62a5a6eccb03c4f1d014b4d5cd7ba12e3"}
# (label, kernel, b, S, H, P, G, N, chunk, dtype): the wgmma kernel through
# ``ssd_scan_cuda``, the scalar one through ``_launch`` (on bf16 inputs
# the wgmma kernel would take, too).
SSD_DIGEST_CASES = [
    ("wgmma 600 N128 L256", "wgmma", 1, 600, 8, 64, 1, 128, 256,
     torch.bfloat16),
    ("wgmma 300 G2 N64 L64", "wgmma", 2, 300, 8, 64, 2, 64, 64,
     torch.bfloat16),
    ("wgmma mamba2 b1", "wgmma", 1, 2048, 80, 64, 1, 128, 256,
     torch.bfloat16),
    ("scalar f32 100", "scalar", 2, 100, 4, 16, 2, 8, 16, torch.float32),
    ("scalar f32 mamba2 b1", "scalar", 1, 2048, 80, 64, 1, 128, 256,
     torch.float32),
    ("scalar bf16 160 P32", "scalar", 2, 160, 4, 32, 2, 64, 64,
     torch.bfloat16),
    ("scalar bf16 600 N128", "scalar", 1, 600, 8, 64, 1, 128, 256,
     torch.bfloat16)]


def ssd_digests() -> dict:
    """{label: sha256 of (y, state)} of every SSD_DIGEST_CASES call with
    no h0 (the call an older tree takes too), on inputs drawn by numpy
    from fixed seeds."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    out = {}
    for i, (label, kind, b, S, H, P, G, N, chunk, dtype) in enumerate(
            SSD_DIGEST_CASES):
        rng = np.random.default_rng(400 + i)

        def draw(shape, scale=1.0, shift=0.0):
            return torch.from_numpy((rng.standard_normal(shape) * scale
                                     + shift).astype(np.float32)).cuda()
        x = draw((b, S, H, P)).to(dtype)
        dt = draw((b, S, H), 0.1).abs() + 0.05
        A = -draw((H,), 0.3).abs() - 0.2
        Bm, Cm = (draw((b, S, G, N)).to(dtype) for _ in range(2))
        with torch.no_grad():
            if kind == "wgmma":
                y, st = sk.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
            else:
                y, st = sk._launch("scalar", x, dt, A, Bm, Cm,
                                   min(chunk, S))
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in (y, st):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        out[label] = h.hexdigest()
    return out


def ssd_h0_checks() -> dict:
    """Phase 6's initial-state part: SSD_H0_CASES held and the first of
    each variant timed; the split-versus-whole check; the digests of the
    calls with no h0 against the parent's (bitwise the kernels before
    h0)."""
    out = dict(cases={}, timing={})
    for i, case in enumerate(SSD_H0_CASES):
        r = ssd_h0_case(*case, seed=80 + i)
        out["cases"][str(case[:-1] + (str(case[-1])[6:],))] = dict(
            max_abs_err=r["raw"], err_beyond_rtol=r["err"],
            final_max_abs_err=r["final_err"], kind=r["kind"])
        if r["kind"] not in out["timing"] and case[:2] == (4, 2048):
            out["timing"][r["kind"]] = ssd_h0_timing(r["args"], r["h0"],
                                                     case[6])
        del r
    out["worst"] = {k: max([c["max_abs_err"] for c in out["cases"].values()
                            if c["kind"] == k]
                           + [c["final_max_abs_err"] for c in
                              out["cases"].values() if c["kind"] == k])
                    for k in ("wgmma", "scalar")}
    out["split"] = ssd_split_check()
    got = ssd_digests()
    if not PARENT_SSD_DIGESTS:
        fail("PARENT_SSD_DIGESTS is empty")
    differ = sorted(k for k, v in got.items()
                    if PARENT_SSD_DIGESTS.get(k) != v)
    if differ or set(got) != set(PARENT_SSD_DIGESTS):
        fail(f"the SSD kernels with no h0 are not bitwise their outputs "
             f"before h0: {differ}")
    print(f"  with no h0 both SSD kernels are bitwise their outputs before "
          f"h0: {len(got)} digests equal (PARENT_SSD_DIGESTS)", flush=True)
    out["digests_equal"] = len(got)
    return out


def phase_lm_kernels(dev) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import attention
    print("== phase 6: flash attention and SSD scan kernels vs plain "
          "versions on the card (flash also at the gemma models' D 256 "
          "bf16 prefill shapes, beside the scalar kernel it replaced "
          "there)", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = dict(flash=0.0, flash_sm90=0.0, ssd=0.0, ssd_sm90=0.0)
    # test_flash_attention_sweep's six shapes, ragged S = 1000 (GQA,
    # sliding, full; at D 256 in bf16 with groups 1, 2 and 10), then the
    # qwen2-1.5B prefill shape (B 4, S 2048) and the same at D 64. bf16 at
    # D 64, 128 and 256 takes the wgmma kernel, the rest the scalar one.
    for i, case in enumerate([
            (4, 256, 64, True, 0, f32, 1), (2, 512, 128, True, 0, f32, 1),
            (2, 256, 64, False, 0, f32, 1), (2, 512, 64, True, 100, f32, 1),
            (2, 256, 128, True, 0, bf16, 1), (1, 128, 256, True, 64, f32, 1),
            (8, 1000, 64, True, 0, f32, 4), (4, 1000, 128, True, 300, bf16, 2),
            (12, 1000, 64, True, 300, bf16, 6),
            (4, 1000, 64, False, 0, bf16, 2),
            (6, 1000, 128, False, 0, bf16, 6),
            (2, 1000, 256, True, 300, bf16, 1),
            (4, 1000, 256, True, 300, bf16, 2),
            (10, 1000, 256, True, 300, bf16, 10),
            (4, 1000, 256, False, 0, bf16, 2),
            (2, 1000, 256, True, 0, bf16, 1),
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
    gemma_t = {}
    for i, (model, BHq, group, window) in enumerate(GEMMA_FLASH):
        gemma_t[model] = t = gemma_flash_timing(BHq, group, window,
                                                seed=50 + i)
        worst["flash_sm90"] = max(worst["flash_sm90"], t["max_abs_err"])
        worst["flash"] = max(worst["flash"], t["scalar_err"])
    worst["flash"] = max(worst["flash"], flash_t[128]["scalar_err"],
                         flash_t[64]["scalar_err"])
    # The new call shapes at small sizes in both types: MLA's head dims
    # (float32 padded for the scalar kernel, bf16 on wgmma's own (96, 64)
    # and (192, 128)), non-causal calls with Sq != Skv under GQA at D 64
    # and 128, a ragged head dim padded to 64.
    for i, case in enumerate([
            (2, 4, 4, 1000, 1000, 96, 64, True, f32),
            (1, 4, 4, 1000, 1000, 192, 128, True, f32),
            (2, 4, 4, 1000, 1000, 96, 64, True, bf16),
            (1, 4, 4, 1000, 1000, 192, 128, True, bf16),
            (2, 8, 2, 300, 1000, 64, 64, False, f32),
            (2, 8, 2, 1000, 130, 128, 128, False, f32),
            (2, 8, 2, 300, 1000, 64, 64, False, bf16),
            (2, 8, 2, 1000, 130, 128, 128, False, bf16),
            (1, 6, 3, 777, 777, 40, 40, True, bf16)]):
        err, _, _, _, call = model_flash_case(*case, seed=60 + i)
        key = "flash_sm90" if call[0] == "wgmma" else "flash"
        worst[key] = max(worst[key], err)
    check_masked_refusal()
    model_t = {}
    for i, (name, *shape) in enumerate(MODEL_FLASH):
        model_t[name] = t = model_flash_timing(name, *shape, seed=70 + i)
        worst["flash_sm90"] = max(worst["flash_sm90"], t["max_abs_err"])
    # test_ssd_scan_sweep's three shapes and a ragged S in float32 (the
    # scalar kernel); the card tests' bf16 shapes (the wgmma kernel: ragged
    # S, G 1 and 2 over 8 heads, chunks of 64 to 256 and one longer than S,
    # N 64 and 128) and two bf16 calls it does not take (chunks of S = 100
    # rows; P 32), which the scalar kernel takes in bf16; then the
    # mamba2-2.7B prefill shape in float32 (scalar) and in bf16 (wgmma) at
    # B 4 and B 1, the bf16 ones timed beside the scalar kernel on the same
    # inputs, which is held to the plain version there too.
    key = dict(wgmma="ssd_sm90", scalar="ssd")
    for i, case in enumerate([(2, 64, 4, 16, 2, 8, 16, f32),
                              (2, 128, 2, 32, 1, 16, 32, f32),
                              (2, 64, 8, 64, 8, 8, 64, f32),
                              (2, 100, 4, 16, 2, 8, 16, f32),
                              (1, 600, 8, 64, 1, 128, 256, bf16),
                              (1, 600, 8, 64, 2, 128, 256, bf16),
                              (2, 300, 8, 64, 2, 128, 64, bf16),
                              (2, 300, 8, 64, 1, 128, 128, bf16),
                              (2, 300, 8, 64, 2, 64, 128, bf16),
                              (1, 600, 8, 64, 1, 128, 192, bf16),
                              (2, 192, 8, 64, 2, 64, 256, bf16),
                              (2, 100, 8, 64, 1, 128, 256, bf16),
                              (2, 160, 4, 32, 2, 64, 64, bf16)]):
        err, kind, _ = ssd_case(*case, seed=20 + i)
        worst[key[kind]] = max(worst[key[kind]], err)
    err, kind, _ = ssd_case(4, 2048, 80, 64, 1, 128, 256, f32, seed=30,
                            model_like=True)
    worst[key[kind]] = max(worst[key[kind]], err)
    ssd_t = {}
    for b, seed in ((4, 31), (1, 32)):
        err, kind, args = ssd_case(b, 2048, 80, 64, 1, 128, 256, bf16,
                                   seed=seed, model_like=True)
        if kind != "wgmma":
            fail(f"the bf16 prefill shape took the {kind} SSD kernel")
        worst[key[kind]] = max(worst[key[kind]], err)
        ssd_t[b] = ssd_timing(args, L=256)
        worst["ssd"] = max(worst["ssd"], ssd_t[b]["scalar_raw_err"])
    del args
    h0 = ssd_h0_checks()
    worst["ssd_sm90"] = max(worst["ssd_sm90"], h0["worst"]["wgmma"])
    worst["ssd"] = max(worst["ssd"], h0["worst"]["scalar"])
    check_refusal()
    return dict(worst=worst, flash=flash_t, gemma_flash=gemma_t, ssd=ssd_t,
                model_flash=model_t, ssd_h0=h0)


def check_masked_refusal() -> None:
    """A causal or sliding prefill attention with Sq != Skv at offset 0
    raises and launches nothing: its queries are not the keys' last
    positions, so its mask would not be the reference's."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models import attention
    q = torch.zeros((1, 64, 2, 2, 64), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, 100, 2, 64), dtype=torch.bfloat16, device="cuda")
    before = fk.LAUNCHES
    for kind in ("causal", "sliding"):
        try:
            attention.prefill_attention(q, k, k, kind=kind, window=16)
        except ValueError:
            continue
        fail(f"a {kind} prefill attention with Sq != Skv ran")
    if fk.LAUNCHES != before:
        fail("a refused prefill attention launched a kernel")
    print("  a causal or sliding prefill attention with Sq != Skv raises "
          "(no launch)", flush=True)


def check_refusal() -> None:
    """The flash and SSD kernels' launchers are forward-only: with grad
    enabled and an input that requires grad, both raise and launch
    nothing; under no_grad the same inputs run. The public wrappers
    (``ops``) take those inputs under grad and return gradients."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((n, 128, 64), generator=gen, device="cuda")
               for n in (2, 1, 1))
    x, dt, A, Bm, Cm = ssd_inputs(1, 128, 2, 16, 1, 8, torch.float32, 3,
                                  False)
    calls = dict(
        flash=lambda: fk.flash_attention_bh_cuda(q, k, v, group=2),
        ssd=lambda: sk.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=64))
    q.requires_grad_(True)
    dt.requires_grad_(True)
    before = (fk.LAUNCHES, sk.LAUNCHES)
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as err:
            if "forward-only" not in str(err):
                raise
        else:
            fail(f"the {name} kernel ran under grad with an input that "
                 f"requires grad")
    if (fk.LAUNCHES, sk.LAUNCHES) != before:
        fail("a refused call launched a kernel")
    with torch.no_grad():
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    # The public wrappers carry the gradient: one kernel launch forward,
    # the plain version's gradient backward (no launch).
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    before = (fk.LAUNCHES, sk.LAUNCHES)
    o = fops.flash_attention_bh(q, k, v, group=2)
    y, _ = sops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    after = (fk.LAUNCHES, sk.LAUNCHES)
    gq, = torch.autograd.grad(o.square().sum(), q)
    gdt, = torch.autograd.grad(y.square().sum(), dt)
    torch.cuda.synchronize()
    if after != (before[0] + 1, before[1] + 1) or (
            fk.LAUNCHES, sk.LAUNCHES) != after:
        fail(f"the wrappers launched {after} forward (from {before}) and "
             f"{(fk.LAUNCHES, sk.LAUNCHES)} after the backward")
    for name, g in (("flash q", gq), ("SSD dt", gdt)):
        if not (torch.isfinite(g).all() and g.abs().max().item() > 0):
            fail(f"the {name} gradient through the wrapper is not finite "
                 f"and nonzero")
    print("  flash and SSD kernels' launchers refuse an input that "
          "requires grad under grad (no launch) and run it under no_grad; "
          "the public wrappers carry its gradient (one launch forward, "
          "none backward)", flush=True)


def lm_params(cfg, gen, seed):
    """The port's init drawn from ``gen`` (on its device), with the
    Mamba-2 mixers' conv and SSM scalars from ``draw_live_mixer``, the
    RG-LRU blocks' conv, gate biases and decay from ``draw_live_block``
    and the vision cross layers' gates from ``draw_live_gates`` (the
    reference's zero convs would feed both recurrences exact zeros, and
    its zero gates make every cross layer the identity)."""
    from repro_torch.models import rglru, ssm, transformer
    from repro_torch.models.model import Model
    params = Model(cfg).init(gen)
    rng = np.random.default_rng(seed)
    if cfg.ssm:
        mixers = [(lp["mixer"], lambda r: ssm.draw_live_mixer(r, cfg))
                  for lp in params["layers"]]
    elif cfg.family == "griffin":
        recs = [g[n] for g in params["groups"] for n in ("rec1", "rec2")]
        mixers = [(lp["mixer"], lambda r: rglru.draw_live_block(r, cfg))
                  for lp in recs + params.get("tail", [])]
    elif cfg.family == "vision":
        mixers = [(g["cross"], transformer.draw_live_gates)
                  for g in params["groups"]]
    else:
        mixers = []
    for mixer, draw in mixers:
        for k, v in draw(rng).items():
            old = mixer[k]
            mixer[k] = torch.from_numpy(v).to(old.device, old.dtype)
    return params


def lm_inputs(cfg, B: int, n_frames: int, seed: int) -> dict:
    """The non-token inputs, standard normal on the card from ``seed``:
    ``frames`` [B, n_frames, d] (encdec) or ``patches`` [B, n_img_tokens,
    d] (vision), in the compute dtype; {} for the other families."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = {"encdec": ("frames", n_frames),
             "vision": ("patches", cfg.n_img_tokens)}.get(cfg.family)
    if shape is None:
        return {}
    return {shape[0]: torch.randn((B, shape[1], cfg.d_model), generator=gen,
                                  device="cuda").to(cfg.compute_dtype)}


def dead_gates(params) -> dict:
    """A shallow copy of a vision tree with every cross layer's gates
    zero (the reference's init)."""
    groups = [dict(g, cross=dict(g["cross"], **{
        k: torch.zeros_like(g["cross"][k]) for k in ("gate_attn",
                                                     "gate_mlp")}))
        for g in params["groups"]]
    return dict(params, groups=groups)


def gates_matter(model, params, toks, extra) -> float:
    """Max |d last logits| of one prefill with the live gates against one
    with zero gates: the cross layers must change the logits."""
    t = torch.as_tensor(toks, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        live, _ = model.prefill(params, dict(tokens=t, **extra))
        dead, _ = model.prefill(dead_gates(params), dict(tokens=t, **extra))
    return (live.float() - dead.float()).abs().max().item()


@contextlib.contextmanager
def scan_recorder():
    """Record max |y| of every SSD scan and every RG-LRU scan the model
    runs (kernel or plain): yields dict(ssd=[...], rglru=[...])."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import rglru, ssm
    seen = dict(ssd=[], rglru=[])
    targets = [(sops, "ssd_scan", "ssd"), (ssm, "ssd_chunked", "ssd"),
               (rglru, "rglru_scan", "rglru")]
    saved = [getattr(mod, name) for mod, name, _ in targets]

    def wrap(fn, key):
        def rec(*args, **kw):
            y, st = fn(*args, **kw)
            seen[key].append(y.float().abs().max().item())
            return y, st
        return rec
    for (mod, name, key), fn in zip(targets, saved):
        setattr(mod, name, wrap(fn, key))
    try:
        yield seen
    finally:
        for (mod, name, _), fn in zip(targets, saved):
            setattr(mod, name, fn)


def serve_logits(model, params, toks, stream, device, extra=None) -> list:
    """Prefill ``toks`` (with ``extra``: frames or patches) then decode
    along ``stream`` (teacher forced): the [B, V] logits of every step, as
    float32 numpy."""
    from repro_torch.runtime.serve_loop import _splice
    extra = {k: v.to(device) for k, v in (extra or {}).items()}
    with torch.inference_mode():
        t = torch.as_tensor(toks, dtype=torch.int32, device=device)
        B, S = t.shape
        cache = model.init_cache(B, S + stream.shape[1], device,
                                 **model.cache_lengths(extra))
        last, built = model.prefill(params, dict(tokens=t, **extra))
        cache = _splice(cache, built)
        out = [last.float().cpu().numpy()]
        for i in range(stream.shape[1] - 1):
            tok = torch.as_tensor(stream[:, i:i + 1], dtype=torch.int32,
                                  device=device)
            logits, cache = model.decode(params, cache, tok, S + i)
            out.append(logits.float().cpu().numpy())
    return out


def n_recurrent(cfg) -> int:
    """RG-LRU layers of a griffin stack (0 for the other families)."""
    if cfg.family != "griffin":
        return 0
    return 2 * (cfg.n_layers // 3) + cfg.n_layers % 3


def flash_calls(cfg) -> collections.Counter:
    """The flash-kernel calls of one prefill by (variant, D_qk, D_v,
    causal) as ``kernel_call`` serves them: one per attention layer
    (sliding windows are causal calls), the vision groups' cross layers
    (non-causal), encdec's encoder layers (non-causal), decoder self-
    (causal) and cross-attentions (non-causal); MLA's at (d_nope + d_rope,
    d_v)."""
    from repro_torch.kernels.flash_attention import ops as fops
    D, Dv = ((cfg.d_nope + cfg.d_rope, cfg.d_v) if cfg.mla
             else (cfg.head_dim_, cfg.head_dim_))
    call = fops.kernel_call(cfg.compute_dtype, D, Dv)
    calls = collections.Counter()
    if cfg.ssm:
        return calls
    if cfg.family == "vision":
        n_groups = cfg.n_layers // cfg.cross_every
        calls[(*call, True)] = n_groups * (cfg.cross_every - 1)
        calls[(*call, False)] = n_groups
    elif cfg.family == "encdec":
        calls[(*call, False)] = cfg.enc_layers + cfg.n_layers
        calls[(*call, True)] = cfg.n_layers
    else:
        calls[(*call, True)] = cfg.n_layers - n_recurrent(cfg)
    return calls


@contextlib.contextmanager
def flash_call_recorder():
    """Record every flash-kernel launch by (variant, D_qk, D_v, causal):
    wraps the binding's ``_launch``, which every launch goes through."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    seen = collections.Counter()
    launch = fk._launch

    def recorded(kind, q, k, v, **kw):
        seen[(kind, q.shape[-1], v.shape[-1], bool(kw["causal"]))] += 1
        return launch(kind, q, k, v, **kw)
    fk._launch = recorded
    try:
        yield seen
    finally:
        fk._launch = launch


def phase_lm_parity(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.model import Model, to_device
    from repro_torch.runtime.serve_loop import Server
    print("== phase 7: LM serving, card vs CPU (full width, float32; depth "
          + ", ".join(f"{a} {d}" for a, d in PARITY_DEPTH.items())
          + f"; seamless with one encoder layer and {PARITY_FRAMES} "
          "frames)", flush=True)
    out = {}
    for arch in ARCHS:
        start = time.perf_counter()
        depth = PARITY_DEPTH[arch]
        cfg = get_config(arch).replace(n_layers=depth, dtype="float32",
                                       param_dtype="float32")
        if cfg.family == "encdec":
            cfg = cfg.replace(enc_layers=depth)
        model = Model(cfg)
        t0 = time.perf_counter()
        # Drawn on the card (seconds where the host's draw of a 262144-row
        # embedding takes a minute), then copied: the same numbers on both.
        card_params = lm_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), 7)
        host_params = to_device(card_params, "cpu")
        init_s = time.perf_counter() - t0
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 320))
        extra = lm_inputs(cfg, 2, PARITY_FRAMES, seed=5)
        host_extra = {k: v.cpu() for k, v in extra.items()}
        fk.LAUNCHES_BY_VARIANT.update(wgmma=0, scalar=0)
        reset_ssd_launches()
        rk.LAUNCHES.update(layer_fwd=0, layer_bwd=0, fwd=0, bwd=0)
        with scan_recorder() as card_scans, \
                flash_call_recorder() as shapes, \
                plain_call_counter() as plain_calls:
            card_tokens = Server(model, card_params).generate(
                dict(tokens=toks, **extra), max_new=8)
        flash_launches = dict(fk.LAUNCHES_BY_VARIANT)
        ssd_launches = dict(sk.LAUNCHES_BY_VARIANT)
        rglru_launches = dict(rk.LAUNCHES)
        # float32 takes the scalar kernels: one flash call per prefill
        # attention (flash_calls), one SSD call per SSD layer's prefill,
        # one fused RG-LRU launch per recurrent layer's.
        n_rec = n_recurrent(cfg)
        want_shapes = flash_calls(cfg)
        want = dict(wgmma=0, scalar=sum(want_shapes.values()))
        want_ssd = ssd_counts(scalar=cfg.n_layers if cfg.ssm else 0)
        want_rglru = dict(layer_fwd=n_rec, layer_bwd=0, fwd=0, bwd=0)
        if sum(plain_calls.values()):
            fail(f"{arch}: the plain versions ran in the card's float32 "
                 f"generate: {dict(plain_calls)}")
        if (flash_launches, ssd_launches, rglru_launches) != (
                want, want_ssd, want_rglru) or +shapes != +want_shapes:
            fail(f"{arch}: float32 serving called the flash kernels "
                 f"{flash_launches} by (variant, D, causal) "
                 f"{dict(shapes)} (want {want}, {dict(want_shapes)}), the "
                 f"SSD kernels {ssd_launches} (want {want_ssd}) and the "
                 f"RG-LRU kernels {rglru_launches} (want {want_rglru})")
        with scan_recorder() as host_scans:
            host_tokens = Server(model, host_params, device="cpu").generate(
                dict(tokens=toks, **host_extra), max_new=8)
        card_steps = serve_logits(model, card_params, toks, host_tokens, dev,
                                  extra)
        host_steps = serve_logits(model, host_params, toks, host_tokens,
                                  "cpu", host_extra)
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
              f"depth {cfg.n_layers} (drawn on the card and copied in "
              f"{init_s:.1f} s); prompt (2, 320), 8 new tokens; card tokens "
              f"{card_tokens.tolist()}; cpu tokens {host_tokens.tolist()}; "
              f"max |d logits| card vs cpu per step "
              f"{['%.2e' % e for e in errs]} (limit {LM_LOGITS_ATOL:.0e}); "
              f"kernel calls in the card's generate: flash {flash_launches} "
              f"(by variant, D, causal {dict(shapes)}), ssd {ssd_launches}, "
              f"rglru {rglru_launches}", flush=True)
        check(f"{arch} logits card vs cpu", max(errs), LM_LOGITS_ATOL)
        for key, on in (("ssd", cfg.ssm), ("rglru", n_rec > 0)):
            if not on:
                continue
            print(f"    {key} max |y| per scan: card "
                  f"{['%.3e' % v for v in card_scans[key]]}, cpu "
                  f"{['%.3e' % v for v in host_scans[key]]}", flush=True)
            if not card_scans[key] or not host_scans[key] or min(
                    card_scans[key] + host_scans[key]) <= 0.0:
                fail(f"{arch}: the {key} recurrence carried zeros")
        gates = None
        if cfg.family == "vision":
            gates = gates_matter(model, card_params, toks, extra)
            print(f"    live cross-layer gates move the last logits by "
                  f"{gates:.3e} against zero gates", flush=True)
            if not gates > 1e-3:
                fail(f"{arch}: the cross layers do not change the logits")
        out[arch] = dict(max_logits_err=max(errs), flash=flash_launches,
                         flash_shapes=dict(shapes), ssd=ssd_launches,
                         rglru=rglru_launches, gates_effect=gates,
                         tokens_equal=bool(np.array_equal(card_tokens,
                                                          host_tokens)),
                         wall_s=time.perf_counter() - start)
        del card_params, host_params, extra, host_extra
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_call_counter():
    """Count calls of the kernels' plain versions on the model path: the
    flash and SSD kernels' and the RG-LRU wrappers' CPU branches (the
    fused layer's and the scan's, which ``models.rglru.rglru_scan`` takes
    on a CPU tensor); the blocked online softmax counts wherever it is
    called from (the model's CPU branch, the flash backward)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import attention, ssm
    calls = collections.Counter()
    targets = [(attention, "online_softmax_attention"),
               (fref, "online_softmax_attention"),
               (fops, "flash_attention_bh_ref"), (ssm, "ssd_chunked"),
               (sops, "ssd_ref"), (sops, "ssd_final_ref"),
               (rops, "rglru_layer_ref"),
               (rops, "rglru_scan_ref")]
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


def prefill_profile(model, params, toks, extra) -> dict:
    """The profiler's device time of one prefill, by kernel name, the host
    wall around it, and whether its last logits are finite."""
    from torch.profiler import ProfilerActivity, profile
    t = torch.as_tensor(toks, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, dict(tokens=t, **extra))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    by_name = {ev.key: ev.self_device_time_total / 1e3
               for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")
               and ev.self_device_time_total > 0}
    # The port's own kernels among them, by the kernel's function name.
    ours = {label: sum(ms for name, ms in by_name.items()
                       if any(key in name for key in keys))
            for label, keys in (
                ("flash_attention_sm90", ("flash_fwd_sm90",)),
                ("flash_attention", ("flash_fwd<",)),
                ("ssd_scan_sm90", ("ssd_chunk_state", "ssd_state_pass",
                                   "ssd_chunk_scan")),
                ("ssd_scan", ("ssd_fwd",)),
                ("rglru_layer_fwd", ("rglru_fwd_kernel<true",)),
                ("rglru_scan_fwd", ("rglru_fwd_kernel<false",)))}
    return dict(wall_ms=wall * 1e3, device_ms=sum(by_name.values()),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:6],
                ours=ours, finite=bool(torch.isfinite(logits).all()))


def phase_lm_serve(dev) -> dict:
    from repro_torch.configs import get_config
    print("== phase 8: LM serving on the card (bf16, B 4, prompt 2048, 32 "
          "new tokens; full depth but "
          + ", ".join(f"{a} {d} layers" for a, d in SERVE_DEPTH.items())
          + f"; {SERVE_FRAMES} frames, the vision config's image tokens)",
          flush=True)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        if arch in SERVE_DEPTH:
            cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
        out[arch] = serve_arch(arch, cfg)
    return out


def serve_arch(arch: str, cfg, B: int = 4, S: int = 2048,
               NEW: int = 32) -> dict:
    """One model of phase 8 (and 13(a)) through ``Server.generate`` in
    bf16 on the card: a warm-up, then one measured generate whose kernel
    launches must be exactly one wgmma call per prefill attention, SSD or
    recurrent layer, with no plain version on the path."""
    import repro_torch.obs as obs
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import Server
    start = time.perf_counter()
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       8)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S))
    extra = lm_inputs(cfg, B, SERVE_FRAMES, seed=6)
    batch = dict(tokens=toks, **extra)
    server = Server(model, params)
    # Warm-up at the measured shapes, so the allocator's pool and the
    # libraries' handles are set up outside the measured run.
    server.generate(batch, max_new=2)
    torch.cuda.reset_peak_memory_stats()
    with plain_call_counter() as plain_calls, \
            flash_call_recorder() as shapes:
        fk.LAUNCHES, sk.LAUNCHES = 0, 0
        fk.LAUNCHES_BY_VARIANT.update(wgmma=0, scalar=0)
        reset_ssd_launches()
        rk.LAUNCHES.update(layer_fwd=0, layer_bwd=0, fwd=0, bwd=0)
        with obs.capture() as reg:
            tokens = server.generate(batch, max_new=NEW)
        launches = dict(
            flash_attention=fk.LAUNCHES, ssd_scan=sk.LAUNCHES,
            **{f"flash_{k}": n for k, n in fk.LAUNCHES_BY_VARIANT.items()},
            **{f"ssd_{k}": n for k, n in sk.LAUNCHES_BY_VARIANT.items()},
            **{f"rglru_{k}": n for k, n in rk.LAUNCHES.items()})
    peak = torch.cuda.max_memory_allocated()
    prefill_s = reg.hists["serve.prefill"].total
    decode_s = reg.hists["serve.decode"].total
    # One kernel call per prefill attention (flash_calls: bf16 at
    # D 64, 128 and 256, MLA's at (96, 64) and (192, 128), on the
    # wgmma flash kernel), per SSD layer (P 64, N 128, L 256 on the wgmma
    # SSD kernel) and per RG-LRU layer (the fused forward). None of
    # the others, the scalar flash kernel included.
    n_rec = n_recurrent(cfg)
    want_shapes = flash_calls(cfg)
    n_attn = sum(want_shapes.values())
    n_ssd = cfg.n_layers if cfg.ssm else 0
    if any(kind != "wgmma" for kind, *_ in +want_shapes):
        fail(f"{arch}: bf16 attention {dict(want_shapes)} does not "
             f"take the wgmma flash kernel")
    want = dict(flash_attention=n_attn, ssd_scan=n_ssd,
                flash_wgmma=n_attn, flash_scalar=0, ssd_wgmma=n_ssd,
                ssd_scalar=0, ssd_wgmma_final=0, ssd_scalar_final=0,
                rglru_layer_fwd=n_rec, rglru_layer_bwd=0,
                rglru_fwd=0, rglru_bwd=0)
    prof = prefill_profile(model, params, toks, extra)
    gates = (gates_matter(model, params, toks, extra)
             if cfg.family == "vision" else None)
    print(f"  {arch}: {model.param_count() / 1e9:.4f} B parameters, "
          f"{cfg.n_layers} layers"
          + (f" (+{cfg.enc_layers} encoder)" if cfg.enc_layers else "")
          + f", drawn on the card in {init_s:.1f} s; "
          f"prefill {prefill_s * 1e3:.1f} ms = "
          f"{B * S / prefill_s:.0f} tokens/s; decode "
          f"{decode_s / (NEW - 1) * 1e3:.2f} ms per token of each "
          f"sequence (one step of {B} tokens; {NEW - 1} steps in "
          f"{decode_s * 1e3:.1f} ms = "
          f"{B * (NEW - 1) / decode_s:.1f} tokens/s); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches} (want {want}); "
          f"flash calls by (variant, D, causal) {dict(shapes)} (want "
          f"{dict(+want_shapes)}); plain-version calls "
          f"{dict(plain_calls)}", flush=True)
    print(f"    one profiled prefill: wall {prof['wall_ms']:.1f} ms, "
          f"device {prof['device_ms']:.1f} ms (busy "
          f"{prof['device_ms'] / prof['wall_ms'] * 100:.1f} %); the "
          "port's kernels (device ms, share of device time): "
          + ", ".join(
              f"{k} {ms:.2f} ({ms / prof['device_ms'] * 100:.1f} %)"
              for k, ms in prof["ours"].items())
          + "; top kernels (device ms): " + "; ".join(
              f"{name[:60]} {ms:.2f}" for name, ms in prof["top"]),
          flush=True)
    print(f"    first tokens: {tokens[:, :8].tolist()}"
          + ("" if gates is None else
             f"; live cross-layer gates move the last logits by "
             f"{gates:.3e} against zero gates"), flush=True)
    if launches != want or +shapes != +want_shapes:
        fail(f"{arch}: launches {launches} by shape {dict(shapes)}, "
             f"want {want} by shape {dict(+want_shapes)}")
    if not prof["finite"]:
        fail(f"{arch}: the prefill's last logits are not finite")
    if sum(plain_calls.values()):
        fail(f"{arch}: the plain versions ran on the card's main path: "
             f"{dict(plain_calls)}")
    if gates is not None and not gates > 1e-3:
        fail(f"{arch}: the cross layers do not change the logits")
    if tokens.shape != (B, NEW) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab:
        fail(f"{arch}: tokens out of range {tokens.min()}.."
             f"{tokens.max()} or shape {tokens.shape}")
    out = dict(launches=launches, flash_shapes=dict(shapes),
                     prefill_s=prefill_s, decode_s=decode_s,
                     peak_bytes=peak, params=model.param_count(),
                     layers=cfg.n_layers, profile=prof,
                     gates_effect=gates,
                     wall_s=time.perf_counter() - start)
    del params, server, extra, batch
    torch.cuda.empty_cache()
    return out


# --- The paper's comparison through the registry (phase 9) --------------------

# The paper's §5 comparison schedulers, WaterWise through the annealed
# Sinkhorn launch, and the learned-forecast round, by the names users type.
RULES = ("baseline", "round-robin", "least-load", "carbon-greedy-opt",
         "water-greedy-opt", "ecovisor")
COMPARISON = RULES + ("waterwise[backend=fused]",
                      "waterwise-forecast[forecaster=learned,backend=fused]")
# Run again in spawned worker processes, one a cell, through the auto-sized
# "process" executor: four cells, so the card's cap on the pool
# (experiments.executor.CARD_WORKERS) is what sizes it.
PROCESS_POLICIES = ("baseline", "round-robin", "waterwise[backend=fused]",
                    "waterwise-forecast[backend=fused]")
# Row columns that are host wall times, not results.
WALL_COLS = ("wall_s", "mean_solve_ms")


def reset_launches() -> None:
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.sinkhorn import sinkhorn
    sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES = 0, 0
    sinkhorn.ANNEAL_BATCHED_LAUNCHES = sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES = 0
    rk.LAUNCHES.update(dict.fromkeys(rk.LAUNCHES, 0))


def read_launches() -> dict:
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.sinkhorn import sinkhorn
    return dict(sinkhorn=sinkhorn.ANNEAL_LAUNCHES,
                sinkhorn_batched=sinkhorn.ANNEAL_BATCHED_LAUNCHES,
                sinkhorn_adaptive=sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES,
                sinkhorn_iteration=sinkhorn.LAUNCHES, **rk.LAUNCHES)


def counting_serial():
    """The serial executor, with every launch count set to 0 just before
    each cell and read just after it (``row["_launches"]``)."""
    from repro_torch import experiments
    from repro_torch.experiments import runner

    class CountingSerial(experiments.SerialExecutor):
        def run(self, cells, device=None):
            rows = []
            for cell in cells:
                reset_launches()
                row = self._guarded(runner.run_cell, cell, device)
                row["_launches"] = read_launches()
                rows.append(row)
            return rows
    return CountingSerial()


class DeviceMemoryPeak:
    """Polls the card's used memory (``cudaMemGetInfo``: every process's
    contexts and allocations) on a thread; ``peak_mib`` is the most seen
    beyond the level when the block was entered."""

    def __enter__(self):
        import threading
        free, total = torch.cuda.mem_get_info()
        self.base, self.peak, self.total = total - free, total - free, total
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.02):
                free, total = torch.cuda.mem_get_info()
                self.peak = max(self.peak, total - free)
        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_mib = (self.peak - self.base) / 2**20
        return False


def results_of(row: dict) -> dict:
    return {k: v for k, v in row.items()
            if k not in WALL_COLS and not k.startswith("_")}


def phase_comparison(e2e: dict, fc: dict) -> dict:
    from repro_torch import experiments
    from repro_torch.core import solvers
    from repro_torch.kernels import _build
    print("== phase 9: the paper's comparison on the cell, through the "
          "policy and scenario registries", flush=True)
    plan = experiments.ExperimentPlan.build([CELL], COMPARISON)
    t0 = time.perf_counter()
    rows = plan.run(counting_serial(), strict=True)     # device None: card
    serial_s = time.perf_counter() - t0
    print(f"  (a) serial plan, {len(rows)} cells on the card in "
          f"{serial_s:.3f} s:", flush=True)
    print(experiments.to_table(rows, experiments.TABLE_COLS + (
        "moved_pct", "mean_solve_ms")), flush=True)
    for r in rows:
        live = {k: v for k, v in r["_launches"].items() if v}
        print(f"    {r['spec']}: wall {r['wall_s']:.3f} s, launches "
              f"{live or 'none'}", flush=True)
    zero = dict.fromkeys(read_launches(), 0)
    by_spec = dict(zip(COMPARISON, rows))
    for spec, run, want, phase in (
            ("waterwise[backend=fused]", e2e["card"],
             dict(zero, sinkhorn=e2e["launches"]), "phase 3"),
            ("waterwise-forecast[forecaster=learned,backend=fused]",
             fc["card"], dict(zero, **fc["launches"]), "phase 5")):
        row = by_spec[spec]
        diff = {k: (row[k], v) for k, v in run["summary"].items()
                if k not in WALL_COLS and row[k] != v}
        print(f"  {spec} against {phase}'s card run of the cell: "
              f"{'equal totals' if not diff else diff}; launches "
              f"{row['_launches']} (want {want})", flush=True)
        if diff:
            fail(f"{spec} through the registry differs from {phase}: {diff}")
        if row["_launches"] != want:
            fail(f"{spec} launched {row['_launches']}, {phase} {want}")
    for spec in RULES:
        if by_spec[spec]["_launches"] != zero:
            fail(f"rule scheduler {spec} launched a kernel")
        if by_spec[spec]["unfinished"]:
            fail(f"{spec} left {by_spec[spec]['unfinished']} jobs unfinished")
    savings = {r["spec"]: (r["carbon_savings_pct"], r["water_savings_pct"])
               for r in rows}

    workers = experiments.executor.auto_workers(len(PROCESS_POLICIES))
    print(f"  (b) {', '.join(PROCESS_POLICIES)}: serial, then \"process\" "
          f"(spawned workers on the card, auto-sized to {workers})",
          flush=True)
    if workers > experiments.executor.CARD_WORKERS:
        fail(f"the auto-sized pool opens {workers} contexts on the card")
    built = {p.name: p.stat().st_mtime_ns
             for p in _build.BUILD_DIR.glob("*.so")}
    sub = experiments.ExperimentPlan.build([CELL], PROCESS_POLICIES)
    serial = sub.run("serial", strict=True)
    t0 = time.perf_counter()
    with DeviceMemoryPeak() as mem:
        proc = sub.run("process", strict=True)
    process_s = time.perf_counter() - t0
    for a, b in zip(serial, proc):
        print(f"    {a['spec']}: serial wall {a['wall_s']:.3f} s, worker "
              f"wall {b['wall_s']:.3f} s, carbon {b['carbon_kg']:.6f} kg",
              flush=True)
        if results_of(a) != results_of(b):
            fail(f"{a['spec']}: process row differs from the serial row: "
                 f"{results_of(a)} vs {results_of(b)}")
    after = {p.name: p.stat().st_mtime_ns
             for p in _build.BUILD_DIR.glob("*.so")}
    print(f"  process plan: {process_s:.3f} s of wall for {len(proc)} cells "
          f"on {workers} workers (serial "
          f"{sum(r['wall_s'] for r in serial):.3f} s of cell walls); rows "
          f"equal the serial rows; built kernels untouched by the workers: "
          f"{after == built}; the pool held at most {mem.peak_mib:.1f} MiB "
          f"of device memory beyond the parent's "
          f"({mem.peak_mib / workers:.1f} MiB a worker; the card has "
          f"{mem.total / 2**20:.0f} MiB)", flush=True)
    if after != built:
        fail("a worker process rebuilt a kernel")

    backends = solvers.available_backends()
    print(f"  (c) solver backends: {backends}", flush=True)
    if "scipy" not in backends:
        fail("the scipy (HiGHS) backend is not registered")

    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--validate",
         e2e["trace"]], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    out = report.stdout.strip()
    print(f"  (d) python -m repro_torch.obs.report --validate on phase 3's "
          f"trace: {out.replace(e2e['trace'], 'trace')}", flush=True)
    if report.returncode != 0 or "schema OK" not in out:
        fail(f"trace report failed: {out} {report.stderr.strip()}")
    return dict(launches=by_spec, savings=savings, serial_s=serial_s,
                process_s=process_s, process_mib=mem.peak_mib,
                walls={r["spec"]: r["wall_s"] for r in rows}, rows=by_spec)


# --- Many cells on one card (phase 10) ----------------------------------------

# The sweep of phase 10(b): the reactive round through the annealed launch
# over 8 seeds of the cell (a Monte-Carlo ensemble / seed sweep), and one
# row the device executor cannot batch.
SWEEP_POLICY = "waterwise[backend=fused]"
SWEEP_SEEDS = tuple(range(3, 11))


def batched_inputs(B: int, M: int, N: int, dev, seed: int):
    """B cells of ``main_path_inputs`` stacked on a leading axis: (C,
    log_a, log_b), each [B, ...] and contiguous."""
    cells = [main_path_inputs(M, N, 0.5, dev, seed=seed + b)
             for b in range(B)]
    return tuple(torch.stack([c[k] for c in cells]).contiguous()
                 for k in (0, 2, 3))


def hold_batched(B: int, M: int, N: int, seed: int, plain: bool) -> tuple:
    """The cell-batched launch at (B, M, N) on main-path inputs: each
    cell's f and g bitwise one ``sinkhorn_anneal`` launch on that cell
    (fails otherwise), and, with ``plain``, within KERNEL_ATOL of the
    plain batched loop (padding rows relative). Returns (launches the call
    made, max |d| against the plain version or None)."""
    from repro_torch.kernels.sinkhorn import ops, sinkhorn
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_batched_ref
    C, log_a, log_b = batched_inputs(B, M, N, torch.device("cuda"), seed)
    table, iters = solve_schedule()
    before = (sinkhorn.ANNEAL_BATCHED_LAUNCHES, sinkhorn.ANNEAL_LAUNCHES)
    f_b, g_b = ops.sinkhorn_solve_batched(C, log_a, log_b, table, iters)
    torch.cuda.synchronize()
    launches = sinkhorn.ANNEAL_BATCHED_LAUNCHES - before[0]
    if sinkhorn.ANNEAL_LAUNCHES != before[1] or launches < 1:
        fail(f"batched solve at {(B, M, N)} made {launches} batched and "
             f"{sinkhorn.ANNEAL_LAUNCHES - before[1]} single launches")
    same = True
    for b in range(B):
        f, g = sinkhorn.sinkhorn_solve_cuda(C[b], log_a[b], log_b[b], table,
                                            iters)
        same &= torch.equal(f_b[b], f) and torch.equal(g_b[b], g)
    torch.cuda.synchronize()
    err = None
    if plain:
        f_r, g_r = sinkhorn_solve_batched_ref(C, log_a, log_b, table, iters)
        err = max(max(f_error(f_b[b], f_r[b], log_a[b]) for b in range(B)),
                  (g_b - g_r).abs().max().item())
    print(f"  batched B={B:2d} M={M:6d} N={N:3d}: {launches} launch(es); "
          f"bitwise equal to {B} single launches: {same}; vs plain "
          f"{'max|d|=%.3e' % err if err is not None else 'not held'}",
          flush=True)
    if not same:
        fail(f"batched launch differs from single launches at {(B, M, N)}")
    if err is not None and not (np.isfinite(err) and err <= KERNEL_ATOL):
        fail(f"batched launch disagrees with the plain version at "
             f"{(B, M, N)}: {err:.3e}")
    return launches, err


def phase_batched(e2e: dict, cmp9: dict) -> dict:
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_batched_ref
    print("== phase 10: many cells on one card — the cell-batched annealed "
          "launch, the device and sharded executors, window replay",
          flush=True)
    dev = torch.device("cuda")
    # (a) The batched launch against single launches.
    worst = 0.0
    for M, N in ((512, 6), (4096, 6), (512, 40)):
        for B in (1, 3, 8):
            _, err = hold_batched(B, M, N, seed=M + N + B, plain=True)
            worst = max(worst, err)
    nblocks = 16384 // sinkhorn.rows_per_block()
    fit = sinkhorn.max_blocks(6, dev) // nblocks
    split, _ = hold_batched(20, 16384, 6, seed=99, plain=False)
    print(f"  20 cells at bucket 16384: {fit} fit at once ({nblocks} blocks "
          f"a cell of {sinkhorn.max_blocks(6, dev)} co-resident), "
          f"{split} launches", flush=True)
    if fit >= 20 or split != -(-20 // fit):
        fail(f"the 20-cell group should split into {-(-20 // fit)} "
             f"launches, made {split}")
    B, M, N = 8, 512, 6
    C, log_a, log_b = batched_inputs(B, M, N, dev, seed=7)
    table, iters = solve_schedule()
    n_iter = len(table) * iters

    def batched():
        return sinkhorn.sinkhorn_solve_batched_cuda(C, log_a, log_b, table,
                                                    iters)

    def singles():
        for b in range(B):
            sinkhorn.sinkhorn_solve_cuda(C[b], log_a[b], log_b[b], table,
                                         iters)

    def plain():
        return sinkhorn_solve_batched_ref(C, log_a, log_b, table, iters)
    t = dict(ms=cuda_ms(batched, warmup=3, reps=20),
             singles_ms=cuda_ms(singles, warmup=1, reps=10),
             ms_again=cuda_ms(batched, warmup=1, reps=20),
             device_ms=profiled_device_ms(batched, reps=5),
             plain_ms=cuda_ms(plain, warmup=1, reps=2),
             # The 8 cells' C, log_a, log_b read once, f and g written
             # once; ~12 float32 operations per element per iteration.
             **bound(B * 4 * (M * N + M + N + M + N),
                     B * 12 * M * N * n_iter))
    print(f"  timing {B} cells at M={M} N={N}: one batched launch "
          f"{t['ms'] * 1e3:.2f} us ({t['ms_again'] * 1e3:.2f} us again; "
          f"device {fmt_us(t['device_ms'])}), {B} single launches "
          f"{t['singles_ms'] * 1e3:.2f} us, plain batched loop "
          f"{t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.4f} us "
          f"({t['bound_by']})", flush=True)

    out = executor_sweep(cmp9["rows"])
    return dict(max_abs_err=worst, timing=t, split=split, fit=fit, **out)


def executor_sweep(rows9: dict, device=None, cell_spec: str = CELL) -> dict:
    """Phase 10 (b)-(d) on ``cell_spec`` (None: on the card; the rows of
    phase 9's serial plan, by spec, are ``rows9``)."""
    from repro_torch import experiments
    from repro_torch.experiments import runner
    # (b) The device executor on a seed sweep of the cell.
    cells = (experiments.ExperimentPlan.build(
        [cell_spec], [SWEEP_POLICY], seeds=list(SWEEP_SEEDS)).cells()
        + experiments.ExperimentPlan.build([cell_spec], ["baseline"]).cells())
    runs = {}
    for name in ("serial", "device"):
        reset_launches()
        t0 = time.perf_counter()
        rows = experiments.get_executor(name).run(cells, device=device)
        wall = time.perf_counter() - t0
        runs[name] = dict(rows=rows, wall=wall, launches=read_launches())
        bad = [r["error"] for r in rows if r["error"]]
        if bad:
            fail(f"{name} sweep: {bad}")
        live = {k: v for k, v in runs[name]["launches"].items() if v}
        print(f"  (b) {name}: {len(cells)} cells ({SWEEP_POLICY} over seeds "
              f"{SWEEP_SEEDS[0]}-{SWEEP_SEEDS[-1]}, and baseline) in "
              f"{wall:.3f} s of wall; launches {live}", flush=True)
    serial, device_run = runs["serial"], runs["device"]
    for a, b in zip(serial["rows"], device_run["rows"]):
        if results_of(a) != results_of(b):
            fail(f"{a['spec']} seed {a['seed']}: device row differs from the "
                 f"serial row: {results_of(a)} vs {results_of(b)}")
    dl, sl = device_run["launches"], serial["launches"]
    print(f"  device rows equal the serial rows; serial made "
          f"{sl['sinkhorn']} single launches, device "
          f"{dl['sinkhorn_batched']} batched and {dl['sinkhorn']} single; "
          f"walls serial {serial['wall']:.3f} s, device "
          f"{device_run['wall']:.3f} s", flush=True)
    if dl["sinkhorn"] or dl["sinkhorn_iteration"] or \
            not dl["sinkhorn_batched"] or \
            dl["sinkhorn_batched"] >= sl["sinkhorn"]:
        fail(f"the device sweep did not go through batched launches: "
             f"{dl} (serial {sl})")

    # (c) The sharded executor against phase 9's serial rows.
    sharded = {}
    for spec in ("baseline", SWEEP_POLICY):
        t0 = time.perf_counter()
        row = experiments.ExperimentPlan.build([cell_spec], [spec]).run(
            "sharded[shards=2]", strict=True, device=device)[0]
        wall = time.perf_counter() - t0
        ref = rows9[spec]
        # Savings are against the plan's baseline row, which a one-policy
        # plan lacks.
        diff = {k: (ref[k], row.get(k)) for k in results_of(ref)
                if k != "utilization" and not k.endswith("_savings_pct")
                and ref[k] != row.get(k)}
        rel = abs(row["utilization"] - ref["utilization"]) / abs(
            ref["utilization"])
        path = "speculative, spawned workers" if spec == "baseline" \
            else "chained handoff"
        print(f"  (c) sharded[shards=2] {spec} ({path}): {wall:.3f} s of "
              f"wall; carbon {row['carbon_kg']!r} kg, water "
              f"{row['water_kl']!r} kL, violations {row['violation_pct']!r} "
              f"%; {'equal to phase 9' if not diff else diff}; utilization "
              f"relative {rel:.3e}", flush=True)
        if diff or rel > 1e-9:
            fail(f"sharded {spec} differs from the serial row: {diff}, "
                 f"utilization {rel:.3e}")
        sharded[spec] = wall

    # (d) Record every window of the cell, replay them through solve_many.
    cell = experiments.ExperimentPlan.build(
        [cell_spec], ["waterwise[backend=fused,record_windows=true]"]).cells()[0]
    _, _, sched, result, _ = runner.execute(cell, device=device)
    t0 = time.perf_counter()
    replayed = sched.replay_recorded(backend="torch")
    if device is None:
        torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    assigned = sum(int((r.assign >= 0).sum()) for r in replayed)
    feasible = all(r is not None and r.feasible for r in replayed)
    print(f"  (d) {len(sched.recorded)} recorded windows replayed through "
          f"solve_many on the card in {replay_s:.3f} s: all feasible "
          f"{feasible}; {assigned} jobs assigned, the run placed "
          f"{len(result['records'])}", flush=True)
    if not feasible or assigned != len(result["records"]):
        fail("window replay does not match the recorded run")
    return dict(launches=dl["sinkhorn_batched"], serial=sl,
                walls=dict(serial=serial["wall"], device=device_run["wall"]),
                sharded=sharded, replay_s=replay_s,
                windows=len(sched.recorded))


# --- The live service (phase 11) ---------------------------------------------

# The forecast round with the warm-started Sinkhorn carry, as a user types it.
SERVE_POLICY = ("waterwise-forecast[forecaster=holtwinters,backend=fused,"
                "warm=true]")
# (b)'s endless stream, cut at 1.2 hours: a 30-minute hot window at five
# times the diurnal cell's 11.57 jobs/s, then the plain rate.
STORM = dict(rate_per_s=11.57, seed=3, tolerance=4.0, burst=1.0,
             horizon_s=4320.0)
# Below one hot round's ~1,700 arrivals (30 s at 5 x 11.57 jobs/s), so the
# bound sheds there, and above a plain round's ~350. The held jobs come back
# into every round's pricing (re-planning), so the rounds' rows grow to
# several times the bound; the host rounding's M x M arrays bound it.
STORM_BOUND = 500
WORKFLOW_CELL = "workflow-diurnal[days=0.05,jobs_per_day=1e6,seed=3]"


def record_key(r):
    return (r.job.job_id, r.region, r.start_s, r.finish_s, r.carbon_g,
            r.water_l, r.embodied_g)


def serve(sim, pipe, source, config, duration_s: float) -> tuple:
    """One ``DecisionLoop`` run over ``source`` for ``duration_s`` and the
    drain: (loop, report, wall seconds)."""
    from repro_torch.serve import DecisionLoop
    loop = DecisionLoop(sim, pipe, source, config)
    t0 = time.perf_counter()
    rep = loop.run(duration_s)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return loop, rep, wall


def phase_serve(tele, jobs, cap, device=None, days: float = 0.05,
                storm=None, bound: int = STORM_BOUND,
                workflow_spec: str = WORKFLOW_CELL) -> dict:
    """Phase 11 (device None: on the card): (a) the cell streamed through
    the warm-started service against its batch run, (b) a burst storm with
    bounded admission and re-planning, (c) a workflow cell streamed and in
    batch."""
    from repro_torch import experiments, policy
    from repro_torch.serve import (DROP_OLDEST, PoissonBurstArrivals,
                                   ReplayArrivals, ServeConfig)
    from repro_torch.sim.engine import EventSimulator, SimConfig
    from repro_torch.sim.metrics import summarize
    from repro_torch.sim.trace import scale_capacity_for_utilization
    from repro_torch.workflows import precedence_violations, workflow_miss_rate
    storm = dict(STORM, **(storm or {}))
    print("== phase 11: the live service — warm-started rounds, bounded "
          "admission, workflows", flush=True)
    # (a) The cell streamed through the service, against its batch run.
    duration = days * 86400.0
    reset_launches()
    pipe = policy.build(SERVE_POLICY, tele, device=device)
    loop, rep, wall = serve(
        EventSimulator(tele, cap, SimConfig()), pipe,
        ReplayArrivals(copy.deepcopy(jobs)), ServeConfig(queue_bound=1 << 30),
        duration)
    launches = read_launches()
    stream = loop.stepper.result()
    # The batch runs, warm and with the fixed schedule (warm=false), traced
    # alike: their round latencies and solve spans side by side.
    batch, fixed = (run_cell(tele, jobs, cap, device, pipe=policy.build(
        spec, tele, device=device)) for spec in (
            SERVE_POLICY, SERVE_POLICY.replace("warm=true", "warm=false")))
    cold, warm = pipe.sinkhorn_cold_iters, pipe.sinkhorn_warm_iters
    same = [record_key(r) for r in stream["records"]] == \
        [record_key(r) for r in batch["res"]["records"]]
    s_warm, s_fixed = summarize(stream), fixed["summary"]
    print(f"  (a) {len(jobs)} jobs streamed through {SERVE_POLICY} in "
          f"{wall:.3f} s = {len(jobs) / wall:.1f} jobs/s; {rep.rounds} "
          f"decision rounds, {rep.engine_rounds} engine rounds; round p50 "
          f"{rep.p50_round_ms:.3f} ms p99 {rep.p99_round_ms:.3f} ms; records "
          f"equal to the batch run: {same}; Sinkhorn iterations: "
          f"{len(cold)} cold (mean {rep.sinkhorn_cold_iters:.2f}), "
          f"{len(warm)} warm (mean {rep.sinkhorn_warm_iters:.2f}); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"    carbon {s_warm['carbon_kg']!r} kg, water "
          f"{s_warm['water_kl']!r} kL; with warm=false "
          f"{s_fixed['carbon_kg']!r} kg, {s_fixed['water_kl']!r} kL",
          flush=True)
    for name, r in (("batch, warm", batch), ("batch, warm=false", fixed)):
        print(f"    {name}: {r['wall_s']:.3f} s of wall (traced), round p50 "
              f"{r['round_p50_ms']:.3f} ms p99 {r['round_p99_ms']:.3f} ms; "
              f"solver.fused_round {r['stages']['solver.fused_round']:.3f} "
              f"s, policy.price {r['stages']['policy.price']:.3f} s, "
              f"engine.round {r['stages']['engine.round']:.3f} s",
              flush=True)
    if not same or rep.placed != len(jobs):
        fail("the streamed records differ from the batch run")
    for k in ("carbon_kg", "water_kl"):
        a, b = s_warm[k], s_fixed[k]
        if not (np.isfinite(a) and abs(a - b) <= E2E_RTOL * abs(b)):
            fail(f"{k}: warm {a} vs warm=false {b} beyond {E2E_RTOL:.1%}")
    want = len(cold) + len(warm)
    if device is None and (launches["sinkhorn_adaptive"] != want or not want
                           or launches["sinkhorn_iteration"]):
        fail(f"the warm rounds launched {launches}, want one adaptive "
             f"launch for each of {want} fused rounds")

    # (b) A burst storm: bounded admission sheds, the holds and re-planning
    # run on the card.
    horizon = storm["horizon_s"]
    rate = storm.pop("rate_per_s")
    kw = dict(storm, num_regions=tele.num_regions)
    storm_cap = scale_capacity_for_utilization(
        PoissonBurstArrivals(rate, **kw).poll(horizon), horizon / 86400.0,
        tele.num_regions, 0.15)
    reset_launches()
    spipe = policy.build(SERVE_POLICY[:-1] + ",replan=true]", tele,
                         device=device)
    sloop, srep, swall = serve(
        EventSimulator(tele, storm_cap, SimConfig()), spipe,
        PoissonBurstArrivals(rate, **kw),
        ServeConfig(queue_bound=bound, shed_policy=DROP_OLDEST), horizon)
    slaunch = read_launches()
    scold, swarm = spipe.sinkhorn_cold_iters, spipe.sinkhorn_warm_iters
    deferred = 100.0 * spipe.deferred_jobs / max(srep.admitted, 1)
    print(f"  (b) storm {rate} jobs/s x burst {storm['burst']} over "
          f"{horizon:.0f} s, bound {bound} drop-oldest, capacity "
          f"{storm_cap.tolist()}: {srep.jobs_in} in, {srep.admitted} "
          f"admitted, {srep.shed} shed, {srep.placed} placed, "
          f"{srep.violations} violations, {srep.deadline_misses} misses; "
          f"peak admission depth {srep.max_admission_depth}, engine depth "
          f"{srep.max_engine_depth}; {srep.replans} replans, "
          f"{deferred:.3f} % deferred, mean defer {srep.mean_defer_s:.3f} s; "
          f"round p50 {srep.p50_round_ms:.3f} ms p99 "
          f"{srep.p99_round_ms:.3f} ms; {srep.rounds} decision rounds, "
          f"{srep.engine_rounds} engine rounds; {swall:.3f} s of wall; "
          f"Sinkhorn iterations: {len(scold)} cold (mean "
          f"{srep.sinkhorn_cold_iters:.2f}), {len(swarm)} warm (mean "
          f"{srep.sinkhorn_warm_iters:.2f}); launches "
          f"{ {k: v for k, v in slaunch.items() if v} }", flush=True)
    if not (srep.jobs_in == srep.admitted + srep.shed and srep.shed > 0
            and srep.placed == srep.admitted
            and srep.deadline_misses == srep.violations + srep.shed
            and srep.max_admission_depth <= bound
            and sloop.admission.shed_ids == sorted(sloop.admission.shed_ids)):
        fail(f"storm accounting: {srep}")
    want = len(scold) + len(swarm)
    if device is None and (slaunch["sinkhorn_adaptive"] != want or not want
                           or slaunch["sinkhorn_iteration"]):
        fail(f"the storm launched {slaunch}, want one adaptive launch for "
             f"each of {want} fused rounds")

    # (c) A workflow cell, streamed and in batch.
    inst, cell = experiments.build_instance(workflow_spec)
    spec = "waterwise[backend=fused]"
    wbatch = EventSimulator(inst.tele, inst.capacity, SimConfig()).run(
        copy.deepcopy(inst.jobs), policy.build(spec, inst.tele,
                                               device=device))
    wloop, wrep, wwall = serve(
        EventSimulator(inst.tele, inst.capacity, SimConfig()),
        policy.build(spec, inst.tele, device=device),
        ReplayArrivals(copy.deepcopy(inst.jobs)),
        ServeConfig(queue_bound=1 << 30), cell["days"] * 86400.0)
    wstream = wloop.stepper.result()
    wsame = [record_key(r) for r in wstream["records"]] == \
        [record_key(r) for r in wbatch["records"]]
    bad = (precedence_violations(wstream["records"]),
           precedence_violations(wbatch["records"]))
    miss, n_wf = workflow_miss_rate(wstream["records"])
    print(f"  (c) {workflow_spec} under {spec}: {len(inst.jobs)} tasks of "
          f"{n_wf} workflows streamed in {wwall:.3f} s; records equal to the "
          f"batch run: {wsame}; precedence violations {bad}; workflow miss "
          f"rate {100.0 * miss:.3f} %", flush=True)
    if not wsame or bad != (0, 0) or wrep.placed != len(inst.jobs):
        fail(f"workflow stream vs batch: equal {wsame}, violations {bad}, "
             f"placed {wrep.placed} of {len(inst.jobs)}")
    return dict(launches=launches["sinkhorn_adaptive"],
                storm_launches=slaunch["sinkhorn_adaptive"],
                cold=rep.sinkhorn_cold_iters, warm=rep.sinkhorn_warm_iters,
                rounds=len(cold) + len(warm))


# --- LM training (phase 12) ---------------------------------------------------

# (a) card vs CPU, float32, published widths, one AdamW step at B 2, S 256:
# the smallest depths that hold every kind of layer (recurrentgemma-2B's 3
# is one group: two RG-LRU layers and a local attention layer).
TRAIN_PARITY = dict(qwen2_1_5b=2, recurrentgemma_2b=3, mamba2_2_7b=2)
TRAIN_PARITY_SHAPE = (2, 256)
# One float32 step, card vs CPU (the card's scalar flash and SSD kernels,
# its fused RG-LRU pair and cuBLAS against the CPU's plain versions and
# BLAS): the loss and grad_norm within 1e-4 relative; each first moment
# (0.1 x the clipped gradient) within 1e-3 of its leaf's largest entry;
# each parameter's update within 3 lr (|u| <= 1 + weight decay · |p|: an
# entry whose gradient is as small as its float32 error may step the
# other way), and within 1e-2 lr on all but 1e-3 of the entries.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_MU_REL = 1e-3
TRAIN_DELTA_REL, TRAIN_DELTA_FRAC = 1e-2, 1e-3
# (b) the slice: qwen2-1.5B at full width and depth in bf16, remat "full"
# as published; global batch 8 at S 2048 in two microbatches of 4 (phase
# 8's prefill shape), 6 steps of SyntheticTokens(vocab, 2048, 8, seed=0),
# AdamW at its defaults, the reference's (``adamw()``: 100 warmup steps to
# 3e-4, as its dry run trains). Every later step's loss must be below the
# first's. (Without the warmup, at a peak of 1e-4 or 1e-3 from the first
# step, the loss jumps at the third or fourth step on the card;
# ``train_probe.py`` holds that against float32 on the card and the CPU.)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = (
    "qwen2_1_5b", 8, 2048, 2, 6)
# H100 SXM dense bf16 peak (NVIDIA data sheet, 700 W).
BF16_OPS_PER_S = 989e12
# (c) one bf16 step each, published widths, cut depth, B 2 at S 2048: the
# other kernel paths of training (griffin's fused RG-LRU forward and
# backward and the D 256 flash, Mamba-2's wgmma SSD, MLA's (96, 64)
# flash, and SeamlessM4T's D 64 flash, non-causal over 400 frames).
TRAIN_PATHS = dict(recurrentgemma_2b=6, mamba2_2_7b=4, minicpm3_4b=2,
                   seamless_m4t_large_v2=1)
TRAIN_PATH_SHAPE = (2, 2048)


def train_counts(cfg, grad_accum: int) -> tuple:
    """(flash calls by (variant, D_qk, D_v, causal), SSD calls, RG-LRU
    launches) of one ``make_train_step`` under remat "full": every
    layer's forward runs twice (the step's and the backward's recompute),
    each RG-LRU layer's backward once, for each microbatch."""
    flash = collections.Counter({k: 2 * grad_accum * n
                                 for k, n in flash_calls(cfg).items()})
    ssd = 2 * grad_accum * cfg.n_layers if cfg.ssm else 0
    n_rec = n_recurrent(cfg)
    return flash, ssd, dict(layer_fwd=2 * grad_accum * n_rec,
                            layer_bwd=grad_accum * n_rec, fwd=0, bwd=0)


def token_batch(cfg, B: int, S: int, device, seed: int = 0,
                frames: int = PARITY_FRAMES) -> dict:
    """Step ``seed`` of ``SyntheticTokens(vocab, S, B)`` on ``device``, with
    frames (encdec) or patches (vision) standard normal from the seed."""
    from repro_torch.data import SyntheticTokens
    batch = SyntheticTokens(cfg.vocab, S, B, seed=seed,
                            device=str(device)).batch(0)
    extra = lm_inputs(cfg, B, frames, seed)
    batch.update({k: v.to(device) for k, v in extra.items()})
    return batch


def reset_lm_launches() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    fk.LAUNCHES, sk.LAUNCHES = 0, 0
    fk.LAUNCHES_BY_VARIANT.update(wgmma=0, scalar=0)
    reset_ssd_launches()
    rk.LAUNCHES.update(layer_fwd=0, layer_bwd=0, fwd=0, bwd=0)


def reset_ssd_launches() -> None:
    """Every SSD count by entry, and the calls from a state, to 0."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    sk.LAUNCHES_BY_VARIANT.update(dict.fromkeys(sk.LAUNCHES_BY_VARIANT, 0))
    sk.LAUNCHES_FROM_STATE.update(dict.fromkeys(sk.LAUNCHES_FROM_STATE, 0))


def ssd_counts(**counts) -> dict:
    """The SSD's ``LAUNCHES_BY_VARIANT`` with ``counts`` and 0 elsewhere:
    the scan by variant, the final state from zero apart."""
    return dict(dict(wgmma=0, scalar=0, wgmma_final=0, scalar_final=0),
                **counts)


def read_lm_launches() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    return dict(flash=dict(fk.LAUNCHES_BY_VARIANT),
                ssd=dict(sk.LAUNCHES_BY_VARIANT), rglru=dict(rk.LAUNCHES))


@contextlib.contextmanager
def plain_backwards():
    """Count and time the flash and SSD wrappers' backwards (each ``ops``
    module's ``plain_vjp``: the plain version's gradient) by CUDA events
    around each: yields (a Counter of calls, flash_backward and
    ssd_backward; the list of (start, end) event pairs)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    calls, pairs = collections.Counter(), []
    targets = ((fops, "flash_backward"), (sops, "ssd_backward"))
    saved = [mod.plain_vjp for mod, _ in targets]

    def wrap(fn, key):
        def timed(*args, **kw):
            calls[key] += 1
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            out = fn(*args, **kw)
            t1.record()
            pairs.append((t0, t1))
            return out
        return timed
    for (mod, key), fn in zip(targets, saved):
        mod.plain_vjp = wrap(fn, key)
    try:
        yield calls, pairs
    finally:
        for (mod, _), fn in zip(targets, saved):
            mod.plain_vjp = fn


def expect_plain(cfg, plain: collections.Counter, bwd: collections.Counter,
                 grad_accum: int, where: str) -> None:
    """On the card the plain versions run only inside the wrappers'
    backwards: one blocked attention per attention call's backward, one
    chunked SSD per SSD layer's, each microbatch; nothing else."""
    n_attn = sum(flash_calls(cfg).values()) * grad_accum
    n_ssd = cfg.n_layers * grad_accum if cfg.ssm else 0
    want_bwd = collections.Counter(flash_backward=n_attn,
                                   ssd_backward=n_ssd)
    want_plain = collections.Counter(online_softmax_attention=n_attn,
                                     ssd_ref=n_ssd)
    if +bwd != +want_bwd or +plain != +want_plain:
        fail(f"{where}: plain versions {dict(plain)} from backwards "
             f"{dict(bwd)}, want {dict(+want_plain)} from "
             f"{dict(+want_bwd)} (no plain forward on the card)")


def check_train_launches(cfg, got: dict, shapes, grad_accum: int,
                         where: str) -> None:
    want_shapes, n_ssd, rglru = train_counts(cfg, grad_accum)
    by_kind = collections.Counter()
    for (kind, *_), n in want_shapes.items():
        by_kind[kind] += n
    ssd_kind = "wgmma" if cfg.compute_dtype == torch.bfloat16 else "scalar"
    want = dict(flash=dict(wgmma=by_kind["wgmma"], scalar=by_kind["scalar"]),
                ssd=ssd_counts(**{ssd_kind: n_ssd}),
                rglru=rglru)
    if got != want or +shapes != +want_shapes:
        fail(f"{where}: launches {got} by (variant, D_qk, D_v, causal) "
             f"{dict(shapes)}, want {want} by {dict(+want_shapes)}")


def live_leaves(state) -> None:
    """Every first moment (0.1 x the clipped gradient) finite and not all
    zero."""
    from repro_torch.optim.adamw import tree_leaves
    for i, m in enumerate(tree_leaves(state.mu)):
        if not torch.isfinite(m).all():
            fail(f"gradient leaf {i} {tuple(m.shape)} is not finite")
        if m.numel() > 1 and not m.abs().max().item() > 0:
            fail(f"gradient leaf {i} {tuple(m.shape)} is all zero")


def train_parity(arch: str, depth: int, dev) -> dict:
    """(a): one float32 AdamW step on the card and on the CPU from the same
    weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, to_device
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train_loop import make_train_step
    start = time.perf_counter()
    cfg = get_config(arch).replace(n_layers=depth, dtype="float32",
                                   param_dtype="float32")
    model = Model(cfg)
    B, S = TRAIN_PARITY_SHAPE
    card_params = lm_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), 9)
    host_params = to_device(card_params, "cpu")
    opt = adamw()
    lr = opt.lr(1)
    step = make_train_step(model, opt)
    batch = token_batch(cfg, B, S, dev, seed=1)
    reset_lm_launches()
    with flash_call_recorder() as shapes, plain_call_counter() as plain, \
            plain_backwards() as (bwd, _):
        card = step(card_params, opt.init(card_params), batch)
        torch.cuda.synchronize()
    launches = read_lm_launches()
    check_train_launches(cfg, launches, shapes, 1, f"{arch} (a)")
    expect_plain(cfg, plain, bwd, 1, f"{arch} (a)")
    live_leaves(card[1])
    host = step(host_params, opt.init(host_params),
                {k: v.cpu() for k, v in batch.items()})
    loss_err, gn_err = (abs(card[2][k].item() - host[2][k].item())
                        / abs(host[2][k].item()) for k in ("loss",
                                                           "grad_norm"))
    if not loss_err <= TRAIN_LOSS_RTOL or not gn_err <= TRAIN_LOSS_RTOL:
        fail(f"{arch} (a): loss {card[2]['loss'].item()} vs "
             f"{host[2]['loss'].item()}, grad_norm "
             f"{card[2]['grad_norm'].item()} vs "
             f"{host[2]['grad_norm'].item()}: beyond {TRAIN_LOSS_RTOL}")
    mu_err = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                 for a, b in zip(tree_leaves(card[1].mu),
                                 tree_leaves(host[1].mu))
                 if b.abs().max().item() > 0)
    check(f"{arch} (a) first moments, relative to each leaf's max",
          mu_err, TRAIN_MU_REL)
    worst, off, n = 0.0, 0, 0
    for a, b in zip(tree_leaves(card[0]), tree_leaves(host[0])):
        d = (a.cpu() - b).abs()
        worst = max(worst, d.max().item())
        off += int((d > TRAIN_DELTA_REL * lr).sum())
        n += d.numel()
    check(f"{arch} (a) parameter updates", worst, 3 * lr)
    if off > TRAIN_DELTA_FRAC * n:
        fail(f"{arch} (a): {off} of {n} updates differ by more than "
             f"{TRAIN_DELTA_REL} lr")
    out = dict(loss=card[2]["loss"].item(),
               cpu_loss=host[2]["loss"].item(), loss_rel_err=loss_err,
               grad_norm=card[2]["grad_norm"].item(), grad_norm_rel_err=gn_err,
               mu_rel_err=mu_err, update_max_err=worst, lr=lr,
               updates_off=off, n_params=n, launches=launches,
               flash_shapes=dict(shapes), plain=dict(plain),
               backward_plain=dict(bwd),
               wall_s=time.perf_counter() - start)
    print(f"  (a) {arch} depth {depth}, float32, B {B}, S {S}: loss card "
          f"{out['loss']:.6f} cpu {out['cpu_loss']:.6f} (rel "
          f"{loss_err:.1e}), grad_norm {out['grad_norm']:.5f} (rel "
          f"{gn_err:.1e}), first moments within {mu_err:.1e} of each "
          f"leaf's max, updates within {worst:.1e} (lr {lr:.1e}; {off} of "
          f"{n} beyond {TRAIN_DELTA_REL} lr); launches {launches}; plain "
          f"versions {dict(plain)} from backwards {dict(bwd)}; "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def train_profile(step, params, state, batch) -> tuple:
    """One profiled step: (params, state, dict(wall_ms, device_ms, top,
    ours)), the port's kernels' device ms by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {ev.key: ev.self_device_time_total / 1e3
               for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")
               and ev.self_device_time_total > 0}
    ours = {label: sum(ms for name, ms in by_name.items()
                       if any(key in name for key in keys))
            for label, keys in (
                ("flash_attention_sm90", ("flash_fwd_sm90",)),
                ("flash_attention", ("flash_fwd<",)),
                ("ssd_scan_sm90", ("ssd_chunk_state", "ssd_state_pass",
                                   "ssd_chunk_scan")),
                ("rglru_layer_fwd", ("rglru_fwd_kernel<true",)),
                ("rglru_layer_bwd", ("rglru_bwd_kernel<true",)))}
    return params, state, dict(
        wall_ms=wall * 1e3, device_ms=sum(by_name.values()), ours=ours,
        top=sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
        loss=met["loss"].item())


def train_slice(dev) -> dict:
    """(b): qwen2-1.5B at full width and depth, bf16, 6 steps."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step
    start = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    if cfg.remat != "full" or cfg.compute_dtype != torch.bfloat16:
        fail(f"{TRAIN_ARCH}: remat {cfg.remat}, dtype {cfg.dtype}; the "
             f"slice trains the published bf16, remat 'full' config")
    model = Model(cfg)
    n_params = model.param_count()
    params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       10)
    opt = adamw()
    state = opt.init(params)
    step = make_train_step(model, opt, grad_accum=TRAIN_ACCUM)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls, plain_ms, per_step = [], [], [], [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        torch.cuda.synchronize()
        reset_lm_launches()
        with flash_call_recorder() as shapes, \
                plain_call_counter() as plain, \
                plain_backwards() as (bwd, pairs):
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        plain_ms.append(sum(a.elapsed_time(b) for a, b in pairs))
        launches = read_lm_launches()
        check_train_launches(cfg, launches, shapes, TRAIN_ACCUM,
                             f"{TRAIN_ARCH} step {i + 1}")
        expect_plain(cfg, plain, bwd, TRAIN_ACCUM,
                     f"{TRAIN_ARCH} step {i + 1}")
        losses.append(met["loss"].item())
        gnorms.append(met["grad_norm"].item())
        per_step.append((launches, dict(shapes)))
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = float(np.median(walls[1:]))
    plain_med = float(np.median(plain_ms[1:]))
    # One more step, profiled (device kernels, busy share).
    params, state, prof = train_profile(step, params, state,
                                        data.batch(TRAIN_STEPS))
    out = dict(
        arch=TRAIN_ARCH, params=n_params, layers=cfg.n_layers,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, grad_accum=TRAIN_ACCUM,
        losses=losses, grad_norms=gnorms, step_walls_s=walls,
        median_step_s=med, tokens_per_s=tokens / med,
        model_flops_share=6 * n_params * tokens / med / BF16_OPS_PER_S,
        peak_bytes=peak, launches=per_step[-1][0],
        flash_shapes=per_step[-1][1],
        plain_backward_ms=plain_ms, plain_backward_median_ms=plain_med,
        plain_backward_calls=sum(bwd.values()), profile=prof,
        wall_s=time.perf_counter() - start)
    print(f"  (b) {TRAIN_ARCH}: {n_params / 1e9:.4f} B parameters, "
          f"{cfg.n_layers} layers, bf16, remat {cfg.remat}; global batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_ACCUM} microbatches; "
          f"loss by step {['%.4f' % v for v in losses]}; grad_norm "
          f"{['%.3f' % v for v in gnorms]}; step walls "
          f"{['%.3f' % v for v in walls]} s; median of steps 2-"
          f"{TRAIN_STEPS} {med * 1e3:.1f} ms = {tokens / med:.0f} tokens/s; "
          f"6 N tokens/s = {out['model_flops_share'] * 100:.2f} % of "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches a step {per_step[-1][0]} "
          f"(flash by (variant, D_qk, D_v, causal) {per_step[-1][1]})",
          flush=True)
    print(f"    plain attention backwards: {sum(bwd.values())} calls a "
          f"step, median {plain_med:.1f} ms of device time (steps 2-"
          f"{TRAIN_STEPS}) in the median step of {med * 1e3:.1f} ms wall "
          f"({plain_med / (med * 1e3) * 100:.1f} %)", flush=True)
    print(f"    one profiled step: wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']:.1f} ms (busy "
          f"{prof['device_ms'] / prof['wall_ms'] * 100:.1f} %); the port's "
          "kernels (device ms, share): " + ", ".join(
              f"{k} {ms:.2f} ({ms / prof['device_ms'] * 100:.1f} %)"
              for k, ms in prof["ours"].items() if ms)
          + "; top kernels (device ms): " + "; ".join(
              f"{name[:60]} {ms:.1f}" for name, ms in prof["top"]),
          flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        fail(f"{TRAIN_ARCH}: loss {losses}, grad_norm {gnorms}")
    if not max(losses[1:]) < losses[0]:
        fail(f"{TRAIN_ARCH}: a later step's loss is not below the "
             f"first's: {losses}")
    live_leaves(state)
    del params, state
    torch.cuda.empty_cache()
    return out


def train_path(arch: str, depth: int, dev) -> dict:
    """(c): one bf16 step at published width and cut depth."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step
    start = time.perf_counter()
    cfg = get_config(arch).replace(n_layers=depth)
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=depth)
    model = Model(cfg)
    params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       11)
    opt = adamw()
    step = make_train_step(model, opt)
    B, S = TRAIN_PATH_SHAPE
    batch = token_batch(cfg, B, S, dev, seed=2)
    torch.cuda.synchronize()
    reset_lm_launches()
    with flash_call_recorder() as shapes, plain_call_counter() as plain, \
            plain_backwards() as (bwd, _):
        t0 = time.perf_counter()
        params, state, met = step(params, opt.init(params), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_lm_launches()
    check_train_launches(cfg, launches, shapes, 1, f"{arch} (c)")
    expect_plain(cfg, plain, bwd, 1, f"{arch} (c)")
    if not np.isfinite(met["loss"].item()):
        fail(f"{arch} (c): loss {met['loss'].item()}")
    live_leaves(state)
    # A second step, its plain backwards timed by events.
    with plain_backwards() as (_, pairs):
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    plain_ms = sum(a.elapsed_time(b) for a, b in pairs)
    out = dict(loss=met["loss"].item(), grad_norm=met["grad_norm"].item(),
               launches=launches, flash_shapes=dict(shapes),
               step_wall_s=wall, second_step_wall_s=wall2,
               plain_backward_ms=plain_ms, wall_s=time.perf_counter() - start)
    print(f"  (c) {arch} depth {depth}"
          + (f" (+{cfg.enc_layers} encoder, {PARITY_FRAMES} frames)"
             if cfg.enc_layers else "")
          + f", bf16, B {B}, S {S}: loss {out['loss']:.4f}, grad_norm "
          f"{out['grad_norm']:.4f}; first step {wall * 1e3:.1f} ms "
          f"(allocations included), second {wall2 * 1e3:.1f} ms, of it "
          f"{plain_ms:.1f} ms of device time in {len(pairs)} plain "
          f"backwards ({plain_ms / (wall2 * 1e3) * 100:.1f} %); launches "
          f"{launches}; flash calls {dict(shapes)}; plain versions "
          f"{dict(plain)} from backwards {dict(bwd)}", flush=True)
    del params, state
    torch.cuda.empty_cache()
    return out


def phase_lm_train(dev) -> dict:
    print("== phase 12: LM training — (a) card vs CPU in float32 ("
          + ", ".join(f"{a} depth {d}" for a, d in TRAIN_PARITY.items())
          + f"; B, S {TRAIN_PARITY_SHAPE}), (b) {TRAIN_ARCH} at full width "
          f"and depth in bf16 ({TRAIN_STEPS} steps, global batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, grad_accum {TRAIN_ACCUM}), (c) "
          + ", ".join(f"{a} depth {d}" for a, d in TRAIN_PATHS.items())
          + f" in bf16 (B, S {TRAIN_PATH_SHAPE})", flush=True)
    parity = {a: train_parity(a, d, dev) for a, d in TRAIN_PARITY.items()}
    torch.cuda.empty_cache()
    slice_ = train_slice(dev)
    paths = {a: train_path(a, d, dev) for a, d in TRAIN_PATHS.items()}
    return dict(parity=parity, slice=slice_, paths=paths)


# --- Distribution (phase 13) --------------------------------------------------

# (a) qwen2-72B at full width in bf16, its depth cut to 16 of 80 layers to
# fit one card (the embedding and the untied head 2 x 153,600 x 8192, a
# layer about 0.878 B parameters: 16.56 B, 33 GB), served as phase 8
# serves (B 4, prompt 2048, 32 new tokens): one wgmma flash call a layer
# at [B 4, 64 query heads over 8 kv heads, 2048, 128], causal.
DIST_ARCH, DIST_DEPTH = "qwen2_72b", 16
# (b) the sharded train step on a one-rank NCCL process group and a (1, 1)
# ("data", "model") mesh: phase 12(a)'s qwen2-1.5B (full width, depth 2,
# float32, B 2 x 256), bitwise against the unsharded step (at one rank
# every gather and reduction is the identity).
SHARDED_ARCH, SHARDED_DEPTH = "qwen2_1_5b", 2
# (d) the sharded serving steps (make_prefill_step / make_decode_step with
# the mesh) on the same one-rank mesh, bf16, B 4, prompt 2048, 32 new
# tokens: qwen2-1.5B at full depth (28 wgmma flash launches a prefill),
# mamba2-2.7B at 4 layers (the wgmma SSD) and recurrentgemma-2B at 3 (two
# fused RG-LRU layers and flash at D 256), each bitwise against its
# unsharded steps (prefill logits, every token) with the same launches.
SERVE_SHARDED = dict(qwen2_1_5b=None, mamba2_2_7b=4, recurrentgemma_2b=3)
# (c) the dry run's costs of qwen2-72B train_4k at 2 of 80 layers on both
# production meshes, counted over a fake process group in a subprocess of
# `python -m repro_torch.launch.dryrun`: per device and step, 9.0521e13
# FLOPs as this count gives them on the CPU (one microbatch x grad_accum
# 16; attention, MLPs, embedding and logits tensor-parallel over the 16
# model ranks), held within DRYRUN_RTOL (another torch may decompose an
# op otherwise).
DRYRUN_DEPTH, DRYRUN_FLOPS, DRYRUN_RTOL = 2, 90520730730496, 1e-2
# (e) qwen2-72B whole (80 layers), bf16, as rank 0 of the dry run's fake
# process group (``launch.dryrun.fake_group``: its collectives return at
# once and move nothing) on a (1, 8) ("data", "model") mesh over the card:
# one card's share of a tensor-parallel deployment on 8 cards (about 18.2
# of the model's 145.5 GB), each leaf's rank-0 block drawn on the card
# from a seed (no full tensor is ever built). A B 4 x 2048 prefill and
# TP_NEW decode steps: one wgmma flash launch a layer on the rank's 8 q
# heads over its 1 kv head, [4, 2048, 8, 128] group 8, no plain version.
# The times are one rank's compute alone; its tokens are no result (the
# gathered logits hold only this rank's vocabulary block).
TP_ARCH, TP_MESH, TP_B, TP_S, TP_NEW = "qwen2_72b", (1, 8), 4, 2048, 32
# (f) DeepSeek-V2-236B whole (60 layers), bf16, as rank 0 of 8 on a (1, 8)
# mesh: the rank's 16 of 128 MLA heads, 20 of 160 routed experts and 1/8
# of the shared experts, the dense layer's MLP and the vocabulary, about
# 29.9 B parameters (60 GB) drawn on the card — DeepSeek's own bf16
# serving layout on 8 x 80 GB. The same prefill and decode steps: one
# flash_fwd_sm90<192, 128> launch a layer at [4, 2048, 16, 192/128].
TP_MLA_ARCH, TP_MLA_MESH = "deepseek_v2_236b", (1, 8)
# (g) the two mixers at full width as rank 0 of 2 on a (1, 2) mesh:
# mamba2-2.7B at 4 layers (the wgmma SSD at the rank's 40 of 80 heads,
# [4, 2048, 40, 64], N 128) and recurrentgemma-2B at 3 (rglru_layer_fwd at
# its 1280 of 2560 channels, flash at D 256 on its 5 of 10 q heads over
# the replicated kv head).
TP_MIXERS, TP_MIXER_MESH = dict(mamba2_2_7b=4, recurrentgemma_2b=3), (1, 2)
# (h) the residual stream split over model, on (e)'s share in (e)'s
# process group (the parameters' placements do not change under these
# rules): a B 4 x 2048 prefill of qwen2-72B as rank 0 of (1, 8) under
# ``seqpar`` (the sequence: 256 positions a rank between sub-layers; a
# warm second prefill timed) and one under ``act2d`` (the embedding: 1024
# channels a rank), beside one under the baseline rules: walls, device
# time by kind (one profiled prefill each) and peak memory; 80
# flash_fwd_sm90<128, 128> launches at (e)'s shape, no plain version.
SPLIT_VARIANTS = ("baseline", "seqpar", "act2d")
# (c) the dry run's costs under the seqpar rules beside the baseline's.
DRYRUN_VARIANTS = ("baseline", "seqpar")


@contextlib.contextmanager
def first_flash_call():
    """Copies of the first model-layout flash call's q, k, v, keywords and
    output (the wrapper's ``_flash_cuda``, which launches the kernel)."""
    from repro_torch.kernels.flash_attention import ops as fops
    seen = {}
    inner = fops._flash_cuda

    def capture(q, k, v, **kw):
        o = inner(q, k, v, **kw)
        if not seen:
            seen.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=dict(kw),
                        out=o.clone())
        return o
    fops._flash_cuda = capture
    try:
        yield seen
    finally:
        fops._flash_cuda = inner


def serve_qwen2_72b() -> dict:
    """(a): phase 8's run of qwen2-72B at 16 layers, its first flash call
    held against the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    cfg = get_config(DIST_ARCH).replace(n_layers=DIST_DEPTH)
    with first_flash_call() as first:
        out = serve_arch(DIST_ARCH, cfg)
    want = (4, 2048, cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim_)
    if tuple(first["q"].shape) != want or not first["kw"]["causal"]:
        fail(f"{DIST_ARCH}: first flash call q {tuple(first['q'].shape)} "
             f"{first['kw']}, want {want} causal")
    ref = flash_attention_ref(first["q"], first["k"], first["v"],
                              **first["kw"])
    err, rel = hold_flash(f"{DIST_ARCH} (a) first flash call", first["out"],
                          ref, torch.bfloat16)
    print(f"  (a) {DIST_ARCH} first flash call q {want} (group "
          f"{want[3]}): max |d| {err:.3e}, RMS(d) / RMS(plain) {rel:.3e} "
          f"against the plain version", flush=True)
    del first, ref
    torch.cuda.empty_cache()
    return dict(out, flash_max_abs_err=err, flash_rel_rms=rel,
                flash_shape=list(want))


@contextlib.contextmanager
def one_rank_mesh(workdir: str):
    """A one-rank NCCL process group (file rendezvous in ``workdir``) and
    its (1, 1) ("data", "model") mesh, destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(workdir, "nccl-init"),
        world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def sharded_world1(dev, workdir: str, mesh) -> dict:
    """(b): one sharded ``make_train_step`` on the one-rank NCCL mesh
    against the unsharded step on the same weights and tokens; then a
    checkpoint of the sharded state restored onto the mesh."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import (make_train_step,
                                                shard_train_state)
    start = time.perf_counter()
    cfg = get_config(SHARDED_ARCH).replace(
        n_layers=SHARDED_DEPTH, dtype="float32", param_dtype="float32")
    model = Model(cfg)
    B, S = TRAIN_PARITY_SHAPE
    params = lm_params(cfg, torch.Generator(device="cuda")
                       .manual_seed(0), 9)
    batch = token_batch(cfg, B, S, dev, seed=1)
    opt = adamw()
    where = f"{SHARDED_ARCH} (13b)"
    reset_lm_launches()
    with flash_call_recorder() as shapes:
        t0 = time.perf_counter()
        ref = make_train_step(model, opt)(params, opt.init(params),
                                          batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    check_train_launches(cfg, read_lm_launches(), shapes, 1,
                         where + " unsharded")
    sp, so = shard_train_state(model, params, opt, mesh)
    step = make_train_step(model, opt, mesh=mesh)
    reset_lm_launches()
    with flash_call_recorder() as shapes:
        t0 = time.perf_counter()
        new, state, met = step(sp, so, batch)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    launches = read_lm_launches()
    check_train_launches(cfg, launches, shapes, 1, where + " sharded")
    for t in tree_leaves((new, state.mu, state.nu)):
        if not sharding.is_dtensor(t) or t.device.type != "cuda":
            fail(f"{where}: a state leaf is {type(t).__name__} on "
                 f"{t.device}, not a DTensor on the card")
    pairs = list(zip(tree_leaves((new, state.mu, state.nu)),
                     tree_leaves((ref[0], ref[1].mu, ref[1].nu))))
    same = sum(torch.equal(a.to_local(), b) for a, b in pairs)
    same += sum(torch.equal(met[k], ref[2][k])
                for k in ("loss", "grad_norm"))
    worst = max(((a.to_local() - b).abs().max()
                 / b.abs().max().clamp(min=1e-30)).item()
                for a, b in pairs)
    if same != len(pairs) + 2:
        print(f"  (b) NOT bitwise: {len(pairs) + 2 - same} of "
              f"{len(pairs) + 2} leaves and metrics differ, worst "
              f"{worst:.3e} relative", flush=True)
        check(f"{where} sharded vs unsharded, relative", worst, 1e-7)
    ckpt = os.path.join(workdir, "sharded-ckpt")
    tree = dict(params=new, mu=state.mu, nu=state.nu)
    t0 = time.perf_counter()
    save_checkpoint(ckpt, 1, tree)
    places = tree_map(lambda t: (t.device_mesh, t.placements), new)
    back = restore_checkpoint(ckpt, 1, tree, dict(
        params=places, mu=places, nu=places))
    ckpt_s = time.perf_counter() - t0
    restored = sum(torch.equal(a.to_local(), b.to_local())
                   and a.placements == b.placements
                   for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    if restored != len(tree_leaves(tree)):
        fail(f"{where}: {len(tree_leaves(tree)) - restored} leaves of "
             f"the restored checkpoint differ from the saved state")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = dict(loss=met["loss"].item(), grad_norm=met["grad_norm"].item(),
               bitwise=same == len(pairs) + 2, leaves=len(pairs),
               worst_rel=worst, launches=launches,
               flash_shapes=dict(shapes), unsharded_s=plain_s,
               sharded_s=sharded_s, checkpoint_s=ckpt_s,
               wall_s=time.perf_counter() - start)
    print(f"  (b) {SHARDED_ARCH} depth {SHARDED_DEPTH}, float32, B {B}, S "
          f"{S} on a (1, 1) NCCL mesh: loss {out['loss']:.6f}, grad_norm "
          f"{out['grad_norm']:.5f}; sharded step "
          + ("bitwise" if out["bitwise"] else f"within {worst:.2e}")
          + f" the unsharded one ({len(pairs)} parameter and moment leaves,"
          f" every one a DTensor on the card); step {sharded_s * 1e3:.1f} "
          f"ms sharded, {plain_s * 1e3:.1f} ms unsharded (first calls); "
          f"launches {launches}; checkpoint of the sharded state saved and "
          f"restored onto the mesh bit for bit in {ckpt_s:.1f} s; "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def serve_sharded(arch: str, depth, dev, mesh) -> dict:
    """(d): one model served through ``make_prefill_step`` /
    ``make_decode_step`` unsharded and then with the one-rank mesh
    (parameters and cache as DTensors placed by their logical axes), bf16,
    B 4, prompt 2048, 32 new tokens: the prefill logits and every token
    bitwise, the kernel launches equal and exactly phase 8's, no plain
    version on the path."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.serve_loop import _splice
    from repro_torch.runtime.train_loop import (make_decode_step,
                                                make_prefill_step,
                                                shard_serve_state)
    B, S, NEW = 4, 2048, 32
    cfg = get_config(arch)
    if depth:
        cfg = cfg.replace(n_layers=depth)
    model = Model(cfg)
    params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(0), 8)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)

    def locals_(tree):
        return [t.to_local() if hasattr(t, "to_local") else t
                for t in tree_leaves(tree) if t is not None]

    def run(prefill, decode, params, cache):
        with torch.inference_mode():
            logits, built = prefill(params, dict(tokens=toks))
            _splice(locals_(cache), locals_(built))
            tok, out = torch.argmax(logits, dim=-1)[:, None], []
            out.append(tok)
            for i in range(NEW - 1):
                tok, _, cache = decode(params, cache, tok, S + i)
                out.append(tok)
            torch.cuda.synchronize()
        return logits, torch.cat(out, dim=1)

    runs = {}
    # In turns, so the second of each is timed warm.
    for name in ("unsharded", "sharded", "unsharded again",
                 "sharded again"):
        cache = model.init_cache(B, S + NEW, dev)
        if name.startswith("sharded"):
            p, cache = shard_serve_state(model, params, cache, mesh)
            steps = (make_prefill_step(model, mesh),
                     make_decode_step(model, mesh))
        else:
            p, steps = params, (make_prefill_step(model),
                                make_decode_step(model))
        reset_lm_launches()
        with plain_call_counter() as plain, \
                flash_call_recorder() as shapes:
            t0 = time.perf_counter()
            logits, tokens = run(*steps, p, cache)
            wall = time.perf_counter() - t0
        runs[name] = dict(logits=logits, tokens=tokens, wall_s=wall,
                          launches=read_lm_launches(),
                          flash_shapes=dict(shapes), plain=dict(plain))
        del cache, p
    ref, got = runs["unsharded"], runs["sharded"]
    n_attn = sum(flash_calls(cfg).values())
    want = dict(flash=dict(wgmma=n_attn, scalar=0),
                ssd=ssd_counts(wgmma=cfg.n_layers if cfg.ssm else 0),
                rglru=dict(layer_fwd=n_recurrent(cfg), layer_bwd=0, fwd=0,
                           bwd=0))
    where = f"{arch} (13d)"
    for name, r in runs.items():
        if r["launches"] != want or r["flash_shapes"] != dict(
                +flash_calls(cfg)):
            fail(f"{where} {name}: launches {r['launches']} by shape "
                 f"{r['flash_shapes']}, want {want}")
        if sum(r["plain"].values()):
            fail(f"{where} {name}: plain versions ran on the card's main "
                 f"path: {r['plain']}")
    bitwise = (torch.equal(got["logits"], ref["logits"])
               and torch.equal(got["tokens"], ref["tokens"]))
    if not bitwise:
        fail(f"{where}: the sharded steps differ from the unsharded: "
             f"prefill logits max |d| "
             f"{(got['logits'] - ref['logits']).abs().max().item():.3e}, "
             f"{int((got['tokens'] != ref['tokens']).sum())} tokens")
    for name in ("unsharded again", "sharded again"):
        if not torch.equal(runs[name]["tokens"], ref["tokens"]):
            fail(f"{where}: {name}: the tokens differ from the first run")
    if not bool(torch.isfinite(ref["logits"]).all()):
        fail(f"{where}: the prefill's last logits are not finite")
    print(f"  (d) {arch} depth {cfg.n_layers}, bf16, B {B}, prompt {S}, "
          f"{NEW} new tokens on the (1, 1) mesh: prefill logits and all "
          f"{NEW} tokens bitwise the unsharded steps'; launches "
          f"{got['launches']} (flash by shape {got['flash_shapes']}), "
          f"no plain version; prefill + {NEW - 1} decode steps in turns "
          f"(host clock, synchronized): unsharded {ref['wall_s']:.3f}, "
          f"sharded {got['wall_s']:.3f}, unsharded "
          f"{runs['unsharded again']['wall_s']:.3f}, sharded "
          f"{runs['sharded again']['wall_s']:.3f} s; first tokens "
          f"{ref['tokens'][0, :8].tolist()}", flush=True)
    out = dict(launches=got["launches"], flash_shapes=got["flash_shapes"],
               bitwise=bitwise, layers=cfg.n_layers,
               walls_s={k: r["wall_s"] for k, r in runs.items()})
    del runs, params
    torch.cuda.empty_cache()
    return out


def serve_sharded_world1(dev, mesh) -> dict:
    start = time.perf_counter()
    out = {a: serve_sharded(a, d, dev, mesh)
           for a, d in SERVE_SHARDED.items()}
    print(f"  (d) {time.perf_counter() - start:.1f} s", flush=True)
    return out


def dryrun_train_4k(workdir: str) -> dict:
    """(c): the dry run's per-device bytes of qwen2-72B train_4k on the
    production meshes, on the host; then its costs at DRYRUN_DEPTH layers
    through ``python -m repro_torch.launch.dryrun`` (a fake process group
    of 256 and 512 ranks, in a process of its own) under each of
    DRYRUN_VARIANTS' rules: FLOPs (the same under each), collectives by
    kind, temporaries and peak."""
    from repro_torch.launch.dryrun import DEVICE_BYTES, build_cell
    out = {}
    for multi_pod in (False, True):
        c = build_cell(DIST_ARCH, "train_4k", multi_pod)
        m = c["memory"]
        if m["param_bytes"] != 728_530_944:
            fail(f"dry run: {m['param_bytes']} parameter bytes per device "
                 f"on {c['mesh']}, want 728530944")
        print(f"  (c) dry run {DIST_ARCH} train_4k on {c['mesh']} "
              f"({c['chips']} devices): per device parameters "
              f"{m['param_bytes']} B, AdamW state {m['opt_state_bytes']} "
              f"B, inputs {m['input_bytes']} B, grad_accum "
              f"{c['grad_accum']}: {m['state_bytes'] / 1e9:.3f} GB beside "
              f"an H100's {DEVICE_BYTES / 1e9:.0f} GB", flush=True)
        out["pod2" if multi_pod else "pod1"] = c
    start = time.perf_counter()
    dest = os.path.join(workdir, "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    costs = {}
    for variant in DRYRUN_VARIANTS:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DIST_ARCH, "--shape", "train_4k", "--both-meshes", "--out",
             dest, "--force", "--variant", variant, "--override",
             f"cfg_n_layers={DRYRUN_DEPTH}"],
            env=env, capture_output=True, text=True, timeout=300)
        if res.returncode != 0 or "FAIL" in res.stdout:
            fail(f"dry run costs ({variant}): rc {res.returncode}\n"
                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        for tag, multi_pod in (("pod1", False), ("pod2", True)):
            path = os.path.join(dest, f"{DIST_ARCH}.train_4k.{tag}."
                                      f"{variant}.json")
            with open(path) as f:
                c = json.load(f)
            coll, r, m = c["collectives"], c["roofline"], c["memory"]
            if not (c["flops_per_device"] > 0 and c["bytes_per_device"] > 0
                    and coll["total"] > 0 and c["counted_microbatches"] == 1
                    and m["temp_bytes"] > 0):
                fail(f"dry run costs {tag} {variant}: {c}")
            # the split changes no product
            check(f"dry run {tag} {variant} flops_per_device, relative",
                  abs(c["flops_per_device"] / DRYRUN_FLOPS - 1), DRYRUN_RTOL)
            was = costs.get(f"{tag}/baseline")
            beside = "" if was is None else (
                f" (baseline: {was['bytes_per_device']:.6e} B, collectives "
                + ", ".join(f"{k} {was['collectives'][k]:.6e}" for k in (
                    "all-reduce", "all-gather", "reduce-scatter"))
                + f", temporaries {was['memory']['temp_bytes']:.6e} B)")
            print(f"  (c) costs at {DRYRUN_DEPTH} of 80 layers on "
                  f"{c['mesh']}, {variant} rules: per device and step "
                  f"{c['flops_per_device']:.6e} FLOPs, "
                  f"{c['bytes_per_device']:.6e} B (unfused), collectives "
                  f"{coll['total']:.6e} B (all-reduce "
                  f"{coll['all-reduce']:.6e}, all-gather "
                  f"{coll['all-gather']:.6e}, reduce-scatter "
                  f"{coll['reduce-scatter']:.6e}); temporaries "
                  f"{m['temp_bytes']:.6e} B, peak {m['peak_bytes']:.6e} B"
                  f"{beside}; roofline compute {r['t_compute']:.4f} s, "
                  f"memory {r['t_memory']:.4f} s, collective "
                  f"{r['t_collective']:.4f} s: {r['dominant']}; counted in "
                  f"{c['count_s']:.1f} s", flush=True)
            costs[f"{tag}/{variant}"] = {k: c[k] for k in (
                "flops_per_device", "bytes_per_device", "collectives",
                "roofline", "memory", "count_s")}
    out["costs"] = costs
    print(f"  (c) costs subprocess {time.perf_counter() - start:.1f} s",
          flush=True)
    return out


def tp_share(model, mesh, gen):
    """The rank's blocks of ``model``'s parameters, drawn on ``gen``'s
    device (normal, 1/sqrt(fan in); norms and biases zero), as DTensors
    placed by their logical axes on ``mesh``: no full tensor is built."""
    from torch.distributed.tensor import DTensor
    from repro_torch.runtime import sharding
    shapes, axes = model.abstract_params()
    sizes = sharding.mesh_sizes(mesh)

    def leaf(ax, t):
        spec = sharding.spec_for(ax, t.shape, mesh)
        local = sharding.local_shape(spec, t.shape, sizes)
        if len(ax) == 1 or ax in (("heads", "head_dim"),
                                  ("kv_heads", "head_dim")):
            block = torch.zeros(local, dtype=t.dtype, device=gen.device)
        else:
            fan_in = (model.cfg.d_model if ax[0] == "vocab" else
                      t.shape[0] * t.shape[1] if ax[0] == "heads"
                      else t.shape[0])
            block = torch.randn(local, generator=gen, device=gen.device,
                                dtype=t.dtype) / float(np.sqrt(fan_in))
        return DTensor.from_local(block, mesh,
                                  sharding.placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return sharding.map_axes(leaf, axes, shapes)


def tp_cache(model, mesh, B: int, length: int, device="cuda"):
    """The rank's zero blocks of the decode cache as DTensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.runtime import sharding
    shapes, axes = model.cache_axes(B, length)
    sizes = sharding.mesh_sizes(mesh)

    def leaf(ax, t):
        spec = sharding.spec_for(ax, t.shape, mesh)
        block = torch.zeros(sharding.local_shape(spec, t.shape, sizes),
                            dtype=t.dtype, device=device)
        return DTensor.from_local(block, mesh,
                                  sharding.placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return sharding.map_axes(leaf, axes, shapes)


@contextlib.contextmanager
def local_logits():
    """The rank's vocabulary block of every step's last logits, before
    ``models.model._whole_vocab`` gathers them over ``model``: shape and
    finiteness."""
    from repro_torch.models import model as model_mod
    seen = []
    inner = model_mod._whole_vocab

    def whole_vocab(logits, params):
        seen.append((tuple(logits.shape), bool(torch.isfinite(logits).all())))
        return inner(logits, params)
    model_mod._whole_vocab = whole_vocab
    try:
        yield seen
    finally:
        model_mod._whole_vocab = inner


def tp_profile(fn) -> dict:
    """One call of ``fn`` under the profiler: host wall, device time, and
    the device time by kind — the flash kernel, GEMMs (cuBLAS's and
    CUTLASS's kernels) and the rest (elementwise, reductions, copies) —
    with the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {ev.key: ev.self_device_time_total / 1e3
               for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA")
               and ev.self_device_time_total > 0}
    kinds = collections.Counter()
    for name, ms in by_name.items():
        kinds["flash" if "flash_fwd_sm90" in name else
              "gemm" if any(k in name.lower() for k in (
                  "gemm", "nvjet", "cutlass", "xmma")) else "other"] += ms
    return dict(wall_ms=wall * 1e3, device_ms=sum(by_name.values()),
                by_kind=dict(kinds),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:5])


@contextlib.contextmanager
def own_blocks():
    """Under the fake process group, whose collectives return at once and
    write nothing, the collectives over ``model`` whose results other
    ranks would fill are given this rank's numbers, so the values stay
    finite, of the right scale, and the work the same: an all-gather
    (a sub-layer's entry, a packed leaf taken whole) takes every rank's
    block as this rank's, a reduce-scatter (a sub-layer's exit under a
    split residual stream, the RG-LRU gates) keeps this rank's partial
    block, and a statistic's sum (``TensorParallel.sum``: the norms over a
    split embedding, the Mamba-2 gated norm) counts this rank's partial
    once for every rank."""
    from repro_torch.runtime import sharding
    tp_cls = sharding.TensorParallel
    inner = sharding._model_gather, sharding._model_scatter_sum, tp_cls.sum

    def gather(x, dim, tp):
        return torch.cat([x.contiguous()] * tp.size, dim=dim)

    def scatter_sum(x, dim, tp):
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * n, n).contiguous()

    def total(self, x):
        return inner[2](self, x) * self.size
    sharding._model_gather, sharding._model_scatter_sum = gather, scatter_sum
    tp_cls.sum = total
    try:
        yield
    finally:
        sharding._model_gather, sharding._model_scatter_sum = inner[:2]
        tp_cls.sum = inner[2]


@contextlib.contextmanager
def first_kernel_calls():
    """Copies of the first model-path call's inputs and output of the SSD
    wrapper (``ops.ssd_scan``) and the fused RG-LRU layer
    (``ops.rglru_layer``), each of which launches its kernel."""
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.ssd_scan import ops as sops
    seen = {}
    inner = sops.ssd_scan, rops.rglru_layer

    def ssd(x, dt, A, Bm, Cm, *, chunk=256, h0=None):
        y, st = inner[0](x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        if "ssd" not in seen:
            seen["ssd"] = dict(args=[t.clone() for t in (x, dt, A, Bm, Cm)],
                               chunk=min(chunk, x.shape[1]),
                               out=(y.clone(), st.clone()))
        return y, st

    def layer(pre_r, pre_i, x, lam):
        y = inner[1](pre_r, pre_i, x, lam)
        if "rglru" not in seen:
            seen["rglru"] = dict(args=[t.clone() for t in (pre_r, pre_i, x,
                                                           lam)],
                                 out=y.clone())
        return y
    sops.ssd_scan, rops.rglru_layer = ssd, layer
    try:
        yield seen
    finally:
        sops.ssd_scan, rops.rglru_layer = inner


def tp_rank(cfg, mesh_shape, dev, where: str, new: int = TP_NEW,
            profile: bool = False, after=None) -> dict:
    """``cfg`` as rank 0 of a ``mesh_shape`` ("data", "model")
    tensor-parallel deployment over the fake process group
    (``launch.dryrun.fake_group``: its collectives return at once, and
    ``own_blocks`` fills the two whose results other ranks would write),
    through ``make_prefill_step`` / ``make_decode_step(mesh=)``: the
    rank's blocks drawn on the card (``tp_share``), a B TP_B x TP_S
    prefill (a second, warm one timed) and ``new`` decode steps; the
    launches, flash calls by shape and plain-version calls of both turns,
    the rank's logits blocks finite, and copies of the first flash, SSD
    and fused RG-LRU calls. With ``profile``, one prefill and one decode
    step under the profiler. ``after(model, mesh, params, toks)``, if
    given, runs last on the same share in the same process group; its
    result is the output's ``after``."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.serve_loop import _splice
    from repro_torch.runtime.train_loop import (make_decode_step,
                                                make_prefill_step)
    start = time.perf_counter()
    model = Model(cfg)
    ranks = mesh_shape[0] * mesh_shape[1]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (TP_B, TP_S)).astype(np.int32)).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fake_group(ranks), own_blocks():
        mesh = init_device_mesh("cuda", mesh_shape,
                                mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        params = tp_share(model, mesh, torch.Generator(device="cuda")
                          .manual_seed(0))
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        share = sum(t.to_local().numel() * t.to_local().element_size()
                    for t in tree_leaves(params))
        prefill = make_prefill_step(model, mesh)
        decode = make_decode_step(model, mesh)

        def locals_(tree):
            return [t.to_local() for t in tree_leaves(tree)
                    if t is not None]
        walls, steps = [], []
        with torch.inference_mode():
            for turn in range(2):
                cache = tp_cache(model, mesh, TP_B, TP_S + new + 1)
                reset_lm_launches()
                with plain_call_counter() as plain, \
                        flash_call_recorder() as shapes, \
                        first_flash_call() as first, \
                        first_kernel_calls() as seen, \
                        local_logits() as lg:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, built = prefill(params, dict(tokens=toks))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    _splice(locals_(cache), locals_(built))
                    del built
                    tok = torch.argmax(logits, dim=-1)[:, None]
                    for i in range(new if turn else 0):
                        t0 = time.perf_counter()
                        tok, _, cache = decode(params, cache, tok, TP_S + i)
                        torch.cuda.synchronize()
                        steps.append(time.perf_counter() - t0)
                launches = read_lm_launches()
                if turn == 0:
                    prefill_launches = launches
                    firsts = dict(seen, flash=dict(first))
                    del first, seen
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = {}
            if profile:
                prof = dict(prefill=tp_profile(
                    lambda: prefill(params, dict(tokens=toks))),
                            decode=tp_profile(lambda: decode(
                                params, cache, tok, TP_S + new)))
            del cache
            later = None if after is None else after(model, mesh, params,
                                                     toks)
            del params
    torch.cuda.empty_cache()
    vocab_rows = cfg.padded_vocab // mesh_shape[1]
    if len(lg) != 1 + new or any(
            sh != (TP_B, vocab_rows) or not ok for sh, ok in lg):
        fail(f"{where}: the rank's logits blocks {lg[:3]} ..., want "
             f"{1 + new} finite blocks of ({TP_B}, {vocab_rows})")
    if tuple(logits.shape) != (TP_B, cfg.padded_vocab):
        fail(f"{where}: gathered logits {tuple(logits.shape)}")
    if sum(plain.values()):
        fail(f"{where}: plain versions ran: {dict(plain)}")
    return dict(layers=cfg.n_layers, mesh=list(mesh_shape), share_bytes=share,
                draw_s=draw_s, prefill_ms=walls[1] * 1e3,
                first_prefill_ms=walls[0] * 1e3,
                tokens_per_s=TP_B * TP_S / walls[1],
                decode_ms=float(np.mean(steps[1:])) * 1e3 if new else None,
                first_decode_ms=steps[0] * 1e3 if new else None,
                peak_gib=peak, launches=launches,
                prefill_launches=prefill_launches, flash_shapes=dict(shapes),
                firsts=firsts, profile=prof, after=later,
                wall_s=time.perf_counter() - start)


def want_launches(flash: int = 0, ssd: int = 0, rglru: int = 0,
                  ssd_final: int = 0) -> dict:
    return dict(flash=dict(wgmma=flash, scalar=0),
                ssd=ssd_counts(wgmma=ssd, wgmma_final=ssd_final),
                rglru=dict(layer_fwd=rglru, layer_bwd=0, fwd=0, bwd=0))


def check_rank_launches(where: str, r: dict, want: dict, shapes: dict):
    """One prefill's launches (and the prefill and decode steps' together:
    decode launches no kernel) exactly ``want``, the flash calls by shape
    ``shapes``."""
    if r["prefill_launches"] != want or r["launches"] != want:
        fail(f"{where}: launches {r['prefill_launches']} (prefill) and "
             f"{r['launches']} (prefill and decode), want {want}")
    if r["flash_shapes"] != shapes:
        fail(f"{where}: flash launches by shape {r['flash_shapes']}, want "
             f"{shapes}")


def hold_first_flash(where: str, first: dict, want_q) -> tuple:
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    if tuple(first["q"].shape) != tuple(want_q):
        fail(f"{where}: flash q {tuple(first['q'].shape)}, want the rank's "
             f"heads {tuple(want_q)}")
    ref = flash_attention_ref(first["q"], first["k"], first["v"],
                              **first["kw"])
    return hold_flash(f"{where} first flash call", first["out"], ref,
                      torch.bfloat16)


def report_rank(where: str, cfg, r: dict, what: str) -> None:
    decode = ("" if r["decode_ms"] is None else
              f"; {TP_NEW} decode steps {r['decode_ms']:.2f} ms a step "
              f"(after the first, {r['first_decode_ms']:.1f} ms)")
    print(f"  {where} {cfg.name} ({cfg.n_layers} layers), bf16, as rank 0 "
          f"of {r['mesh'][0] * r['mesh'][1]} on a {tuple(r['mesh'])} (data, "
          f"model) mesh over the card (the fake process group's "
          f"collectives return at once and move nothing: one rank's "
          f"compute alone, its tokens no result); the rank's share "
          f"{r['share_bytes'] / 1e9:.2f} GB drawn on the card in "
          f"{r['draw_s']:.1f} s: B {TP_B} x {TP_S} prefill "
          f"{r['prefill_ms']:.1f} ms warm (first "
          f"{r['first_prefill_ms']:.1f} ms), {r['tokens_per_s']:.0f} "
          f"tokens/s{decode}; peak {r['peak_gib']:.2f} GiB; launches "
          f"{r['launches']}: {what}, no plain version; the rank's logits "
          f"blocks finite; {r['wall_s']:.1f} s", flush=True)
    for name, p in r["profile"].items():
        print(f"    {where} one profiled {name}: wall {p['wall_ms']:.1f} ms, "
              f"device {p['device_ms']:.1f} ms (busy "
              f"{p['device_ms'] / p['wall_ms'] * 100:.1f} %); by kind "
              + ", ".join(f"{k} {ms:.1f} ms" for k, ms in
                          sorted(p["by_kind"].items()))
              + "; top: " + "; ".join(f"{n[:50]} {ms:.2f}"
                                      for n, ms in p["top"]), flush=True)


def split_prefills(model, mesh, params, toks) -> dict:
    """(h): ``tp_rank``'s ``after`` for (e): under each of SPLIT_VARIANTS'
    rules, a prefill on the share ``params`` (two under ``seqpar``, the
    second warm) with its launches, flash calls by shape, plain-version
    calls, first flash call and the rank's logits blocks, its walls and
    the peak memory past the share; then one prefill profiled."""
    from repro_torch.launch.dryrun import VARIANTS
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import make_prefill_step
    out = {}
    for variant in SPLIT_VARIANTS:
        with sharding.rule_overrides(VARIANTS[variant].get("rules")):
            prefill = make_prefill_step(model, mesh)
            split = sharding.step_layout(mesh, TP_B, TP_S,
                                         model.cfg.d_model).split
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            walls, runs = [], []
            with torch.inference_mode():
                for _ in range(2 if variant == "seqpar" else 1):
                    reset_lm_launches()
                    with plain_call_counter() as plain, \
                            flash_call_recorder() as shapes, \
                            first_flash_call() as first, \
                            local_logits() as lg:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        logits, built = prefill(params, dict(tokens=toks))
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t0)
                    del built
                    runs.append(dict(launches=read_lm_launches(),
                                     flash_shapes=dict(shapes),
                                     plain=dict(plain), first=dict(first),
                                     logits=list(lg)))
                    del first
                peak = torch.cuda.max_memory_allocated()
                prof = tp_profile(lambda: prefill(params, dict(tokens=toks)))
        out[variant] = dict(split=split, walls_ms=[w * 1e3 for w in walls],
                            peak_gib=peak / 2 ** 30,
                            temp_gib=(peak - held) / 2 ** 30, runs=runs,
                            profile=prof)
    return out


def check_split_prefills(cfg, e: dict, want_q) -> dict:
    """(h)'s checks and report beside (e)'s prefill of the same run: each
    prefill's layout split as its rules say, exactly (e)'s 80 flash
    launches at its shape, no plain version, the rank's logits block
    finite, the first flash call within FLASH_ATOL of the plain version."""
    from repro_torch.runtime import sharding
    h = e.pop("after")
    want_split = dict(baseline=None, seqpar=sharding.SEQ,
                      act2d=sharding.EMBED)
    vocab_rows = cfg.padded_vocab // TP_MESH[1]
    ep = e["profile"]["prefill"]
    out = {}
    for variant, r in h.items():
        where = f"{TP_ARCH} (13h) {variant}"
        if r["split"] != want_split[variant]:
            fail(f"{where}: the residual stream is split at {r['split']}, "
                 f"want {want_split[variant]}")
        errs = []
        for run in r["runs"]:
            check_rank_launches(where, dict(prefill_launches=run["launches"],
                                            launches=run["launches"],
                                            flash_shapes=run["flash_shapes"]),
                                want_launches(flash=cfg.n_layers),
                                {("wgmma", 128, 128, True): cfg.n_layers})
            if sum(run["plain"].values()):
                fail(f"{where}: plain versions ran: {run['plain']}")
            if run["logits"] != [((TP_B, vocab_rows), True)]:
                fail(f"{where}: the rank's logits blocks {run['logits']}, "
                     f"want one finite ({TP_B}, {vocab_rows})")
            errs.append(hold_first_flash(where, run["first"], want_q))
        p = r["profile"]
        out[variant] = dict(
            split=r["split"], walls_ms=r["walls_ms"], peak_gib=r["peak_gib"],
            temp_gib=r["temp_gib"], flash_launches=cfg.n_layers,
            flash_max_abs_err=max(err for err, _ in errs),
            flash_rel_rms=max(rel for _, rel in errs),
            profile={k: p[k] for k in ("wall_ms", "device_ms", "by_kind",
                                       "top")})
        kinds = ", ".join(f"{k} {p['by_kind'].get(k, 0.0):.1f} ms (13e "
                          f"{ep['by_kind'].get(k, 0.0):.1f})"
                          for k in ("gemm", "flash", "other"))
        print(f"  (h) {TP_ARCH} as rank 0 of {TP_MESH} on (e)'s share, "
              f"{variant} rules (residual stream split at {r['split']}): "
              f"B {TP_B} x {TP_S} prefill "
              + ", ".join(f"{w:.1f}" for w in r["walls_ms"])
              + f" ms (13e warm {e['prefill_ms']:.1f} ms); profiled wall "
              f"{p['wall_ms']:.1f} ms (13e {ep['wall_ms']:.1f}), device "
              f"{p['device_ms']:.1f} ms (13e {ep['device_ms']:.1f}): "
              f"{kinds}; peak {r['peak_gib']:.2f} GiB, "
              f"{r['temp_gib']:.2f} GiB past the share; launches "
              f"{cfg.n_layers} flash_fwd_sm90<128, 128> at q "
              f"{list(want_q)}, no plain version; first flash call max |d| "
              f"{out[variant]['flash_max_abs_err']:.3e}, RMS(d) / "
              f"RMS(plain) {out[variant]['flash_rel_rms']:.3e}; the rank's "
              f"logits block finite; top: "
              + "; ".join(f"{n[:40]} {ms:.2f}" for n, ms in p["top"][:3]),
              flush=True)
    return out


def tp_qwen2_72b(dev) -> dict:
    """(e): qwen2-72B whole as one rank of an 8-way tensor-parallel
    deployment (``TP_MESH``): ``tp_rank``'s run, 80 wgmma flash launches
    at the rank's heads and no plain version, one prefill and one decode
    step profiled; then that flash call timed beside the plain version,
    SDPA and its bound; and (h), ``split_prefills`` on the same share."""
    from repro_torch.configs import get_config
    cfg = get_config(TP_ARCH)
    where = f"{TP_ARCH} (13e)"
    heads, kv = cfg.n_heads // TP_MESH[1], cfg.n_kv // TP_MESH[1]
    r = tp_rank(cfg, TP_MESH, dev, where, profile=True,
                after=split_prefills)
    want_q = (TP_B, TP_S, kv, heads // kv, cfg.head_dim_)
    err, rel = hold_first_flash(where, r.pop("firsts")["flash"], want_q)
    check_rank_launches(where, r, want_launches(flash=cfg.n_layers),
                        {("wgmma", 128, 128, True): cfg.n_layers})
    timing = model_flash_timing(f"{TP_ARCH} (13e) rank heads", heads, kv,
                                TP_S, TP_S, cfg.head_dim_, cfg.head_dim_,
                                True, 13)
    out = dict(r, flash_launches=cfg.n_layers, flash_shape=list(want_q),
               flash_max_abs_err=err, flash_rel_rms=rel, flash_timing=timing)
    report_rank("(e)", cfg, out, f"{cfg.n_layers} flash_fwd_sm90<128, 128> "
                f"a prefill at q {list(want_q)} (the rank's {heads} q heads "
                f"over {kv} kv head); the first flash call vs the plain "
                f"version max |d| {err:.3e}, RMS(d) / RMS(plain) {rel:.3e}")
    out["split"] = check_split_prefills(cfg, out, want_q)
    return out


def tp_deepseek_v2(dev) -> dict:
    """(f): DeepSeek-V2-236B whole as rank 0 of an 8-way deployment
    (``TP_MLA_MESH``): MLA at the rank's 16 heads, 20 of the 160 routed
    experts, 1/8 of the shared experts, the dense layer's MLP and the
    vocabulary; one ``flash_fwd_sm90<192, 128>`` launch a layer at [4,
    2048, 16, 192/128], no plain version; its first call held against the
    plain version, then timed beside the plain version, SDPA and its
    bound. Layers are cut only if the share does not fit the card."""
    from repro_torch.configs import get_config
    cfg = get_config(TP_MLA_ARCH)
    where = f"{TP_MLA_ARCH} (13f)"
    heads = cfg.n_heads // TP_MLA_MESH[1]
    r = tp_rank(cfg, TP_MLA_MESH, dev, where, profile=True)
    D, Dv = cfg.d_nope + cfg.d_rope, cfg.d_v
    want_q = (TP_B, TP_S, heads, 1, D)
    err, rel = hold_first_flash(where, r.pop("firsts")["flash"], want_q)
    check_rank_launches(where, r, want_launches(flash=cfg.n_layers),
                        {("wgmma", D, Dv, True): cfg.n_layers})
    timing = model_flash_timing(f"{TP_MLA_ARCH} (13f) rank heads", heads,
                                heads, TP_S, TP_S, D, Dv, True, 14)
    out = dict(r, flash_launches=cfg.n_layers, flash_shape=list(want_q),
               flash_max_abs_err=err, flash_rel_rms=rel, flash_timing=timing,
               experts=cfg.n_experts // TP_MLA_MESH[1])
    report_rank("(f)", cfg, out, f"{cfg.n_layers} flash_fwd_sm90<{D}, {Dv}> "
                f"a prefill at q {list(want_q)} (the rank's {heads} of "
                f"{cfg.n_heads} MLA heads; {out['experts']} of "
                f"{cfg.n_experts} routed experts); the first flash call vs "
                f"the plain version max |d| {err:.3e}, RMS(d) / RMS(plain) "
                f"{rel:.3e}")
    return out


def tp_mixers(dev) -> dict:
    """(g): mamba2-2.7B and recurrentgemma-2B at full width, cut in depth
    (``TP_MIXERS``), as rank 0 of 2 (``TP_MIXER_MESH``): the wgmma SSD at
    the rank's heads, ``rglru_layer_fwd`` at its channels and
    recurrentgemma's D 256 flash at its q heads over the replicated kv
    head, no plain version; each kernel's first call held against its
    plain version, then timed at that shape beside its bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.rglru_scan.ref import rglru_layer_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    ways = TP_MIXER_MESH[1]
    out = {}
    for arch, depth in TP_MIXERS.items():
        cfg = get_config(arch).replace(n_layers=depth)
        where = f"{arch} (13g)"
        r = tp_rank(cfg, TP_MIXER_MESH, dev, where)
        firsts = r.pop("firsts")
        if cfg.ssm:
            H = cfg.d_inner // cfg.ssm_head_dim // ways
            check_rank_launches(where, r, want_launches(ssd=depth), {})
            f = firsts["ssd"]
            x = f["args"][0]
            if tuple(x.shape) != (TP_B, TP_S, H, cfg.ssm_head_dim):
                fail(f"{where}: SSD x {tuple(x.shape)}, want the rank's "
                     f"{H} heads")
            raw, err = ssd_err(f["out"], ssd_ref(*f["args"],
                                                 chunk=f["chunk"]),
                               BF16_RTOL)
            check(f"{where} first SSD call vs plain", err, SSD_ATOL)
            timing = ssd_timing(ssd_inputs(TP_B, TP_S, H, cfg.ssm_head_dim,
                                           cfg.ssm_groups, cfg.ssm_state,
                                           torch.bfloat16, 15, True),
                                f["chunk"])
            out[arch] = dict(r, kernel="ssd_scan_sm90", shape=list(
                x.shape), max_abs_err=raw, err_beyond_rtol=err,
                timing=timing)
            what = (f"{depth} ssd_scan_sm90 calls a prefill at x "
                    f"{list(x.shape)}, N {cfg.ssm_state}; the first vs the "
                    f"plain version max |d(y, state)| {raw:.3e} (beyond "
                    f"rtol: {err:.3e})")
        else:
            W = cfg.lru_width // ways
            heads = cfg.n_heads // ways
            rec = n_recurrent(cfg)
            check_rank_launches(where, r, want_launches(
                flash=depth - rec, rglru=rec),
                {("wgmma", cfg.head_dim_, cfg.head_dim_, True): depth - rec})
            f = firsts["rglru"]
            if tuple(f["out"].shape) != (TP_B, TP_S, W):
                fail(f"{where}: RG-LRU y {tuple(f['out'].shape)}, want the "
                     f"rank's {W} channels")
            raw = (f["out"] - rglru_layer_ref(*f["args"])).abs().max().item()
            check(f"{where} first rglru_layer_fwd call vs plain", raw,
                  SCAN_ATOL)
            pre_r, pre_i, xs, lam, _ = layer_inputs(TP_B, TP_S, W, dev,
                                                    seed=16)
            n = pre_r.numel()
            timing = time_kernel(
                lambda: rk.rglru_layer_fwd_cuda(pre_r, pre_i, xs, lam),
                lambda: rglru_layer_ref(pre_r, pre_i, xs, lam),
                bound(4 * (4 * n + W), LAYER_FWD_OPS * n), plain_reps=1)
            report_timing(f"{where} rglru_layer_fwd", (TP_B, TP_S, W),
                          timing)
            want_q = (TP_B, TP_S, 1, heads, cfg.head_dim_)
            ferr, frel = hold_first_flash(where, firsts["flash"], want_q)
            flash = model_flash_timing(
                f"{arch} (13g) rank heads", heads, cfg.n_kv, TP_S, TP_S,
                cfg.head_dim_, cfg.head_dim_, True, 17)
            out[arch] = dict(r, kernel="rglru_layer_fwd",
                             shape=[TP_B, TP_S, W], max_abs_err=raw,
                             timing=timing, flash_shape=list(want_q),
                             flash_launches=depth - rec,
                             flash_max_abs_err=ferr, flash_rel_rms=frel,
                             flash_timing=flash)
            what = (f"{rec} rglru_layer_fwd a prefill at [{TP_B}, {TP_S}, "
                    f"{W}] (the first vs the plain version max |d| "
                    f"{raw:.3e}) and {depth - rec} flash_fwd_sm90<256, 256> "
                    f"at q {list(want_q)} (max |d| {ferr:.3e}, RMS(d) / "
                    f"RMS(plain) {frel:.3e})")
        report_rank("(g)", cfg, out[arch], what)
    return out


# (i) context parallelism: CP_ARCH at CP_DEPTH of 80 layers, bf16, a
# batch-1 prefill of CP_S positions (prefill_32k's sequence) as the last
# of CP_WAYS ``data`` segments (rank CP_WAYS - 1 of a (CP_WAYS, 1) fake
# process group): 4096 queries a layer at offset 28672 against the keys
# of their 32768-position prefix, through the wgmma kernel.
CP_ARCH, CP_DEPTH, CP_S, CP_WAYS = "qwen2_72b", 16, 32768, 8
# The flash kernels at a query offset against the plain version (offsets
# off the 128-row and 128-key tile grids, on it, sliding windows, MLA's
# dims, a call whose K and V outgrow L2 so that the wgmma kernel deals
# pairs of q tiles, and float32 on the scalar kernel): (label, B, Hq,
# Hkv, Sq, q_offset, D, Dv, window, dtype); Skv = q_offset + Sq.
FLASH_OFFSET_CASES = [
    ("D 128 off-grid", 2, 4, 2, 200, 333, 128, 128, 0, torch.bfloat16),
    ("D 64 on-grid", 1, 6, 3, 256, 128, 64, 64, 0, torch.bfloat16),
    ("D 256 sliding", 1, 4, 1, 150, 77, 256, 256, 100, torch.bfloat16),
    ("D 128 sliding far", 1, 2, 2, 256, 1000, 128, 128, 300,
     torch.bfloat16),
    ("MLA 96/64", 1, 4, 4, 130, 390, 96, 64, 0, torch.bfloat16),
    ("MLA 192/128", 1, 2, 2, 64, 1, 192, 128, 0, torch.bfloat16),
    ("D 128 pairs", 1, 8, 8, 2048, 14336, 128, 128, 0, torch.bfloat16),
    ("f32 D 64", 1, 4, 2, 100, 333, 64, 64, 0, torch.float32),
    ("f32 D 128 sliding", 1, 2, 1, 64, 70, 128, 128, 50, torch.float32),
    ("f32 D 256", 1, 2, 2, 70, 129, 256, 256, 0, torch.float32),
    ("bf16 D 16 scalar", 1, 2, 1, 33, 5, 16, 16, 0, torch.bfloat16)]
# The outputs the flash kernels gave at offset 0, before it existed: sha256
# of each FLASH_DIGEST_CASES output's bytes on its fixed inputs, from
# ``kernel_probe.py digest`` on the tree before the offset (NVIDIA H100
# 80GB HBM3, 700.00 W). The kernels hold no atomics and no order that
# depends on timing, so an output is a function of its inputs.
PARENT_FLASH_DIGESTS = {
    "wgmma 64 causal":
        "3032b3e5a7a3e0fbc4f3dd2dab9cf9c1cb1496944a94bd5b16b03c43b2a73cdc",
    "wgmma 128 causal":
        "34c030fe853389c13106a2f151b9fcc90a2e3f0768a55852a297379790d46624",
    "wgmma 128 window":
        "3ad5c439708b3a7fa1ff06109076b64c7e1571b206508f0aa8ba4d37f5899efa",
    "wgmma 256 causal":
        "efac54c775541aa0588512dfb76e56419c298c24b29c3e8f79d4a1a734cbf72a",
    "wgmma 96/64 causal":
        "9203c2346f73ec2ef2252707ca6d9629c19be4970a130e453271c46593cb527d",
    "wgmma 192/128 causal":
        "31e373ad4de723630a5c0610f5418a84eec249e6c71976d5d26ec1e67a3b9c41",
    "wgmma 64 full":
        "6c26f638c00460d05bca70b9867be61cc0ace62d7c1ccd71f52b5fecdd1033d2",
    "wgmma 128 pairs":
        "94007d37b3c1258589326e48cf78f7300f5d4af55c4096796437269740ed7022",
    "scalar f32 64 causal":
        "d71b03ff9be488e1f3d30ba219febb2eac3696513e819cfc7bab8f68d68bcd6e",
    "scalar f32 128 window":
        "9b2edf233665784f9739935e23ef54a5cf8122892f74bc250c5b8e1d9e94d23e",
    "scalar f32 256 full":
        "9a5960a5f1ae6df8d6f1290b6b1ea4ce520a09412b8869bc721ef757a41a4f29",
    "scalar bf16 16 causal":
        "d2b80140ec3313c002c5d3eb835e87399d1eb06866b90e163f468e4c6d32b208"}
# (label, kernel, B, Hq, Hkv, Sq, Skv, D, Dv, causal, window, dtype): the
# wgmma kernel on the model layout, the scalar one heads first.
FLASH_DIGEST_CASES = [
    ("wgmma 64 causal", "wgmma", 2, 4, 2, 300, 300, 64, 64, True, 0,
     torch.bfloat16),
    ("wgmma 128 causal", "wgmma", 1, 8, 1, 520, 520, 128, 128, True, 0,
     torch.bfloat16),
    ("wgmma 128 window", "wgmma", 1, 4, 2, 700, 700, 128, 128, True, 250,
     torch.bfloat16),
    ("wgmma 256 causal", "wgmma", 1, 4, 4, 333, 333, 256, 256, True, 0,
     torch.bfloat16),
    ("wgmma 96/64 causal", "wgmma", 1, 4, 4, 400, 400, 96, 64, True, 0,
     torch.bfloat16),
    ("wgmma 192/128 causal", "wgmma", 1, 2, 2, 300, 300, 192, 128, True, 0,
     torch.bfloat16),
    ("wgmma 64 full", "wgmma", 1, 4, 4, 200, 333, 64, 64, False, 0,
     torch.bfloat16),
    ("wgmma 128 pairs", "wgmma", 1, 8, 8, 4096, 4096, 128, 128, True, 0,
     torch.bfloat16),
    ("scalar f32 64 causal", "scalar", 1, 4, 2, 300, 300, 64, 64, True, 0,
     torch.float32),
    ("scalar f32 128 window", "scalar", 1, 2, 1, 200, 200, 128, 128, True,
     70, torch.float32),
    ("scalar f32 256 full", "scalar", 1, 2, 2, 100, 150, 256, 256, False, 0,
     torch.float32),
    ("scalar bf16 16 causal", "scalar", 1, 2, 1, 99, 99, 16, 16, True, 0,
     torch.bfloat16)]


def flash_digests() -> dict:
    """{label: sha256 of the output's bytes} of every FLASH_DIGEST_CASES
    call at offset 0 (no offset passed: the call an older tree takes too),
    on inputs drawn by numpy from fixed seeds."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    out = {}
    for i, (label, kind, B, Hq, Hkv, Sq, Skv, D, Dv, causal, window,
            dtype) in enumerate(FLASH_DIGEST_CASES):
        rng = np.random.default_rng(100 + i)

        def draw(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to("cuda").to(dtype)
        with torch.no_grad():
            if kind == "wgmma":
                o = fk.flash_attention_cuda(
                    draw(B, Sq, Hq, D), draw(B, Skv, Hkv, D),
                    draw(B, Skv, Hkv, Dv), causal=causal, window=window)
            else:
                o = fk._launch("scalar", draw(B * Hq, Sq, D),
                               draw(B * Hkv, Skv, D), draw(B * Hkv, Skv, D),
                               causal=causal, window=window, scale=None,
                               group=Hq // Hkv)
        torch.cuda.synchronize()
        out[label] = hashlib.sha256(o.contiguous().view(torch.uint8).cpu()
                                    .numpy().tobytes()).hexdigest()
    return out


def flash_offset_checks(dev) -> dict:
    """(i)'s kernel checks: every FLASH_OFFSET_CASES call through the
    model-layout wrapper (one launch of the kernel ``kernel_call`` names)
    against the plain version at the same offset within FLASH_ATOL and
    FLASH_RRMS; then the offset-0 outputs' digests against the parent's
    (PARENT_FLASH_DIGESTS): bitwise the kernels before the offset."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    worst = {}
    for i, (label, B, Hq, Hkv, Sq, off, D, Dv, window,
            dtype) in enumerate(FLASH_OFFSET_CASES):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        G, Skv = Hq // Hkv, off + Sq
        q = torch.randn((B, Sq, Hkv, G, D), generator=gen,
                        device=dev).to(dtype)
        k = torch.randn((B, Skv, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Skv, Hkv, Dv), generator=gen,
                        device=dev).to(dtype)
        scale = 1.0 / np.sqrt(D) if D != Dv else None
        call = fops.kernel_call(dtype, D, Dv)
        with torch.no_grad(), flash_call_recorder() as seen:
            out = fops.flash_attention(q, k, v, causal=True, window=window,
                                       scale=scale, q_offset=off)
        if dict(seen) != {(*call, True): 1}:
            fail(f"flash at offset {off} ({label}) launched {dict(seen)}, "
                 f"want one {call}")
        ref = flash_attention_ref(q, k, v, causal=True, window=window,
                                  scale=scale, q_offset=off)
        err, rel = hold_flash(f"flash at offset {off} ({label})", out, ref,
                              dtype)
        worst[label] = err
        print(f"  (i) flash {label}: {call[0]} kernel at {call[1]}/{call[2]},"
              f" B {B}, {Hq} over {Hkv} heads, {Sq} queries at offset {off}"
              f" against {Skv} keys, window {window}: max |d| {err:.3e}, "
              f"RMS(d) / RMS(plain) {rel:.3e}", flush=True)
    got = flash_digests()
    if not PARENT_FLASH_DIGESTS:
        fail("PARENT_FLASH_DIGESTS is empty")
    differ = {k: v for k, v in got.items() if PARENT_FLASH_DIGESTS.get(k)
              != v}
    if differ or set(got) != set(PARENT_FLASH_DIGESTS):
        fail(f"the flash kernels at offset 0 are not bitwise their outputs "
             f"before the offset: {sorted(differ)}")
    print(f"  (i) at offset 0 both flash kernels are bitwise their outputs "
          f"before the offset: {len(got)} digests equal "
          f"(PARENT_FLASH_DIGESTS)", flush=True)
    return dict(offset_max_abs_err=worst, digests_equal=len(got))


@contextlib.contextmanager
def own_segments():
    """Under the fake process group, whose collectives return at once and
    write nothing, the exchanges between sequence segments
    (``sharding._segment_gather`` and its backward's reduce-scatter) take
    this rank's block as every segment's, so the values stay finite, of
    the right scale, and the work the same."""
    from repro_torch.runtime import sharding
    inner = sharding._segment_gather, sharding._segment_scatter_sum

    def gather(x, dim, cp):
        return torch.cat([x.contiguous()] * cp.size, dim=dim)

    def scatter_sum(x, dim, cp):
        n = x.shape[dim] // cp.size
        return x.narrow(dim, cp.index * n, n).contiguous()
    sharding._segment_gather, sharding._segment_scatter_sum = (gather,
                                                               scatter_sum)
    try:
        yield
    finally:
        sharding._segment_gather, sharding._segment_scatter_sum = inner


def cp_qwen2_72b(dev) -> dict:
    """(i): the offset kernels (``flash_offset_checks``), then CP_ARCH at
    CP_DEPTH of 80 layers, full width, bf16, as the last of CP_WAYS
    ``data`` segments (rank CP_WAYS - 1 of a (CP_WAYS, 1) fake process
    group; ``own_segments`` fills the K/V all-gathers; the parameters
    whole on the rank, the rules' ``embed`` taken off ``data``): one
    batch-1 prefill of CP_S positions through ``make_prefill_step(mesh=)``
    (a second, warm one timed), CP_DEPTH wgmma flash launches at [1,
    CP_S / CP_WAYS, 8, 8, 128] against CP_S keys at offset CP_S (CP_WAYS
    - 1) / CP_WAYS and no plain version; the first call held against the
    plain version (``flash_attention_blocked``: the float32 scores of
    ``attention_ref`` at 64 heads would take 34 GB) and timed alone beside
    it, SDPA with the offset-causal boolean mask and the bound."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_blocked
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import make_prefill_step
    start = time.perf_counter()
    checks = flash_offset_checks(dev)
    cfg = get_config(CP_ARCH).replace(n_layers=CP_DEPTH)
    model = Model(cfg)
    seg = CP_S // CP_WAYS
    off = seg * (CP_WAYS - 1)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (1, CP_S)).astype(np.int32)).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fake_group(CP_WAYS, CP_WAYS - 1), own_segments(), \
            sharding.rule_overrides({"embed": ()}):
        mesh = init_device_mesh("cuda", (CP_WAYS, 1),
                                mesh_dim_names=("data", "model"))
        layout = sharding.step_layout(mesh, 1, CP_S, cfg.d_model)
        cp = layout.context()
        if layout.segment_axes != ("data",) or cp.index != CP_WAYS - 1:
            fail(f"{CP_ARCH} (13i): segments {layout.segment_axes}, this "
                 f"rank's {cp}, want the last of {CP_WAYS} over data")
        params = tp_share(model, mesh, torch.Generator(device="cuda")
                          .manual_seed(0))
        share = sum(t.to_local().numel() * t.to_local().element_size()
                    for t in tree_leaves(params))
        prefill = make_prefill_step(model, mesh)
        walls = []
        with torch.inference_mode():
            for turn in range(2):
                reset_lm_launches()
                with plain_call_counter() as plain, \
                        flash_call_recorder() as shapes, \
                        first_flash_call() as first:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, built = prefill(params, dict(tokens=toks))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                launches = read_lm_launches()
                del built
                if turn == 0:
                    firsts = dict(first)
                    del first
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del params
    torch.cuda.empty_cache()
    where = f"{CP_ARCH} (13i)"
    check_rank_launches(where, dict(prefill_launches=launches,
                                    launches=launches,
                                    flash_shapes=dict(shapes)),
                        want_launches(flash=CP_DEPTH),
                        {("wgmma", 128, 128, True): CP_DEPTH})
    if sum(plain.values()):
        fail(f"{where}: plain versions ran: {dict(plain)}")
    if tuple(logits.shape) != (1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{where}: last logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    G = cfg.n_heads // cfg.n_kv
    want_q = (1, seg, cfg.n_kv, G, cfg.head_dim_)
    q, k, v, kw = (firsts[n] for n in ("q", "k", "v", "kw"))
    if tuple(q.shape) != want_q or tuple(k.shape) != (
            1, CP_S, cfg.n_kv, cfg.head_dim_) or kw["q_offset"] != off:
        fail(f"{where}: first flash call q {tuple(q.shape)}, k "
             f"{tuple(k.shape)} at offset {kw['q_offset']}; want q {want_q} "
             f"against {CP_S} keys at offset {off}")
    plain_fn = lambda: flash_attention_blocked(q, k, v, **kw)
    with torch.no_grad():
        err, rel = hold_flash(f"{where} first flash call", firsts["out"],
                              plain_fn(), torch.bfloat16)
        kernel = lambda: fops.flash_attention(q, k, v, **kw)
        qp = torch.arange(seg, device=dev)[:, None] + off
        mask = torch.arange(CP_S, device=dev)[None, :] <= qp
        # heads first, the kv heads repeated for each of their q heads
        q4 = q.flatten(2, 3).transpose(1, 2)
        k4, v4 = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                  for t in (k, v))
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask)
        lib_err = (library().transpose(1, 2).reshape(firsts["out"].shape)
                   .float() - firsts["out"].float()).abs().max().item()
        visible = seg * off + seg * (seg + 1) // 2
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        timing = dict(ms=cuda_ms(kernel, warmup=3, reps=10),
                      device_ms=flash_kernel_device_ms(kernel, reps=3)[0],
                      plain_ms=cuda_ms(plain_fn, warmup=1, reps=2),
                      library_ms=cuda_ms(library, warmup=2, reps=5),
                      library=("SDPA, offset-causal boolean mask, kv "
                               "heads repeated"), library_err=lib_err,
                      **bound(nbytes, 4 * cfg.head_dim_ * cfg.n_heads
                              * visible, BF16_OPS_PER_S))
    del q, k, v, q4, k4, v4, mask, firsts
    torch.cuda.empty_cache()
    out = dict(checks, layers=CP_DEPTH, segments=CP_WAYS, segment=seg,
               q_offset=off, share_bytes=share,
               prefill_ms=walls[1] * 1e3, first_prefill_ms=walls[0] * 1e3,
               tokens_per_s=seg / walls[1], peak_gib=peak,
               launches=launches, flash_launches=CP_DEPTH,
               flash_shape=list(want_q), max_abs_err=err, rel_rms=rel,
               timing=timing, wall_s=time.perf_counter() - start)
    print(f"  (i) {CP_ARCH} ({CP_DEPTH} layers, bf16) as rank "
          f"{CP_WAYS - 1} of a ({CP_WAYS}, 1) (data, model) mesh over the "
          f"card, the last of {CP_WAYS} sequence segments (the fake process "
          f"group's collectives move nothing: the segments' K/V are this "
          f"rank's own); the parameters whole, "
          f"{share / 1e9:.2f} GB: a batch-1 prefill of {CP_S} positions, "
          f"the rank's {seg} at offset {off}: {walls[1] * 1e3:.1f} ms warm "
          f"(first {walls[0] * 1e3:.1f} ms), {seg / walls[1]:.0f} tokens/s "
          f"of the rank; peak {peak:.2f} GiB; launches {launches}: "
          f"{CP_DEPTH} flash_fwd_sm90<128, 128> at q {list(want_q)} against "
          f"{CP_S} keys, no plain version; the first vs the plain version "
          f"max |d| {err:.3e}, RMS(d) / RMS(plain) {rel:.3e}; "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    print(f"  (i) that call alone: {timing['ms']:.3f} ms (device "
          f"{timing['device_ms']}), plain (blocked, float32) "
          f"{timing['plain_ms']:.3f} ms, {timing['library']} "
          f"{timing['library_ms']:.3f} ms (max |d| to the kernel "
          f"{lib_err:.3e}); bound {timing['bound_ms']:.3f} ms "
          f"({timing['bound_by']}: {timing['nops']:.4e} FLOP at 989 "
          f"TFLOP/s)", flush=True)
    return out


# (j) context parallelism through the SSD: CPJ_ARCH at full depth and
# width, bf16, a batch-1 prefill of CP_S positions as the last of CP_WAYS
# ``data`` segments, as (i) runs qwen2-72B: 4096 positions a layer (16
# chunks of 256) from the state the earlier segments hand on.
CPJ_ARCH = "mamba2_2_7b"


@contextlib.contextmanager
def first_state_call():
    """Copies of the first SSD kernel call from a state (``h0``) on the
    model path: its inputs, h0, chunk and (y, state)."""
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    seen, inner = {}, sk.ssd_scan_cuda

    def scan(x, dt, A, Bm, Cm, *, chunk=256, h0=None):
        out = inner(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        if h0 is not None and "args" not in seen:
            seen.update(args=[t.clone() for t in (x, dt, A, Bm, Cm)],
                        h0=h0.clone(), chunk=min(chunk, x.shape[1]),
                        out=[t.clone() for t in out])
        return out
    sk.ssd_scan_cuda = scan
    try:
        yield seen
    finally:
        sk.ssd_scan_cuda = inner


def cp_mamba2(dev, cfg=None, S: int = CP_S, ways: int = CP_WAYS) -> dict:
    """(j): ``cfg`` (CPJ_ARCH's, all 64 layers, bf16) as the last of
    ``ways`` ``data`` segments (rank ways - 1 of a (ways, 1) fake process
    group; the parameters whole on the rank): one batch-1 prefill of
    ``S`` positions through ``make_prefill_step(mesh=)`` (a second, warm
    one timed). Each layer's SSD makes one launch of the final-state-
    from-zero entry (``ssd_final_cuda``, 2 device launches) and one of the
    wgmma scan from the carried state (``h0``): n_layers of each, no plain
    version. On the fake group the segments' gathered finals are this
    rank's own (``own_segments``), so h0 here is a state of the right
    scale, not the sequence's: the carried values are proved by the CPU
    gloo tests (``tests/test_torch_context_parallel.py``) and by phase 6's
    split-versus-whole check, not by this run. The first call from h0 is
    held against the plain version with the same ``init_state``."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import make_prefill_step
    start = time.perf_counter()
    cfg = cfg or get_config(CPJ_ARCH)
    model = Model(cfg)
    seg = S // ways
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, S)).astype(np.int32)).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    where = f"{cfg.name} (13j)"
    with fake_group(ways, ways - 1), own_segments(), \
            sharding.rule_overrides({"embed": ()}):
        mesh = init_device_mesh(dev.type, (ways, 1),
                                mesh_dim_names=("data", "model"))
        layout = sharding.step_layout(mesh, 1, S, cfg.d_model)
        cp = layout.context()
        if layout.segment_axes != ("data",) or cp.index != ways - 1:
            fail(f"{where}: segments {layout.segment_axes}, this rank's "
                 f"{cp}, want the last of {ways} over data")
        params = tp_share(model, mesh, torch.Generator(device=dev)
                          .manual_seed(0))
        prefill = make_prefill_step(model, mesh)
        walls = []
        with torch.inference_mode():
            for turn in range(2):
                reset_lm_launches()
                with plain_call_counter() as plain, \
                        first_state_call() as first:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, built = prefill(params, dict(tokens=toks))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                launches = read_lm_launches()
                from_state = dict(sk.LAUNCHES_FROM_STATE)
                del built
                if turn == 0:
                    firsts = dict(first)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del params
    torch.cuda.empty_cache()
    n = cfg.n_layers
    check_rank_launches(where, dict(prefill_launches=launches,
                                    launches=launches, flash_shapes={}),
                        want_launches(ssd=n, ssd_final=n), {})
    if from_state != dict(wgmma=n, scalar=0):
        fail(f"{where}: SSD calls from a state {from_state}, want {n} "
             f"wgmma")
    if sum(plain.values()):
        fail(f"{where}: plain versions ran: {dict(plain)}")
    if tuple(logits.shape) != (1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{where}: last logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    H = cfg.d_inner // cfg.ssm_head_dim
    x = firsts["args"][0]
    if tuple(x.shape) != (1, seg, H, cfg.ssm_head_dim):
        fail(f"{where}: first SSD call from a state at x "
             f"{tuple(x.shape)}, want the segment's (1, {seg}, {H}, "
             f"{cfg.ssm_head_dim})")
    with torch.no_grad():
        raw, err = ssd_err(firsts["out"], ssd_ref(
            *firsts["args"], chunk=firsts["chunk"],
            init_state=firsts["h0"]), BF16_RTOL)
    check(f"{where} first SSD call from h0 vs plain", err, SSD_ATOL)
    h0_max = firsts["h0"].abs().max().item()
    del firsts
    out = dict(layers=n, segments=ways, segment=seg, q_offset=seg * (
        ways - 1), prefill_ms=walls[1] * 1e3, first_prefill_ms=walls[0] * 1e3,
        tokens_per_s=seg / walls[1], peak_gib=peak, launches=launches,
        from_state=from_state, shape=list(x.shape), max_abs_err=raw,
        err_beyond_rtol=err, h0_max_abs=h0_max,
        wall_s=time.perf_counter() - start)
    print(f"  (j) {cfg.name} ({n} layers, bf16) as rank {ways - 1} of a "
          f"({ways}, 1) (data, model) mesh, the last of {ways} sequence "
          f"segments (the fake process group's exchanges move nothing: the "
          f"segments' finals are this rank's own, max |h0| {h0_max:.3e}): "
          f"a batch-1 prefill of {S} positions, the rank's {seg}: "
          f"{walls[1] * 1e3:.1f} ms warm (first {walls[0] * 1e3:.1f} ms), "
          f"{seg / walls[1]:.0f} tokens/s of the rank; peak {peak:.2f} GiB; "
          f"launches {launches}, from a state {from_state}: {n} "
          f"ssd_final_cuda (wgmma_final) and {n} wgmma scans from h0 at x "
          f"{list(x.shape)}, no plain version; the first from h0 vs the "
          f"plain version max |d(y, state)| {raw:.3e} (beyond rtol "
          f"{err:.3e}); {time.perf_counter() - start:.1f} s", flush=True)
    return out


def phase_distribution(dev, workdir: str) -> dict:
    print(f"== phase 13: distribution — (a) {DIST_ARCH} at full width, "
          f"{DIST_DEPTH} of 80 layers, bf16, served (B 4, prompt 2048, 32 "
          f"new tokens), (b) the sharded train step on a one-rank NCCL "
          f"mesh ({SHARDED_ARCH} depth {SHARDED_DEPTH}, float32), (d) the "
          f"sharded prefill and decode steps on it ("
          + ", ".join(f"{a} depth {d or 'full'}"
                      for a, d in SERVE_SHARDED.items())
          + f", bf16), (e) {TP_ARCH} whole as one rank of {TP_MESH} "
          f"tensor-parallel, (f) {TP_MLA_ARCH} whole as one rank of "
          f"{TP_MLA_MESH}, (g) "
          + ", ".join(f"{a} depth {d}" for a, d in TP_MIXERS.items())
          + f" at full width as one rank of {TP_MIXER_MESH}, (h) (e)'s "
          f"prefill with the residual stream split over model (seqpar, "
          f"act2d), (i) the flash kernels at a query offset, and "
          f"{CP_ARCH} at {CP_DEPTH} layers as the last of {CP_WAYS} "
          f"sequence segments of a {CP_S}-position prefill (context "
          f"parallelism), (j) {CPJ_ARCH} at full depth the same way, its "
          f"SSD from the carried state, (c) the dry run of {DIST_ARCH} "
          f"train_4k (baseline, seqpar)", flush=True)
    serve = serve_qwen2_72b()
    with one_rank_mesh(workdir) as mesh:
        sharded = sharded_world1(dev, workdir, mesh)
        served = serve_sharded_world1(dev, mesh)
    return dict(serve=serve, sharded=sharded, served=served,
                tp=tp_qwen2_72b(dev), mla=tp_deepseek_v2(dev),
                mixers=tp_mixers(dev), cp=cp_qwen2_72b(dev),
                cp_ssd=cp_mamba2(dev), dryrun=dryrun_train_4k(workdir))


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device available")
    from repro_torch.kernels import _build
    from repro_torch.kernels.sinkhorn import sinkhorn
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
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
               "flash_attention_sm90", "ssd_scan", "ssd_scan_sm90"]
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
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        k = timed("phase 1", phase_kernel, dev)
        timed("phase 2", phase_round, dev)
        e2e = timed("phase 3", phase_e2e, dev,
                    os.path.join(workdir, "phase3.trace.jsonl"))
        scan = timed("phase 4", phase_scan, dev)
        fc = timed("phase 5", phase_forecast, *e2e["cell"])
        lmk = timed("phase 6", phase_lm_kernels, dev)
        parity = timed("phase 7", phase_lm_parity, dev)
        serve = timed("phase 8", phase_lm_serve, dev)
        cmp9 = timed("phase 9", phase_comparison, e2e, fc)
        b10 = timed("phase 10", phase_batched, e2e, cmp9)
        srv = timed("phase 11", phase_serve, *e2e["cell"])
        train = timed("phase 12", phase_lm_train, dev)
        dist13 = timed("phase 13", phase_distribution, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    reactive9 = cmp9["launches"]["waterwise[backend=fused]"]["_launches"]
    learned9 = cmp9["launches"][COMPARISON[-1]]["_launches"]
    a = k["anneal_timings"][(512, 6)]    # the bucket of phase 3's rounds
    kernels = [dict(
        name="sinkhorn_anneal", route="cuda",
        source="src/repro_torch/csrc/sinkhorn.cu",
        replaces="src/repro/kernels/sinkhorn/sinkhorn.py:83",
        launches=e2e["launches"],
        launches_forecast_round=fc["launches"]["sinkhorn"],
        launches_phase9=dict(reactive=reactive9["sinkhorn"],
                             learned=learned9["sinkhorn"]),
        max_abs_err=k["anneal_max_abs_err"], ms=a["ms"],
        plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        device_ms=a["device_ms"], bound_by=a["bound_by"], library_ms=None,
        shape=[512, 6], iteration_loop_ms=a["loop_ms"], launches_per_call=1,
        main_path="every fused solve of phases 3, 5 and 9",
        forecast_shape=dict(shape=[512, 40],
                            **k["anneal_timings"][(512, 40)]))]
    t = b10["timing"]
    kernels.append(dict(
        name="sinkhorn_anneal_batched", route="cuda",
        source="src/repro_torch/csrc/sinkhorn.cu",
        replaces="src/repro/kernels/sinkhorn/sinkhorn.py:83",
        launches=b10["launches"], max_abs_err=b10["max_abs_err"],
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        device_ms=t["device_ms"], bound_by=t["bound_by"], library_ms=None,
        shape=[8, 512, 6], single_launches_ms=t["singles_ms"],
        launches_per_call="1, or ceil(B / cells that fit) when the cells "
                          "cannot all be co-resident",
        split_at_16384=dict(cells=20, fit=b10["fit"], launches=b10["split"]),
        main_path="the device executor's seed sweep of phase 10(b)"))
    t = k["adaptive_timings"][(True, 512, 40)]

    def adaptive_fields(key):
        return {f: k["adaptive_timings"][key][f] for f in (
            "used", "ms", "device_ms", "fixed_ms", "fixed_device_ms",
            "plain_ms", "bound_ms", "bound_by")}
    kernels.append(dict(
        name="sinkhorn_anneal_adaptive", route="cuda",
        source="src/repro_torch/csrc/sinkhorn.cu",
        replaces="src/repro/kernels/sinkhorn/sinkhorn.py:83",
        launches=srv["launches"], launches_storm=srv["storm_launches"],
        max_abs_err=k["adaptive_max_abs_err"], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        device_ms=t["device_ms"], bound_by=t["bound_by"], library_ms=None,
        shape=[512, 40], warm=True, iterations=t["used"],
        fixed_schedule_ms=t["fixed_ms"], launches_per_call=1,
        mean_iterations=dict(cold=srv["cold"], warm=srv["warm"]),
        cold_512_40=adaptive_fields((False, 512, 40)),
        warm_2048_40=adaptive_fields((True, 2048, 40)),
        main_path="every warm-started fused round of phase 11(a), one a "
                  "round; (b)'s storm too"))
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
    keep = ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
            "bound_by", "composition_ms", "composition_device_ms")
    for name, entry, replaces, path in (
            ("rglru_layer_fwd", "layer_fwd",
             "src/repro/kernels/rglru_scan/rglru_scan.py:49",
             "every learned-forecaster forward of phase 5; every "
             "recurrent layer of recurrentgemma_2b's prefill, bf16 (phase "
             "8), at griffin_shape"),
            ("rglru_layer_bwd", "layer_bwd",
             "src/repro/kernels/rglru_scan/ops.py:40",
             "every learned-forecaster training step of phase 5"),
            ("rglru_scan_fwd", "fwd",
             "src/repro/kernels/rglru_scan/rglru_scan.py:49",
             "none: the forecaster takes the fused layer; the scan-only "
             "wrapper ops.rglru_scan"),
            ("rglru_scan_bwd", "bwd",
             "src/repro/kernels/rglru_scan/ops.py:40",
             "none: the scan-only wrapper's backward")):
        t = scan["timings"][(entry, (64, 48, 16))]
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/rglru_scan.cu", replaces=replaces,
            launches=fc["launches"][entry],
            launches_phase9=learned9[entry],
            max_abs_err=scan["worst"][entry], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            device_ms=t["device_ms"], plain_device_ms=t["plain_device_ms"],
            bound_by=t["bound_by"], library_ms=None, shape=[64, 48, 16],
            launches_per_call=1, main_path=path,
            griffin_shape=dict(shape=list(GRIFFIN), **{
                k: v for k, v in scan["timings"][(entry, GRIFFIN)].items()
                if k in keep}))
        if (entry, (16, 48, 16)) in scan["timings"]:
            row["infer_shape"] = dict(shape=[16, 48, 16], **{
                k: v for k, v in scan["timings"][(entry, (16, 48, 16))]
                .items() if k in keep})
        if "composition_ms" in t:
            row.update(composition_ms=t["composition_ms"],
                       composition_device_ms=t["composition_device_ms"])
        if entry == "layer_bwd":
            row.update(clamp_max_rel_err=scan["clamp_rel"])
        if entry == "layer_fwd":
            row["train_step"] = fc["step"]
            row["launches_phase8"] = serve["recurrentgemma_2b"][
                "launches"]["rglru_layer_fwd"]
            r13 = dist13["mixers"]["recurrentgemma_2b"]
            row["launches_phase13g"] = r13["launches"]["rglru"]["layer_fwd"]
            row["max_abs_err"] = max(row["max_abs_err"], r13["max_abs_err"])
            row["rank_channels"] = dict(shape=r13["shape"], **{
                k: v for k, v in r13["timing"].items() if k in keep})
        kernels.append(row)
    f128, f64 = lmk["flash"][128], lmk["flash"][64]
    flash = "src/repro/kernels/flash_attention/flash_attention.py:104"

    def wgmma_by_model(dims):
        """Phase 8's wgmma flash launches at (D_qk, D_v) in ``dims``, by
        model."""
        counts = {a: sum(n for (kind, D, Dv, _), n in serve[a][
            "flash_shapes"].items() if kind == "wgmma" and (D, Dv) in dims)
            for a in ARCHS}
        return {a: n for a, n in counts.items() if n}

    def model_shapes(dims):
        return {name: {f: t[f] for f in (
            "shape", "kernel_dims", "ms", "device_ms", "call_device_ms",
            "plain_ms", "library", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "max_abs_err", "rel_rms")}
            for name, t in lmk["model_flash"].items()
            if tuple(t["kernel_dims"]) in dims}
    by_model = wgmma_by_model(((64, 64), (128, 128)))
    by_model[f"{DIST_ARCH} (phase 13)"] = dist13["serve"]["launches"][
        "flash_wgmma"]
    tp13 = dist13["tp"]
    by_model[f"{TP_ARCH} (13e, rank heads)"] = tp13["flash_launches"]
    for variant, h in tp13["split"].items():
        by_model[f"{TP_ARCH} (13h, {variant})"] = h["flash_launches"] * len(
            h["walls_ms"])
    tp_keys = ("ms", "device_ms", "plain_ms", "library", "library_ms",
               "library_device_ms", "bound_ms", "bound_by", "max_abs_err",
               "rel_rms")
    tp_flash = {f: tp13["flash_timing"][f] for f in tp_keys}
    kernels.append(dict(
        name="flash_attention_sm90", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces=flash, launches=sum(by_model.values()),
        launches_by_model=by_model,
        max_abs_err=max([lmk["worst"]["flash_sm90"],
                         dist13["serve"]["flash_max_abs_err"],
                         tp13["flash_max_abs_err"]]
                        + [h["flash_max_abs_err"]
                           for h in tp13["split"].values()]), ms=f128["ms"],
        plain_ms=f128["plain_ms"], bound_ms=f128["bound_ms"],
        device_ms=f128["device_ms"], plain_device_ms=f128["plain_device_ms"],
        bound_by=f128["bound_by"], library_ms=f128["library_ms"],
        shape=[48, 2048, 128], dtype="bfloat16", launches_per_call=1,
        main_path="Server.generate, bf16 (phases 8 and 13): one call a "
                  "prefill attention of qwen2_1_5b, dbrx_132b, "
                  "llama_3_2_vision_11b (self and cross), "
                  "seamless_m4t_large_v2 (D 64: encoder, self, cross) and "
                  "qwen2_72b (group 8; phase 13(e) on one tensor-parallel "
                  "rank's 8 q heads over its kv head, and 13(h) with the "
                  "residual stream split over model by sequence or "
                  "embedding), reading the model layout in place",
        qwen2_72b=dict(shape=dist13["serve"]["flash_shape"],
                       max_abs_err=dist13["serve"]["flash_max_abs_err"],
                       rel_rms=dist13["serve"]["flash_rel_rms"]),
        qwen2_72b_rank_heads=dict(shape=tp13["flash_shape"],
                                  launches=tp13["flash_launches"],
                                  **tp_flash),
        qwen2_72b_split={v: {k: h[k] for k in (
            "split", "flash_launches", "flash_max_abs_err", "walls_ms",
            "peak_gib")} for v, h in tp13["split"].items()},
        d64=dict(shape=[48, 2048, 64], **{
            key: f64[key] for key in ("ms", "device_ms", "plain_ms",
                                      "library_ms", "bound_ms",
                                      "max_abs_err")}),
        model_shapes=model_shapes(((64, 64), (128, 128)))))
    gemma = lmk["gemma_flash"]
    local = gemma["gemma3_4b local"]
    flash_keep = ("shape", "group", "window", "ms", "device_ms",
                  "scalar_ms", "scalar_device_ms", "plain_ms",
                  "plain_device_ms", "library", "library_ms",
                  "library_device_ms", "bound_ms", "bound_by", "max_abs_err",
                  "scalar_err")
    by_model = wgmma_by_model(((256, 256),))
    rg13 = dist13["mixers"]["recurrentgemma_2b"]
    by_model["recurrentgemma_2b (13g, rank heads)"] = rg13["flash_launches"]
    kernels.append(dict(
        name="flash_attention_sm90_d256", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces=flash, launches=sum(by_model.values()),
        launches_by_model=by_model,
        max_abs_err=max([t["max_abs_err"] for t in gemma.values()]
                        + [rg13["flash_max_abs_err"]]),
        ms=local["ms"], plain_ms=local["plain_ms"],
        bound_ms=local["bound_ms"], device_ms=local["device_ms"],
        bound_by=local["bound_by"], library_ms=local["library_ms"],
        library=local["library"], shape=local["shape"], dtype="bfloat16",
        group=local["group"], window=local["window"], launches_per_call=1,
        scalar_same_inputs_ms=local["scalar_ms"],
        main_path="gemma3_4b and recurrentgemma_2b Server.generate, bf16 "
                  "(phase 8): one call an attention layer's prefill",
        gemma_shapes={name: {f: t[f] for f in flash_keep}
                      for name, t in gemma.items()},
        recurrentgemma_rank_heads=dict(
            shape=rg13["flash_shape"], launches=rg13["flash_launches"],
            **{f: rg13["flash_timing"][f] for f in tp_keys})))
    mla_dims = ((96, 64), (192, 128))
    by_model = wgmma_by_model(mla_dims)
    mla13 = dist13["mla"]
    by_model[f"{TP_MLA_ARCH} (13f, rank heads)"] = mla13["flash_launches"]
    mla = model_shapes(mla_dims)
    mini = lmk["model_flash"]["minicpm3_4b mla"]
    kernels.append(dict(
        name="flash_attention_sm90_mla", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces=flash, launches=sum(by_model.values()),
        launches_by_model=by_model,
        max_abs_err=max([t["max_abs_err"] for t in mla.values()]
                        + [mla13["flash_max_abs_err"]]),
        ms=mini["ms"], plain_ms=mini["plain_ms"], bound_ms=mini["bound_ms"],
        device_ms=mini["device_ms"], bound_by=mini["bound_by"],
        library_ms=mini["library_ms"], library=mini["library"],
        shape=mini["shape"], dtype="bfloat16", launches_per_call=1,
        instantiations=["flash_fwd_sm90<96, 64>", "flash_fwd_sm90<192, 128>"],
        mutants={name: lmk["model_flash"][name]["mutants"] for name in mla},
        main_path="minicpm3_4b (96, 64) and deepseek_v2_236b (192, 128) "
                  "Server.generate, bf16 (phase 8): one call an MLA layer's "
                  "prefill, unpadded, reading the model layout in place; "
                  "deepseek_v2_236b whole on one tensor-parallel rank's 16 "
                  "heads (phase 13(f))",
        deepseek_v2_rank_heads=dict(
            shape=mla13["flash_shape"], launches=mla13["flash_launches"],
            **{f: mla13["flash_timing"][f] for f in tp_keys}),
        model_shapes=mla))
    cp13 = dist13["cp"]
    t = cp13["timing"]
    kernels.append(dict(
        name="flash_attention_sm90_offset", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces=flash, launches=cp13["launches"]["flash"]["wgmma"],
        max_abs_err=max([cp13["max_abs_err"]]
                        + list(cp13["offset_max_abs_err"].values())),
        ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], library=t["library"],
        shape=cp13["flash_shape"], keys=CP_S, q_offset=cp13["q_offset"],
        dtype="bfloat16", launches_per_call=1,
        offset_zero_bitwise_digests=cp13["digests_equal"],
        main_path=f"make_prefill_step(mesh=) of {CP_ARCH} at {CP_DEPTH} "
                  f"layers, a batch-1 prefill of {CP_S} positions as the "
                  f"last of {CP_WAYS} sequence segments over data (phase "
                  f"13(i)): one call a layer at offset {cp13['q_offset']}",
        offset_cases=cp13["offset_max_abs_err"]))
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu", replaces=flash,
        launches=sum(parity[a]["flash"]["scalar"] for a in ARCHS),
        launches_by_model={a: parity[a]["flash"]["scalar"] for a in ARCHS},
        max_abs_err=lmk["worst"]["flash"], ms=f128["scalar_ms"],
        device_ms=f128["scalar_device_ms"], plain_ms=f128["plain32_ms"],
        bound_ms=f128["scalar_bound"]["bound_ms"],
        bound_by=f128["scalar_bound"]["bound_by"],
        library_ms=f128["library32_ms"],
        library_device_ms=f128["library32_device_ms"],
        library="SDPA causal (enable_gqa), float32",
        shape=[48, 2048, 128], dtype="float32", group=6,
        launches_per_call=1,
        main_path="Server.generate in float32 (phase 7): one call a "
                  "prefill attention, heads first (MLA's padded to D 128 or "
                  "256)",
        gemma_bf16_was={name: {f: t[f] for f in (
            "shape", "scalar_ms", "scalar_device_ms", "scalar_err")}
            for name, t in gemma.items()}))
    t, t1 = lmk["ssd"][4], lmk["ssd"][1]
    ssd = "src/repro/kernels/ssd_scan/ssd_scan.py:93"
    m13 = dist13["mixers"]["mamba2_2_7b"]
    j13 = dist13["cp_ssd"]
    h0 = lmk["ssd_h0"]

    def from_state(kind):
        """The phase-6 timing of the ``kind`` kernel from h0 beside the
        same call from zero, and the plain version from h0."""
        r = h0["timing"][kind]
        return dict(shape=[4, 2048, 80, 64], ms=r["h0_ms"],
                    device_ms=r["h0_device_ms"], zero_ms=r["zero_ms"],
                    zero_device_ms=r["zero_device_ms"],
                    plain_ms=r["plain_ms"],
                    plain_device_ms=r["plain_device_ms"],
                    launch_device_us=r.get("h0_launch_device_us"),
                    **r["h0_bound"])
    kernels.append(dict(
        name="ssd_scan_sm90", route="cuda",
        source="src/repro_torch/csrc/ssd_scan_sm90.cu", replaces=ssd,
        launches=serve["mamba2_2_7b"]["launches"]["ssd_wgmma"],
        launches_phase13g=m13["launches"]["ssd"]["wgmma"],
        launches_phase13j_from_state=j13["from_state"]["wgmma"],
        from_state=from_state("wgmma"),
        split_vs_whole=h0["split"], no_h0_bitwise_digests=h0[
            "digests_equal"],
        max_abs_err=max(lmk["worst"]["ssd_sm90"], m13["max_abs_err"],
                        j13["max_abs_err"]),
        ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        device_ms=t["device_ms"], plain_device_ms=t["plain_device_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        shape=[4, 2048, 80, 64], dtype="bfloat16",
        launches_per_call=sk.KERNELS_PER_CALL["wgmma"],
        launch_device_us=t["launch_device_us"],
        scalar_same_inputs_ms=t["scalar_ms"],
        main_path="mamba2_2_7b Server.generate, bf16 (phase 8)",
        b1=dict(shape=[1, 2048, 80, 64], **{
            key: t1[key] for key in ("ms", "device_ms", "launch_device_us",
                                     "scalar_ms", "plain_ms", "bound_ms")}),
        rank_heads=dict(shape=m13["shape"], **{
            key: m13["timing"][key] for key in (
                "ms", "device_ms", "launch_device_us", "plain_ms",
                "bound_ms", "bound_by")})))
    kernels.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu", replaces=ssd,
        launches=parity["mamba2_2_7b"]["ssd"]["scalar"],
        max_abs_err=lmk["worst"]["ssd"], ms=t["scalar32_ms"],
        plain_ms=t["plain32_ms"],
        bound_ms=t["scalar32_bound"]["bound_ms"],
        device_ms=t["scalar32_device_ms"],
        bound_by=t["scalar32_bound"]["bound_by"], library_ms=None,
        shape=[4, 2048, 80, 64], dtype="float32",
        launches_per_call=sk.KERNELS_PER_CALL["scalar"],
        bf16_inputs_ms=t["scalar_ms"], from_state=from_state("scalar"),
        main_path="mamba2_2_7b Server.generate, float32 at depth 2 "
                  "(phase 7)"))
    for kind, source, dtype, path, n in (
            ("wgmma", "ssd_scan_sm90.cu", "bfloat16",
             f"make_prefill_step(mesh=) of {CPJ_ARCH} at all "
             f"{j13['layers']} layers, a batch-1 prefill of {CP_S} "
             f"positions as the last of {CP_WAYS} sequence segments over "
             f"data (phase 13(j)): one call a layer, before the scan from "
             f"the carried state", j13["launches"]["ssd"]["wgmma_final"]),
            ("scalar", "ssd_scan.cu", "float32",
             "none: a float32 context-parallel segment's SSD (the CPU "
             "tests' path on the card)",
             j13["launches"]["ssd"]["scalar_final"])):
        r = h0["timing"][kind]
        kernels.append(dict(
            name=f"ssd_scan{'_sm90' if kind == 'wgmma' else ''}_final",
            route="cuda", source=f"src/repro_torch/csrc/{source}",
            replaces=ssd, launches=n,
            max_abs_err=max(c["final_max_abs_err"] for c in h0[
                "cases"].values() if c["kind"] == kind),
            ms=r["final_ms"], device_ms=r["final_device_ms"],
            plain_ms=r["plain_final_ms"],
            plain_device_ms=r["plain_final_device_ms"],
            bound_ms=r["final_bound"]["bound_ms"],
            bound_by=r["final_bound"]["bound_by"], library_ms=None,
            shape=[4, 2048, 80, 64], dtype=dtype,
            launches_per_call=sk.KERNELS_PER_CALL[f"{kind}_final"],
            launch_device_us=r.get("final_launch_device_us"),
            entry="ssd_final_cuda: the final state from zero in float32, "
                  "no y", main_path=path))
    # Each kernel's launches on phase 12's training runs: (a)'s and (c)'s
    # one step each, (b)'s last step.
    runs = {f"{a} (a)": r for a, r in train["parity"].items()}
    runs[f"{TRAIN_ARCH} (b), a step"] = train["slice"]
    runs.update({f"{a} (c)": r for a, r in train["paths"].items()})

    def flash_pick(kind, dims=None):
        return lambda r: sum(
            n for (k, D, Dv, _), n in r["flash_shapes"].items()
            if k == kind and (dims is None or (D, Dv) in dims))

    def launch_pick(group, entry):
        return lambda r: r["launches"][group][entry]
    picks = dict(
        flash_attention_sm90=flash_pick("wgmma", ((64, 64), (128, 128))),
        flash_attention_sm90_d256=flash_pick("wgmma", ((256, 256),)),
        flash_attention_sm90_mla=flash_pick("wgmma", mla_dims),
        flash_attention=flash_pick("scalar"),
        ssd_scan_sm90=launch_pick("ssd", "wgmma"),
        ssd_scan=launch_pick("ssd", "scalar"),
        ssd_scan_sm90_final=launch_pick("ssd", "wgmma_final"),
        ssd_scan_final=launch_pick("ssd", "scalar_final"),
        rglru_layer_fwd=launch_pick("rglru", "layer_fwd"),
        rglru_layer_bwd=launch_pick("rglru", "layer_bwd"),
        rglru_scan_fwd=launch_pick("rglru", "fwd"),
        rglru_scan_bwd=launch_pick("rglru", "bwd"))
    runs[f"{SHARDED_ARCH} (13b), the sharded step"] = dist13["sharded"]
    for row in kernels:
        pick = picks.get(row["name"])
        row["launches_train"] = {} if pick is None else {
            name: pick(r) for name, r in runs.items() if pick(r)}
        # Each kernel's launches in phase 13(d)'s sharded serving runs.
        row["launches_phase13d"] = {} if pick is None else {
            name: pick(r) for name, r in dist13["served"].items()
            if pick(r)}
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
