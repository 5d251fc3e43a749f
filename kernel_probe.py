"""Quick probes of the port's redesigned kernels on one CUDA card (an H100).

A short companion of ``chip_smoke.py`` for kernel work, run from the
repository root on the machine with the card:

    python3 kernel_probe.py ptxas     # registers and spills per kernel
    python3 kernel_probe.py sinkhorn  # annealed launch vs iteration loop
    python3 kernel_probe.py flash     # wgmma flash kernel vs plain, SDPA
    python3 kernel_probe.py ssd       # wgmma SSD kernel vs scalar and plain
    python3 kernel_probe.py ab OTHER.cu
        # the built flash_attention_sm90.cu against OTHER.cu (another
        # version of it, e.g. ``git show REV:src/repro_torch/csrc/
        # flash_attention_sm90.cu``) on the same inputs, timed in turns

Times are CUDA events over back-to-back calls; every stage prints the
card's name first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))


def cuda_ms(fn, warmup: int = 5, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ptxas() -> None:
    from repro_torch.kernels import _build
    for name in ("flash_attention_sm90", "sinkhorn", "ssd_scan_sm90"):
        out = _build.BUILD_DIR / f"probe-{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-o", str(out),
                            str(_build.CSRC / f"{name}.cu")],
                           capture_output=True, text=True)
        print(f"{name}: nvcc rc {r.returncode}")
        print("\n".join(line for line in r.stderr.splitlines()
                        if "Used" in line or "spill" in line
                        or "C75" in line or "error" in line))


def sinkhorn() -> None:
    from repro_torch.kernels.sinkhorn import ops
    from repro_torch.kernels.sinkhorn import sinkhorn as sk
    table = ops.eps_table(0.5, 0.005, 6)
    for M, N in ((512, 6), (512, 41), (4096, 6), (16384, 6), (16384, 41)):
        rng = np.random.default_rng(M + N)
        C = torch.from_numpy(rng.random((M, N)).astype(np.float32)).cuda()
        log_a = torch.full((M,), -float(np.log(M)), device="cuda")
        b = rng.random(N) + 0.5
        log_b = torch.from_numpy(
            np.log(b / b.sum()).astype(np.float32)).cuda()

        def launch():
            return sk.sinkhorn_solve_cuda(C, log_a, log_b, table, 60)

        def loop():
            f = torch.zeros(M, device="cuda")
            g = torch.zeros(N, device="cuda")
            for eps in table:
                for _ in range(60):
                    f, g = sk.sinkhorn_iteration_cuda(C, g, log_a, log_b,
                                                      eps)
            return f, g
        (f1, g1), (f2, g2) = launch(), loop()
        same = torch.equal(f1, f2) and torch.equal(g1, g2)
        print(f"anneal ({M}, {N}): bitwise equal to the loop {same}; "
              f"{cuda_ms(launch, 2, 10):.4f} ms a solve, loop "
              f"{cuda_ms(loop, 1, 3):.4f} ms", flush=True)


def flash_inputs(D: int, seed: int = 5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((48, 2048, D), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((8, 2048, D), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    return q, k, v


def flash() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    for D in (128, 64):
        q, k, v = flash_inputs(D)
        kernel = lambda: fb.flash_attention_bh_cuda(q, k, v, causal=True,
                                                    group=6)
        q4, k4, v4 = (x.view(4, -1, 2048, D) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)
        err = (kernel().float() - flash_attention_bh_ref(
            q, k, v, causal=True, group=6).float()).abs().max().item()
        print(f"[48, 2048, {D}] causal group 6: wgmma "
              f"{cuda_ms(kernel, 5, 50) * 1e3:.1f} us (max|d| vs plain "
              f"{err:.3e}), SDPA {cuda_ms(sdpa, 5, 50) * 1e3:.1f} us",
              flush=True)


def ssd() -> None:
    """The wgmma SSD kernel against the plain chunked version (chip_smoke's
    limit) at the card tests' and phase 6's shapes, then timed against the
    scalar kernel on the same bf16 inputs at mamba2-2.7B's prefill shape,
    B 4 and B 1."""
    from chip_smoke import (BF16_RTOL, SSD_ATOL, device_us_by_kernel,
                            ssd_inputs)
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    bf16 = torch.bfloat16
    ok = True
    for i, (b, S, H, P, G, N, L, like) in enumerate([
            (1, 600, 8, 64, 1, 128, 256, False),
            (1, 600, 8, 64, 2, 128, 64, False),
            (2, 300, 8, 64, 2, 64, 128, False),
            (1, 2048, 80, 64, 1, 128, 256, True),
            (4, 2048, 80, 64, 1, 128, 256, True)]):
        args = ssd_inputs(b, S, H, P, G, N, bf16, 60 + i, like)
        y, st = sk.ssd_scan_cuda(*args, chunk=L)
        torch.cuda.synchronize()
        yr, sr = ssd_ref(*args, chunk=min(L, S))
        err = max(((y.float() - yr.float()).abs()
                   - BF16_RTOL * yr.float().abs()).max().item(),
                  ((st.float() - sr.float()).abs()
                   - BF16_RTOL * sr.float().abs()).max().item())
        ok &= bool(err <= SSD_ATOL)
        print(f"ssd ({b}, {S}, {H}, {P}) G {G} N {N} L {L}"
              f"{' model-like' if like else ''}: wgmma max|d| beyond "
              f"2^-7 |ref|: {err:.3e} (limit {SSD_ATOL}); max|y| "
              f"{yr.float().abs().max().item():.3e}", flush=True)
    for b in (4, 1):
        args = ssd_inputs(b, 2048, 80, 64, 1, 128, bf16, 70 + b, True)
        wgmma = lambda: sk.ssd_scan_cuda(*args, chunk=256)
        scalar = lambda: sk._launch("scalar", *args, 256)
        t = [cuda_ms(f, 3, 20) * 1e3 for f in (wgmma, scalar, scalar,
                                               wgmma)]
        print(f"ssd ({b}, 2048, 80, 64) N 128 L 256 bf16: us (wgmma, "
              f"scalar, scalar, wgmma) {[round(x, 2) for x in t]}; the "
              f"wgmma call's launches (profiled device us): "
              f"{device_us_by_kernel(wgmma)}", flush=True)
    if not ok:
        sys.exit("ssd: the wgmma kernel is beyond the limit")


def ab_ssd(lib) -> None:
    """The built ssd_scan_sm90.cu against another version of it, at
    mamba2-2.7B's prefill shape, B 4 and B 1."""
    from chip_smoke import device_us_by_kernel, ssd_inputs
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd_sm90.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    for b in (4, 1):
        x, dt, A, Bm, Cm = args = ssd_inputs(b, 2048, 80, 64, 1, 128,
                                             torch.bfloat16, 80 + b, True)
        y, st = torch.empty_like(x), torch.empty((b, 80, 64, 128),
                                                 dtype=x.dtype, device="cuda")
        sc = torch.empty((b, 8, 80, 64, 128), device="cuda")
        decay = torch.empty((b, 8, 80), device="cuda")
        hin = torch.empty((b, 8, 80, 2, 64, 128), dtype=x.dtype,
                          device="cuda")

        def theirs():
            err = lib.ssd_scan_fwd_sm90(
                *(t.data_ptr() for t in (x, dt, A, Bm, Cm, y, st, sc, decay,
                                         hin)), b, 2048, 80, 1, 128, 256,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return y, st
        ours = lambda: sk.ssd_scan_cuda(*args, chunk=256)
        (y1, s1), (y2, s2) = ours(), [t.clone() for t in theirs()]
        same = max((y1.float() - y2.float()).abs().max().item(),
                   (s1.float() - s2.float()).abs().max().item())
        t = [cuda_ms(f, 3, 20) * 1e3 for f in (theirs, ours, ours, theirs)]
        print(f"ssd B {b}: us (other, built, built, other) "
              f"{[round(v, 2) for v in t]}; max|d| between them "
              f"{same:.3e}; other's launches (profiled device us): "
              f"{device_us_by_kernel(theirs)}", flush=True)


def ab(other: str) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fb
    out = _build.BUILD_DIR / "probe-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    other], check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "ssd_scan_fwd_sm90"):
        return ab_ssd(lib)
    lib.flash_attention_fwd_sm90.argtypes = ([ptr] * 4 + [i32] * 7
                                             + [ctypes.c_float, ptr])
    for D in (128, 64):
        q, k, v = flash_inputs(D)
        o = torch.empty_like(q)
        scale = float(np.float32(1 / np.sqrt(D)))

        def theirs():
            err = lib.flash_attention_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 48,
                2048, 2048, D, 6, 1, 0, scale,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return o
        ours = lambda: fb.flash_attention_bh_cuda(q, k, v, causal=True,
                                                  group=6)
        same = (ours().float() - theirs().float()).abs().max().item()
        t = [cuda_ms(f, 5, 50) * 1e3 for f in (theirs, ours, ours, theirs)]
        print(f"D {D}: us (other, built, built, other) "
              f"{[round(x, 2) for x in t]}; max|d| between them "
              f"{same:.3e}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    stage = sys.argv[1] if len(sys.argv) > 1 else "flash"
    stages = dict(ptxas=ptxas, sinkhorn=sinkhorn, flash=flash, ssd=ssd)
    if stage == "ab" and len(sys.argv) == 3:
        ab(sys.argv[2])
    elif stage in stages:
        stages[stage]()
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
