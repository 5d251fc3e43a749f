"""Quick probes of the port's redesigned kernels on one CUDA card (an H100).

A short companion of ``chip_smoke.py`` for kernel work, run from the
repository root on the machine with the card:

    python3 kernel_probe.py ptxas [NAME ...]
        # registers and spills per kernel (of csrc/NAME.cu; default all
        # the redesigned sources)
    python3 kernel_probe.py sinkhorn  # annealed launch vs iteration loop
    python3 kernel_probe.py flash     # wgmma flash kernel vs plain, SDPA
    python3 kernel_probe.py flash256  # its D 256 instantiation: small
                                      # shapes by column chunk, then the
                                      # gemma shapes beside the scalar one
    python3 kernel_probe.py mla       # its MLA instantiations (96/64,
                                      # 192/128): small shapes by column
                                      # chunk, strided views, then the
                                      # minicpm3 / DeepSeek-V2 prefill calls
    python3 kernel_probe.py ssd       # wgmma SSD kernel vs scalar and plain
    python3 kernel_probe.py ssdh0     # wgmma SSD scan from h0 vs from
                                      # zero vs the final-from-zero entry,
                                      # in turns over nine rounds
    python3 kernel_probe.py cpj       # chip_smoke.py's 13(j) prefill: the
                                      # SSD calls' share by CUDA events,
                                      # then device time by kernel family
    python3 kernel_probe.py rglru     # fused and scan-only RG-LRU vs plain
    python3 kernel_probe.py alloc     # host time of the fused backward's
                                      # output allocations, two ways
    python3 kernel_probe.py steps [SRC]
        # kernels per learned-forecaster training step, of the port under
        # SRC (default: this checkout's src), e.g. an older tree's
    python3 kernel_probe.py digest [SRC]
        # sha256 of the flash kernels' outputs at offset 0 and of the SSD
        # kernels' with no initial state on fixed inputs
        # (chip_smoke.FLASH_DIGEST_CASES, SSD_DIGEST_CASES), of the port
        # under SRC (default: this checkout's src), e.g. the tree before
        # the offset's or before h0, whose digests are
        # chip_smoke.PARENT_FLASH_DIGESTS and PARENT_SSD_DIGESTS
    python3 kernel_probe.py tp13 [ROOT ...]
        # chip_smoke.py's phase 13(e) (and (h), where ROOT's script has
        # it) through each ROOT's chip_smoke.py in turn, each in a process
        # of its own (default: this checkout), e.g. ``.archive/parent .
        # . .archive/parent`` with the parent tree unpacked there
    python3 kernel_probe.py ab OTHER.cu
        # the built flash_attention_sm90.cu, ssd_scan_sm90.cu or
        # rglru_scan.cu (by OTHER.cu's entry points) against OTHER.cu
        # (another version of it, e.g. ``git show REV:src/repro_torch/
        # csrc/rglru_scan.cu``) on the same inputs, timed in turns; a
        # flash source with the older [BH, S, D] entry is fed heads-first
        # copies of the model-layout inputs the built kernel reads

Times are CUDA events over back-to-back calls; every stage prints the
card's name first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

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


def ptxas(*names) -> None:
    from repro_torch.kernels import _build
    for name in names or ("flash_attention_sm90", "sinkhorn",
                          "ssd_scan_sm90", "rglru_scan"):
        out = _build.BUILD_DIR / f"probe-{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-o", str(out),
                            str(_build.CSRC / f"{name}.cu")],
                           capture_output=True, text=True)
        print(f"{name}: nvcc rc {r.returncode}")
        print("\n".join(line for line in r.stderr.splitlines()
                        if "Used" in line or "spill" in line
                        or "Compiling entry" in line or "C75" in line
                        or "error" in line))


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
    flash256()


# The gemma prefills' D 256 calls (B 4, S 2048): (label, BHq, group,
# window), as chip_smoke.GEMMA_FLASH.
GEMMA_FLASH = (("gemma3_4b local", 32, 2, 1024),
               ("gemma3_4b global", 32, 2, 1 << 30),
               ("recurrentgemma_2b", 40, 10, 2048))


def flash256() -> None:
    """The wgmma kernel at D 256: small shapes first, with the error of
    each 64-column chunk of the output (a misread V chunk shows as one
    chunk off), then the gemma shapes, timed beside the scalar kernel on
    the same inputs and SDPA."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bh_ref
    for BH, S, causal, window, group in ((2, 64, False, 0, 1),
                                         (4, 200, True, 0, 2),
                                         (10, 1000, True, 300, 10)):
        gen = torch.Generator(device="cuda").manual_seed(S)
        q = torch.randn((BH, S, 256), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((BH // group, S, 256), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        args = dict(causal=causal, window=window, group=group)
        d = (fb.flash_attention_bh_cuda(q, k, v, **args).float()
             - flash_attention_bh_ref(q, k, v, **args).float()).abs()
        torch.cuda.synchronize()
        by_chunk = d.view(BH, S, 4, 64).amax((0, 1, 3)).tolist()
        print(f"D 256 BH {BH} S {S} causal {causal} window {window} group "
              f"{group}: max|d| by 64-column chunk "
              f"{[f'{x:.2e}' for x in by_chunk]}", flush=True)
    for label, BHq, group, window in GEMMA_FLASH:
        gen = torch.Generator(device="cuda").manual_seed(BHq + group)
        q = torch.randn((BHq, 2048, 256), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((BHq // group, 2048, 256), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        args = dict(causal=True, window=window, group=group)
        kernel = lambda: fb.flash_attention_bh_cuda(q, k, v, **args)
        scalar = lambda: fb._launch("scalar", q, k, v, scale=None, **args)
        ref = flash_attention_bh_ref(q, k, v, **args).float()
        err = (kernel().float() - ref).abs().max().item()
        serr = (scalar().float() - ref).abs().max().item()
        print(f"{label} [{BHq}, 2048, 256] group {group} window {window}: "
              f"wgmma {cuda_ms(kernel, 3, 20) * 1e3:.2f} us (max|d| "
              f"{err:.3e}), scalar {cuda_ms(scalar, 1, 3) * 1e3:.2f} us "
              f"(max|d| {serr:.3e})", flush=True)


# MLA's prefill calls at B 4, S 2048, causal: (label, heads, D_qk, D_v).
MLA_FLASH = (("minicpm3_4b", 40, 96, 64), ("deepseek_v2_236b", 128, 192, 128))


def mla() -> None:
    """The wgmma kernel's MLA instantiations on the model layout: small
    shapes with the error of each 64-column chunk of the output (GQA,
    ragged, non-causal, windowed), strided views against their contiguous
    copies (bitwise), then the two prefill calls, timed beside SDPA on the
    same views and the function's bound."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    for B, S, Hq, Hkv, D, Dv, causal, window in (
            (2, 300, 4, 4, 96, 64, True, 0), (1, 1000, 4, 2, 96, 64, True, 300),
            (2, 130, 2, 2, 96, 64, False, 0), (1, 1000, 4, 4, 192, 128, True, 0),
            (2, 200, 4, 2, 192, 128, False, 0),
            (1, 1000, 2, 2, 192, 128, True, 300)):
        gen = torch.Generator(device="cuda").manual_seed(S + D)
        q = torch.randn((B, S, Hq, D), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, S, Hkv, Dv), generator=gen,
                        device="cuda").bfloat16()
        scale = 1.0 / np.sqrt(D)
        args = dict(causal=causal, window=window, scale=scale)
        out = fb.flash_attention_cuda(q, k, v, **args)
        ref = flash_attention_ref(q.view(B, S, Hkv, Hq // Hkv, D), k, v,
                                  **args).reshape(B, S, Hq, Dv)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        by_chunk = d.view(-1, Dv // 64, 64).amax((0, 2)).tolist()
        print(f"MLA {D}/{Dv} B {B} S {S} {Hq} over {Hkv} causal {causal} "
              f"window {window}: max|d| by 64-column chunk "
              f"{[f'{x:.2e}' for x in by_chunk]}", flush=True)
        wide = torch.randn((B, S, 2 * Hq, D + 64), generator=gen,
                           device="cuda").bfloat16()
        qs = wide[:, :, ::2, 32:32 + D]            # strided: no copy
        same = torch.equal(fb.flash_attention_cuda(qs, k, v, **args),
                           fb.flash_attention_cuda(qs.contiguous(), k, v,
                                                   **args))
        print(f"  a strided q view {tuple(qs.stride())} equals its "
              f"contiguous copy bitwise: {same}", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, H, D, Dv in MLA_FLASH:
        gen = torch.Generator(device="cuda").manual_seed(H)
        q, k = (torch.randn((4, 2048, H, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        v = torch.randn((4, 2048, H, Dv), generator=gen,
                        device="cuda").bfloat16()
        scale = 1.0 / np.sqrt(D)
        kernel = lambda: fb.flash_attention_cuda(q, k, v, causal=True,
                                                 scale=scale)
        library = lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), is_causal=True,
                               scale=float(scale))
        err = (kernel().float() - library().transpose(1, 2).float()).abs()
        flops = 2 * 4 * H * 2048 * 2049 // 2 * (D + Dv)
        t = [cuda_ms(f, 5, 30) * 1e3 for f in (kernel, library, library,
                                               kernel)]
        print(f"{label} MLA [4, 2048, {H}, {D}/{Dv}] causal: us (kernel, "
              f"SDPA, SDPA, kernel) {[round(x, 2) for x in t]}; max|d| vs "
              f"SDPA {err.max().item():.3e}; bound "
              f"{flops / 989e12 * 1e6:.2f} us ({flops / 1e9:.2f} GFLOP)",
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


def ssdh0(rounds: int = 9) -> None:
    """The wgmma SSD scan from an initial state h0 beside the same call
    from zero and the final-from-zero entry (``ssd_final_cuda``) at
    mamba2-2.7B's widths, bf16: B 4 at 2048 positions (phase 6's shape)
    and B 1 at 4096 (13(j)'s segment). The three are timed in turns,
    ``rounds`` rounds of 50 calls each by CUDA events, the order reversed
    every other round; prints each round's times and the medians."""
    from chip_smoke import ssd_inputs, ssd_state_of
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    bf16 = torch.bfloat16
    for b, S in ((4, 2048), (1, 4096)):
        args = ssd_inputs(b, S, 80, 64, 1, 128, bf16, 80 + b, True)
        h0 = ssd_state_of(b, S, 80, 64, 1, 128, 256, bf16, 90 + b)
        calls = dict(
            h0=lambda: sk.ssd_scan_cuda(*args, chunk=256, h0=h0),
            zero=lambda: sk.ssd_scan_cuda(*args, chunk=256),
            final=lambda: sk.ssd_final_cuda(*args, chunk=256))
        t = {k: [] for k in calls}
        for r in range(rounds):
            for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                t[k].append(cuda_ms(calls[k], 5, 50) * 1e3)
        ratio = [a / z for a, z in zip(t["h0"], t["zero"])]
        med = {k: float(np.median(v)) for k, v in t.items()}
        print(f"ssd ({b}, {S}, 80, 64) N 128 L 256 bf16, {rounds} rounds "
              f"of 50 calls, us: from h0 {[round(x, 2) for x in t['h0']]}"
              f"; from zero {[round(x, 2) for x in t['zero']]}; final from "
              f"zero {[round(x, 2) for x in t['final']]}; medians h0 "
              f"{med['h0']:.2f}, zero {med['zero']:.2f}, final "
              f"{med['final']:.2f}; h0 / zero by round min "
              f"{min(ratio):.4f} median {float(np.median(ratio)):.4f} max "
              f"{max(ratio):.4f}", flush=True)


def cpj() -> None:
    """chip_smoke.py's 13(j) prefill (mamba2-2.7B, all 64 layers, bf16,
    batch 1, the last of 8 ``data`` segments of 32768 positions, on a
    fake process group), two warm calls, then: one call with a CUDA event
    pair around each SSD call (the scan from h0 and the final-from-zero
    entry), the SSD's share of the wall; one call under the profiler,
    device time by kernel family and the ten largest kernels."""
    import re
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import CP_S, CP_WAYS, CPJ_ARCH, own_segments, tp_share
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.models.model import Model
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import make_prefill_step
    dev = torch.device("cuda")
    cfg = get_config(CPJ_ARCH)
    model = Model(cfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, CP_S)).astype(np.int32)).to(dev)
    events = {"scan": [], "final": []}
    inner = dict(scan=sk.ssd_scan_cuda, final=sk.ssd_final_cuda)

    def timed(kind):
        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner[kind](*a, **k)
            e1.record()
            events[kind].append((e0, e1))
            return out
        return call
    with fake_group(CP_WAYS, CP_WAYS - 1), own_segments(), \
            sharding.rule_overrides({"embed": ()}), torch.inference_mode():
        mesh = init_device_mesh("cuda", (CP_WAYS, 1),
                                mesh_dim_names=("data", "model"))
        params = tp_share(model, mesh, torch.Generator(device=dev)
                          .manual_seed(0))
        prefill = make_prefill_step(model, mesh)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, dict(tokens=toks))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        walls = [run() for _ in range(3)]
        sk.ssd_scan_cuda, sk.ssd_final_cuda = timed("scan"), timed("final")
        try:
            wall = run()
        finally:
            sk.ssd_scan_cuda, sk.ssd_final_cuda = inner["scan"], \
                inner["final"]
        ssd = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in events.items()}
        print(f"13(j) {cfg.name} ({cfg.n_layers} layers, bf16), the last of "
              f"{CP_WAYS} segments of {CP_S}: warm walls ms "
              f"{[round(w, 1) for w in walls]}; timed call {wall:.1f} ms, "
              f"of which the SSD's calls (events around each) "
              f"{sum(ssd.values()):.2f} ms = "
              f"{100 * sum(ssd.values()) / wall:.1f} % (scans from h0 "
              f"{ssd['scan']:.2f} ms in {len(events['scan'])} calls, finals "
              f"from zero {ssd['final']:.2f} ms in {len(events['final'])})",
              flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = run()
    fam = {}
    rows = []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us <= 0:
            continue
        name = ev.key
        kind = ("ssd" if re.search(r"ssd_", name) else
                "gemm" if re.search(r"gemm|cutlass|xmma|nvjet|gemv|sm90_",
                                    name) else
                "copy" if re.search(r"[Cc]opy|cat|Memcpy|Memset", name)
                else "elementwise/reduce/other")
        fam[kind] = fam.get(kind, 0.0) + us / 1e3
        rows.append((us / 1e3, ev.count, name[:90]))
    total = sum(fam.values())
    print(f"13(j) profiled call: wall {wall:.1f} ms, device time "
          f"{total:.2f} ms (idle {100 * (1 - total / wall):.1f} %); by "
          f"family ms " + ", ".join(f"{k} {v:.2f} ({100 * v / total:.1f} %)"
                                    for k, v in sorted(fam.items(),
                                                       key=lambda i: -i[1])),
          flush=True)
    for ms, n, name in sorted(rows, reverse=True)[:10]:
        print(f"  {ms:9.3f} ms {n:5d} calls  {name}", flush=True)


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


def rglru() -> None:
    """The fused RG-LRU layer and the scan alone against their plain
    versions (chip_smoke's limits), with events and the profiler's device
    time a launch, at the forecaster's training shape and griffin's."""
    from chip_smoke import SCAN_ATOL, layer_inputs, profiled_device_ms
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    from repro_torch.kernels.rglru_scan.ref import (rglru_gates,
                                                    rglru_layer_ref,
                                                    rglru_scan_ref)
    ok = True
    for shape in ((64, 48, 16), (4, 2048, 2560)):
        *inputs, gy = layer_inputs(*shape, "cuda", seed=9)
        live = [t.clone().requires_grad_(True) for t in inputs]
        y_r = rglru_layer_ref(*live)
        g_r = torch.autograd.grad(y_r, live, gy)
        y = rk.rglru_layer_fwd_cuda(*inputs)
        g = rk.rglru_layer_bwd_cuda(*inputs, y, gy)
        a, bx = rglru_gates(*inputs)
        ys = rk.rglru_scan_fwd_cuda(a, bx)
        da, dbx = rk.rglru_scan_bwd_cuda(a, ys, gy)
        torch.cuda.synchronize()
        errs = [(y - y_r).abs().max().item(),
                max((k - r).abs().max().item() for k, r in zip(g, g_r)),
                (ys - rglru_scan_ref(a, bx)).abs().max().item()]
        ok &= all(e <= SCAN_ATOL for e in errs)
        calls = dict(
            layer_fwd=lambda: rk.rglru_layer_fwd_cuda(*inputs),
            layer_bwd=lambda: rk.rglru_layer_bwd_cuda(*inputs, y, gy),
            fwd=lambda: rk.rglru_scan_fwd_cuda(a, bx),
            bwd=lambda: rk.rglru_scan_bwd_cuda(a, ys, gy))
        times = {k: (round(cuda_ms(f, 5, 50) * 1e3, 2),
                     round((profiled_device_ms(f, 20) or float("nan"))
                           * 1e3, 2)) for k, f in calls.items()}
        print(f"rglru {shape}: max|dy| {errs[0]:.3e}, grads max|d| "
              f"{errs[1]:.3e}, scan max|dy| "
              f"{errs[2]:.3e} (limit {SCAN_ATOL}); us a call (events, "
              f"device): {times}", flush=True)
    if not ok:
        sys.exit("rglru: a kernel is beyond the limit")


def host_us(fn, warmup: int = 200, reps: int = 5000) -> float:
    """Host wall a call of ``fn``, in microseconds (no synchronize: for
    host-only work such as caching-allocator calls)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def alloc() -> None:
    """Host time of the fused backward's outputs on the card, in turns:
    one caching-allocator call an output (d_pre_r, d_pre_i, d_x, d_lam and
    d_lam's partials, as the wrapper makes them) against two allocations
    cut into views, at the forecaster's training shape and griffin's."""
    for B, S, W in ((64, 48, 16), (4, 2048, 2560)):
        pre_r = torch.empty((B, S, W), device="cuda")
        lam = torch.empty((W,), device="cuda")

        def apart():
            return ([torch.empty_like(pre_r) for _ in range(3)],
                    torch.empty_like(lam), pre_r.new_empty(B * W))

        def views():
            return (pre_r.new_empty((3, B, S, W)).unbind(0),
                    pre_r.new_empty(W + B * W).split((W, B * W)))
        us = [round(host_us(f), 3) for f in (apart, views, views, apart)]
        print(f"alloc {(B, S, W)}: host us a call (apart, views, views, "
              f"apart) {us}", flush=True)


def fit_wall_s(seed: int = 0) -> float:
    """Host wall of one ``fit`` of the learned forecaster on the card (300
    AdamW steps and its validation passes) on a 15-column telemetry history
    of 120 hours, to a synchronize: the ``forecast.fit`` span of phase 5's
    training round outside the round."""
    from repro_torch.core import telemetry
    from repro_torch.forecast import learned
    tele = telemetry.generate(days=6, seed=seed)
    y = np.concatenate([tele.ci, tele.wue, tele.ewif], axis=1)[:120]
    f = learned.LearnedForecaster(seed=seed)
    t0 = time.perf_counter()
    f.fit(y)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def steps(src=None) -> None:
    """Kernels and time of a training step of the learned forecaster, and
    the wall of two whole fits, with the port under ``src`` first on the
    path (run once per tree, in turns, to compare trees in one call)."""
    from chip_smoke import train_step_profile
    if src:                           # after chip_smoke put its src first
        sys.path.insert(0, os.path.abspath(src))
    import repro_torch
    fits = [round(fit_wall_s(), 4) for _ in range(2)]
    print(f"port from {os.path.dirname(repro_torch.__file__)}: a step "
          f"{train_step_profile()}; fit walls (s) {fits}", flush=True)


def digest(src=None) -> None:
    """The flash kernels' output digests at offset 0
    (``chip_smoke.flash_digests``) and the SSD kernels' with no initial
    state (``chip_smoke.ssd_digests``) with the port under ``src`` first
    on the path, as JSON."""
    import json
    from chip_smoke import flash_digests, ssd_digests
    if src:                           # after chip_smoke put its src first
        sys.path.insert(0, os.path.abspath(src))
    import repro_torch
    print(f"port from {os.path.dirname(repro_torch.__file__)}", flush=True)
    print(json.dumps(dict(flash=flash_digests(), ssd=ssd_digests()),
                     indent=1), flush=True)


def ab_rglru(lib) -> None:
    """The built rglru_scan.cu's scan alone against a source with the
    per-lane kernels' ABI that the chunked ones replaced
    (``rglru_scan_fwd(a, bx, y, B, S, W, stream)``, ``rglru_scan_bwd(a,
    y, gy, da, dbx, B, S, W, stream)``) on the same inputs, at the
    forecaster's shapes and griffin's."""
    from chip_smoke import profiled_device_ms, scan_inputs
    from repro_torch.kernels.rglru_scan import rglru_scan as rk
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_fwd.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.rglru_scan_bwd.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    for shape in ((64, 48, 16), (16, 48, 16), (4, 2048, 2560)):
        a, bx, gy = scan_inputs(*shape, "cuda", seed=11)
        y_o = torch.empty_like(a)
        d_o = torch.empty((2, *shape), device="cuda")
        ys = rk.rglru_scan_fwd_cuda(a, bx)

        def theirs_fwd():
            err = lib.rglru_scan_fwd(a.data_ptr(), bx.data_ptr(),
                                     y_o.data_ptr(), *shape,
                                     torch.cuda.current_stream()
                                     .cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return y_o

        def theirs_bwd():
            err = lib.rglru_scan_bwd(a.data_ptr(), ys.data_ptr(),
                                     gy.data_ptr(), d_o[0].data_ptr(),
                                     d_o[1].data_ptr(), *shape,
                                     torch.cuda.current_stream()
                                     .cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return d_o
        ours_fwd = lambda: rk.rglru_scan_fwd_cuda(a, bx)
        ours_bwd = lambda: rk.rglru_scan_bwd_cuda(a, ys, gy)
        same = max((ours_fwd() - theirs_fwd()).abs().max().item(),
                   (torch.stack(ours_bwd()) - theirs_bwd()).abs().max()
                   .item())
        for name, theirs, ours in (("fwd", theirs_fwd, ours_fwd),
                                   ("bwd", theirs_bwd, ours_bwd)):
            t = [cuda_ms(f, 5, 50) * 1e3 for f in (theirs, ours, ours,
                                                   theirs)]
            dev = [(profiled_device_ms(f, 20) or float("nan")) * 1e3
                   for f in (theirs, ours)]
            print(f"rglru {name} {shape}: us (other, built, built, other) "
                  f"{[round(x, 2) for x in t]}; device us (other, built) "
                  f"{[round(x, 2) for x in dev]}; max|d| between them "
                  f"{same:.3e}", flush=True)


# The wgmma flash kernel's A/B cases at B 4, S 2048: (label, Hq, Hkv, D,
# Dv, Skv, causal, window): qwen2-1.5B's 12 over 2 at D 128 and 64, the
# gemma prefills' D 256 calls, and, against a source that has them, MLA's
# and the newer models' calls (chip_smoke.MODEL_FLASH).
AB_FLASH = [(f"D {D}", 12, 2, D, D, 2048, True, 0) for D in (128, 64)] + [
    (label, BHq // 4, BHq // 4 // group, 256, 256, 2048, True, window)
    for label, BHq, group, window in GEMMA_FLASH] + [
    (f"{label} MLA", H, H, D, Dv, 2048, True, 0)
    for label, H, D, Dv in MLA_FLASH] + [
    ("dbrx_132b", 48, 8, 128, 128, 2048, True, 0),
    ("llama_3_2_vision_11b self", 32, 8, 128, 128, 2048, True, 0),
    ("llama_3_2_vision_11b cross", 32, 8, 128, 128, 4096, False, 0),
    ("seamless_m4t_large_v2 encoder, cross", 16, 16, 64, 64, 2048, False, 0),
    ("seamless_m4t_large_v2 self", 16, 16, 64, 64, 2048, True, 0)]


def ab_flash(lib, offset: bool) -> None:
    """The built flash kernel, reading the model layout [B, S, H, D] in
    place, against another build of its source on the same inputs: one
    with the older [BH, S, D] entry (``flash_attention_fwd_sm90``) is fed
    contiguous heads-first copies, made once outside the timing, at the
    square causal cases it takes; one with the strided entry reads what
    the built one reads. Prints max |d| (0 where only the addressing or
    the order of work items changed) and both kernels' times. ``offset``:
    the other's strided entry takes a query offset (passed 0)."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    old = hasattr(lib, "flash_attention_fwd_sm90")
    if old:
        lib.flash_attention_fwd_sm90.argtypes = ([ptr] * 4 + [i32] * 7
                                                 + [ctypes.c_float, ptr])
    else:
        lib.flash_attention_fwd_sm90_strided.argtypes = (
            [ptr] * 4 + [i32] * 7 + [ptr, i32, i32] + [i32] * offset
            + [ctypes.c_float, ptr])
    B, S = 4, 2048
    for label, Hq, Hkv, D, Dv, Skv, causal, window in AB_FLASH:
        if old and (D != Dv or Skv != S or not causal):
            continue
        gen = torch.Generator(device="cuda").manual_seed(Hq + D)
        q = torch.randn((B, S, Hq, D), generator=gen,
                        device="cuda").bfloat16()
        k = torch.randn((B, Skv, Hkv, D), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn((B, Skv, Hkv, Dv), generator=gen,
                        device="cuda").bfloat16()
        scale = float(np.float32(1 / np.sqrt(D)))
        stream = lambda: torch.cuda.current_stream().cuda_stream
        if old:
            qh, kh, vh = (t.transpose(1, 2).reshape(-1, S, D).contiguous()
                          for t in (q, k, v))
            oh = torch.empty_like(qh)

            def theirs():
                err = lib.flash_attention_fwd_sm90(
                    qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                    oh.data_ptr(), B * Hq, S, S, D, Hq // Hkv, 1, window,
                    scale, stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return oh.view(B, Hq, S, D).transpose(1, 2)
        else:
            o2 = q.new_empty((B, S, Hq, Dv))
            strides = (ctypes.c_int64 * 12)(*(
                s for t in (q, k, v, o2) for s in fb._strides(t)))

            def theirs():
                err = lib.flash_attention_fwd_sm90_strided(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                    B, S, Skv, Hq, Hkv, D, Dv, strides, int(causal), window,
                    *[0] * offset, scale, stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return o2
        ours = lambda: fb.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
        diff = (ours().float() - theirs().float()).abs().max().item()
        t = [cuda_ms(f, 5, 50) * 1e3 for f in (theirs, ours, ours, theirs)]
        print(f"{label} [B {B}, {S} x {Skv}, {Hq} over {Hkv}, {D}/{Dv}] "
              f"causal {causal} window {window}: us (other"
              f"{' on heads-first copies' if old else ''}, built, built, "
              f"other) {[round(x, 2) for x in t]}; max|d| between them "
              f"{diff:.3e}", flush=True)


def ab(other: str) -> None:
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "probe-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    other], check=True)
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, "ssd_scan_fwd_sm90"):
        return ab_ssd(lib)
    if hasattr(lib, "rglru_scan_fwd"):
        return ab_rglru(lib)
    with open(other) as f:
        return ab_flash(lib, "int q_off" in f.read())


_TP13 = """
import os, sys, time, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from repro_torch.kernels import _build
_build.build(["flash_attention_sm90", "flash_attention"])
for name in ("flash_attention_sm90", "flash_attention"):
    _build.library(name)
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
cs.tp_qwen2_72b(torch.device("cuda"))
print(f"[{os.getcwd()}] {time.perf_counter() - t0:.1f} s", flush=True)
"""


def tp13(*roots) -> None:
    for root in roots or (HERE,):
        subprocess.run([sys.executable, "-c", _TP13],
                       cwd=os.path.abspath(root), check=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    stage = sys.argv[1] if len(sys.argv) > 1 else "flash"
    stages = dict(sinkhorn=sinkhorn, flash=flash, flash256=flash256, mla=mla,
                  ssd=ssd, ssdh0=ssdh0, cpj=cpj, rglru=rglru, alloc=alloc)
    if stage == "ab" and len(sys.argv) == 3:
        ab(sys.argv[2])
    elif stage == "steps" and len(sys.argv) <= 3:
        steps(*sys.argv[2:])
    elif stage == "digest" and len(sys.argv) <= 3:
        digest(*sys.argv[2:])
    elif stage == "ptxas":
        ptxas(*sys.argv[2:])
    elif stage == "tp13":
        tp13(*sys.argv[2:])
    elif stage in stages:
        stages[stage]()
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
