"""The Hopper SSD scan kernels: ctypes binding and launch.

Two kernels replace the Pallas TPU kernel ``repro/kernels/ssd_scan/
ssd_scan.py::ssd_scan_pallas``, chosen by ``variant(dtype, P, N, L)``:

  ``wgmma``   bf16 with P = 64, N a multiple of 64 up to 128 and chunk
              length L a multiple of 64 up to 256: ``csrc/ssd_scan_sm90.cu``,
              the chunk-parallel SSD in three launches with every product
              on the tensor cores (wgmma) and x, B, C staged by TMA — the
              LM prefill's path;
  ``scalar``  float32, and every other shape: ``csrc/ssd_scan.cu``, one
              block per (b, h) stream, scalar float32 FMAs.

Both take an initial state ``h0`` [b, H, P, N] in float32 (the state
entering the first chunk; a context-parallel segment's incoming state).
``ssd_final_cuda`` is the entry that forms the final state from zero in
float32 and no y: the wgmma kernel's launches 1 and 2, or the scalar
kernel's chunk walk for the state alone.

See the notes at the top of the CUDA sources for the designs and what
bounds them. Neither falls back on the other: a call the chosen kernel
does not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Kernel calls in this process (one per call), in all and by entry: the
# scan by variant, and the final state from zero (``ssd_final_cuda``) by
# variant apart from it. Plain counters, so a run can show that its main
# path went through the kernels, and which.
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"wgmma": 0, "scalar": 0, "wgmma_final": 0,
                       "scalar_final": 0}
# The scan's calls that started from a given state (``h0``), by variant:
# a part of LAUNCHES_BY_VARIANT's.
LAUNCHES_FROM_STATE = {"wgmma": 0, "scalar": 0}
# Device launches one call makes, by entry.
KERNELS_PER_CALL = {"wgmma": 3, "scalar": 1, "wgmma_final": 2,
                    "scalar_final": 1}

MAX_HEAD_DIM = 64
WGMMA_HEAD_DIM = 64
WGMMA_STATES = (64, 128)
WGMMA_MAX_CHUNK = 256
# Dynamic shared memory one block may use on a Hopper card.
SMEM_LIMIT = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# TMA reads from 16-byte aligned global addresses only.
TMA_ALIGN = 16

_LIBS = {}


def variant(dtype: torch.dtype, P: int, N: int, L: int) -> str:
    """The kernel that takes a call with head dim P, state size N and chunk
    length L (``min(chunk, S)``): ``"wgmma"`` for bf16 with P 64, N in
    ``WGMMA_STATES`` and L a multiple of 64 up to 256, else ``"scalar"``."""
    return ("wgmma" if dtype == torch.bfloat16 and P == WGMMA_HEAD_DIM
            and N in WGMMA_STATES and L % 64 == 0
            and 0 < L <= WGMMA_MAX_CHUNK else "scalar")


def _lib(kind: str) -> ctypes.CDLL:
    lib = _LIBS.get(kind)
    if lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if kind == "scalar":
            lib = _build.library("ssd_scan")
            lib.ssd_scan_fwd.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
            lib.ssd_scan_fwd.restype = i32
            lib.ssd_scan_smem_bytes.argtypes = [i32] * 3
            lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        else:
            lib = _build.library("ssd_scan_sm90")
            lib.ssd_scan_fwd_sm90.argtypes = [ptr] * 12 + [i32] * 6 + [ptr]
            lib.ssd_scan_fwd_sm90.restype = i32
        _LIBS[kind] = lib
    return lib


def _check(name, t, dtypes, dim, device):
    if t.device != device:
        raise ValueError("all inputs must be on one device")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inputs(x, dt, A, Bm, Cm, *, chunk: int = 256, h0=None) -> str:
    """Raise on what neither kernel takes; return the variant that takes
    the rest. ``h0``, where given, must be float32 [b, H, P, N], contiguous
    and 16-byte aligned (the state pass reads it four floats at a time).
    Device-free, so that the CPU tests reach every refusal."""
    dev = x.device
    _check("x", x, tuple(_DTYPES), 4, dev)
    _check("dt", dt, (torch.float32,), 3, dev)
    _check("A", A, (torch.float32,), 1, dev)
    _check("Bm", Bm, (x.dtype,), 4, dev)
    _check("Cm", Cm, (x.dtype,), 4, dev)
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if tuple(Bm.shape[:2]) != (b, S) or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} must "
                         f"be [{b}, {S}, G, N]")
    if min(b, S, H, P, G, N) < 1 or H % G:
        raise ValueError(f"unsupported shape x {tuple(x.shape)}, "
                         f"G {G}, N {N}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"head dim {P} > {MAX_HEAD_DIM}")
    if x.numel() >= 2 ** 31 or b * H > 2 ** 31 - 1:
        raise ValueError(f"x too large: {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if h0 is not None:
        _check("h0", h0, (torch.float32,), 4, dev)
        if tuple(h0.shape) != (b, H, P, N):
            raise ValueError(f"h0 {tuple(h0.shape)} must be [{b}, {H}, {P}, "
                             f"{N}]")
        if h0.data_ptr() % TMA_ALIGN:
            raise ValueError(f"h0 must be {TMA_ALIGN}-byte aligned")
    L = min(int(chunk), S)
    kind = variant(x.dtype, P, N, L)
    if kind == "wgmma":
        nc = -(-S // L)
        if b * nc * H * 2 * P * N >= 2 ** 31:
            raise ValueError(f"x too large for the wgmma kernel's scratch: "
                             f"{tuple(x.shape)}, N {N}, chunk {L}")
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            if t.data_ptr() % TMA_ALIGN:
                raise ValueError(f"{name} must be {TMA_ALIGN}-byte aligned "
                                 f"for the TMA loads of the wgmma kernel")
    return kind


def _on_card(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int = 256, h0=None):
    """x: [b, S, H, P] (float32 or bfloat16); dt: [b, S, H] float32;
    A: [H] float32; Bm, Cm: [b, S, G, N] in x's dtype, G dividing H;
    h0: the state entering the first chunk, [b, H, P, N] float32, or None
    (zero). Returns (y [b, S, H, P], final state [b, H, P, N]), both in
    x's dtype, from the kernel ``variant`` chooses, on the card. Chunks
    are ``min(chunk, S)`` rows; a ragged last chunk is read as the
    reference's exact dt = 0 padding."""
    _on_card(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, h0=h0)
    kind = check_inputs(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return _launch(kind, x, dt, A, Bm, Cm, min(int(chunk), x.shape[1]),
                   h0=h0)


def ssd_final_cuda(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """The final state [b, H, P, N] in float32 of the scan from a zero
    state, and no y: the inputs as ``ssd_scan_cuda`` takes them. The
    wgmma kernel's launches 1 and 2 (the chunk states and the state pass)
    or the scalar kernel's walk for the state alone; counted under
    ``"<variant>_final"``."""
    _on_card(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    kind = check_inputs(x, dt, A, Bm, Cm, chunk=chunk)
    return _launch(kind, x, dt, A, Bm, Cm, min(int(chunk), x.shape[1]),
                   final_only=True)


def _launch(kind: str, x, dt, A, Bm, Cm, L: int, h0=None,
            final_only: bool = False):
    """One call of the ``kind`` kernel on inputs ``check_inputs`` passed,
    with chunks of L rows, from ``h0`` (or zero): (y, state) in x's dtype;
    with ``final_only`` the float32 state alone, no y formed. The scalar kernel takes every such
    call, so timing code may hand it a call the wgmma kernel would take.
    Forward only: raises when grad is enabled and an input requires it
    (``ops.ssd_scan`` differentiates)."""
    global LAUNCHES
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, h0)):
        raise RuntimeError(
            "the SSD scan kernels' launchers are forward-only: an input "
            "requires grad, and the outputs would carry no gradient. "
            "ops.ssd_scan carries it (the kernel forward, the plain "
            "version's backward); call that, or this under torch.no_grad() "
            "or with detached inputs")
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    lib = _lib(kind)
    y = state = state32 = None
    if final_only:
        state32 = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    else:
        y = torch.empty_like(x)
        state = torch.empty((b, H, P, N), dtype=x.dtype, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), ptr(h0), ptr(y), ptr(state), ptr(state32))
        if kind == "wgmma":
            # Scratch of the three launches: each chunk's own state
            # contribution and decay, and the state entering each chunk as
            # a bf16 hi + lo pair.
            nc = -(-S // L)
            sc = torch.empty((b, nc, H, P, N), dtype=torch.float32,
                             device=dev)
            decay = torch.empty((b, nc, H), dtype=torch.float32, device=dev)
            hin = None if final_only else torch.empty(
                (b, nc, H, 2, P, N), dtype=torch.bfloat16, device=dev)
            err = lib.ssd_scan_fwd_sm90(
                *ptrs, sc.data_ptr(), decay.data_ptr(), ptr(hin), b, S, H, G,
                N, L, stream)
        else:
            smem = lib.ssd_scan_smem_bytes(P, N, L)
            if smem > SMEM_LIMIT:
                raise ValueError(f"P {P}, N {N}, chunk {L} need {smem} "
                                 f"bytes of shared memory, more than "
                                 f"{SMEM_LIMIT}")
            err = lib.ssd_scan_fwd(*ptrs, _DTYPES[x.dtype], b, S, H, P, G,
                                   N, L, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan ({kind}) launch failed: error {err}")
    LAUNCHES += 1
    if final_only:
        LAUNCHES_BY_VARIANT[f"{kind}_final"] += 1
        return state32
    LAUNCHES_BY_VARIANT[kind] += 1
    if h0 is not None:
        LAUNCHES_FROM_STATE[kind] += 1
    return y, state
