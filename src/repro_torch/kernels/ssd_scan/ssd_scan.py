"""The Hopper SSD scan kernel (``csrc/ssd_scan.cu``): ctypes binding and
launch.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/ssd_scan.py::
ssd_scan_pallas``; see the note at the top of the CUDA source for the
design and what bounds it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Kernel launches made by ``ssd_scan_cuda`` in this process (one per call).
# A plain counter, so a run can show that its main path went through the
# kernel.
LAUNCHES = 0

MAX_HEAD_DIM = 64
# Dynamic shared memory one block may use on a Hopper card.
SMEM_LIMIT = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("ssd_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
        lib.ssd_scan_fwd.restype = i32
        lib.ssd_scan_smem_bytes.argtypes = [i32] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _check(name, t, dtypes, dim, device):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
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


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """x: [b, S, H, P] (float32 or bfloat16); dt: [b, S, H] float32;
    A: [H] float32; Bm, Cm: [b, S, G, N] in x's dtype, G dividing H.
    Returns (y [b, S, H, P], final state [b, H, P, N]), both in x's dtype,
    from one launch on the card. Chunks are ``min(chunk, S)`` rows; a
    ragged last chunk is read as the reference's exact dt = 0 padding."""
    global LAUNCHES
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
    L = min(int(chunk), S)
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(P, N, L)
    if smem > SMEM_LIMIT:
        raise ValueError(f"P {P}, N {N}, chunk {L} need {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    y = torch.empty_like(x)
    state = torch.empty((b, H, P, N), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype],
            b, S, H, P, G, N, L, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, state
