"""The Hopper Sinkhorn-iteration kernel (``csrc/sinkhorn.cu``): ctypes
binding and launch.

Replaces the Pallas TPU kernel ``repro/kernels/sinkhorn/sinkhorn.py::
sinkhorn_iteration_pallas``; see the note at the top of the CUDA source for
the design and what bounds it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Kernel launches made by ``sinkhorn_iteration_cuda`` in this process (two
# per iteration: the row pass and the column combine). A plain counter, so a
# run can show that its main path went through the kernel.
LAUNCHES = 0
LAUNCHES_PER_ITERATION = 2

# g lives in the row launch's shared memory, beside 32 bytes of reduction
# scratch: at most 48 KB in all without opting in.
MAX_COLUMNS = 8192

_LIB = None
_ROWS = 0          # rows per block of the row launch, read from the library


def _lib() -> ctypes.CDLL:
    global _LIB, _ROWS
    if _LIB is None:
        lib = _build.library("sinkhorn")
        ptr = ctypes.c_void_p
        lib.sinkhorn_iteration.argtypes = [ptr] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ptr]
        lib.sinkhorn_iteration.restype = ctypes.c_int
        lib.sinkhorn_rows_per_block.argtypes = []
        lib.sinkhorn_rows_per_block.restype = ctypes.c_int
        _ROWS = lib.sinkhorn_rows_per_block()
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sinkhorn_iteration_cuda(C: torch.Tensor, g: torch.Tensor,
                            log_a: torch.Tensor, log_b: torch.Tensor,
                            eps: float):
    """One (f, g) update on the card. C: [M, N]; g/log_b: [N]; log_a: [M];
    all float32, contiguous, on one CUDA device. Returns (f [M], g [N])."""
    global LAUNCHES
    if C.dim() != 2:
        raise ValueError(f"C must be [M, N], got shape {tuple(C.shape)}")
    M, N = C.shape
    if M < 1 or not 1 <= N <= MAX_COLUMNS:
        raise ValueError(f"unsupported cost shape {(M, N)} (need M >= 1, "
                         f"1 <= N <= {MAX_COLUMNS})")
    _check("C", C, (M, N))
    _check("g", g, (N,))
    _check("log_a", log_a, (M,))
    _check("log_b", log_b, (N,))
    if not (g.device == log_a.device == log_b.device == C.device):
        raise ValueError("C, g, log_a and log_b must be on one device")
    lib = _lib()
    nblocks = -(-M // _ROWS)
    # One allocation per call: f [M] | g [N] | pmax [nblocks, N] |
    # psum [nblocks, N] (the column partials are scratch).
    buf = torch.empty(M + N + 2 * nblocks * N, dtype=torch.float32,
                      device=C.device)
    f, g_out = buf[:M], buf[M:M + N]
    pmax = buf.data_ptr() + 4 * (M + N)
    psum = pmax + 4 * nblocks * N
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sinkhorn_iteration(
            C.data_ptr(), g.data_ptr(), log_a.data_ptr(), log_b.data_ptr(),
            f.data_ptr(), g_out.data_ptr(), pmax, psum, M, N, float(eps),
            stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed: CUDA error {err}")
    LAUNCHES += LAUNCHES_PER_ITERATION
    return f, g_out
