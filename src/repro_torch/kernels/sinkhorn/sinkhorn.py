"""The Hopper Sinkhorn kernels (``csrc/sinkhorn.cu``): ctypes binding and
launch of one iteration (``sinkhorn_iteration_cuda``) and of the whole
annealed solve in one launch (``sinkhorn_solve_cuda``).

Replaces the Pallas TPU kernel ``repro/kernels/sinkhorn/sinkhorn.py::
sinkhorn_iteration_pallas`` (and, for the solve, the annealed loop around
it); see the note at the top of the CUDA source for the design and what
bounds it.
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
# Launches of the annealed solve made by ``sinkhorn_solve_cuda`` (one per
# solve): the scheduling round's main path.
ANNEAL_LAUNCHES = 0

# g lives in the row launch's shared memory, beside 32 bytes of reduction
# scratch: at most 48 KB in all without opting in.
MAX_COLUMNS = 8192
# The annealed launch keeps a block's 256 rows of C in shared memory beside
# g: (256 N + N) floats within the 227 KB a block may use.
MAX_ANNEAL_COLUMNS = 216

_LIB = None
_ROWS = 0          # rows per block of the row launch, read from the library
# Entries of the annealed launch's eps table (MAX_STAGES in the source).
MAX_STAGES = 32


def _lib() -> ctypes.CDLL:
    global _LIB, _ROWS
    if _LIB is None:
        lib = _build.library("sinkhorn")
        ptr = ctypes.c_void_p
        lib.sinkhorn_iteration.argtypes = [ptr] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ptr]
        lib.sinkhorn_iteration.restype = ctypes.c_int
        lib.sinkhorn_anneal.argtypes = [ptr] * 4 + [ctypes.c_int] * 2 + [
            ptr] * 4 + [ctypes.c_int] * 2 + [ptr]
        lib.sinkhorn_anneal.restype = ctypes.c_int
        for name in ("sinkhorn_rows_per_block", "sinkhorn_max_stages"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _ROWS = lib.sinkhorn_rows_per_block()
        if lib.sinkhorn_max_stages() != MAX_STAGES:
            raise RuntimeError("csrc/sinkhorn.cu's MAX_STAGES differs from "
                               "the binding's")
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


# cudaErrorCooperativeLaunchTooLarge: the grid would not be co-resident.
_TOO_LARGE = 82


def sinkhorn_solve_cuda(C: torch.Tensor, log_a: torch.Tensor,
                        log_b: torch.Tensor, eps_table, iters: int):
    """The annealed solve on the card in one launch: ``iters`` iterations
    at each eps of ``eps_table`` (float32 values, one a stage) from
    g = 0. C: [M, N]; log_a: [M]; log_b: [N]; all float32, contiguous, on
    one CUDA device. Returns (f [M], g [N]), bitwise equal to the loop of
    ``sinkhorn_iteration_cuda`` over the same schedule."""
    global ANNEAL_LAUNCHES
    table = [float(e) for e in eps_table]
    if not 1 <= len(table) <= MAX_STAGES:
        raise ValueError(f"the eps table needs 1 to {MAX_STAGES} stages, "
                         f"got {len(table)}")
    if int(iters) != iters or iters < 0:
        raise ValueError(f"iters must be a non-negative int, got {iters}")
    if C.dim() != 2:
        raise ValueError(f"C must be [M, N], got shape {tuple(C.shape)}")
    M, N = C.shape
    if M < 1 or not 1 <= N <= MAX_ANNEAL_COLUMNS:
        raise ValueError(f"unsupported cost shape {(M, N)} for the annealed "
                         f"launch (need M >= 1, 1 <= N <= "
                         f"{MAX_ANNEAL_COLUMNS})")
    _check("C", C, (M, N))
    _check("log_a", log_a, (M,))
    _check("log_b", log_b, (N,))
    if not (log_a.device == log_b.device == C.device):
        raise ValueError("C, log_a and log_b must be on one device")
    lib = _lib()
    nblocks = -(-M // _ROWS)
    # f [M] | g [N] | pmax [2, nblocks, N] | psum [2, nblocks, N]: the
    # launch's column partials alternate between two buffers.
    buf = torch.empty(M + N + 4 * nblocks * N, dtype=torch.float32,
                      device=C.device)
    f, g = buf[:M], buf[M:M + N]
    pmax = buf.data_ptr() + 4 * (M + N)
    psum = pmax + 4 * 2 * nblocks * N
    host_table = (ctypes.c_float * len(table))(*table)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sinkhorn_anneal(
            C.data_ptr(), log_a.data_ptr(), log_b.data_ptr(),
            ctypes.cast(host_table, ctypes.c_void_p), len(table), int(iters),
            f.data_ptr(), g.data_ptr(), pmax, psum, M, N, stream)
    if err == _TOO_LARGE:
        raise RuntimeError(f"the annealed Sinkhorn's {nblocks} blocks (M = "
                           f"{M}, N = {N}) cannot all be co-resident on "
                           f"this card")
    if err != 0:
        raise RuntimeError(f"sinkhorn_anneal launch failed: CUDA error {err}")
    ANNEAL_LAUNCHES += 1
    return f, g
