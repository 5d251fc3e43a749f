"""The Hopper Sinkhorn kernels (``csrc/sinkhorn.cu``): ctypes binding and
launch of one iteration (``sinkhorn_iteration_cuda``), of the whole
annealed solve in one launch (``sinkhorn_solve_cuda``), of many cells'
annealed solves in one launch (``sinkhorn_solve_batched_cuda``) and of the
warm-started solve with a convergence exit (``sinkhorn_solve_adaptive_cuda``).

Replaces the Pallas TPU kernel ``repro/kernels/sinkhorn/sinkhorn.py::
sinkhorn_iteration_pallas`` (and, for the solve, the annealed loop around
it); see the note at the top of the CUDA source for the design and what
bounds it.
"""
from __future__ import annotations

import ctypes
import threading

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
# Launches of the cell-batched annealed solve made by
# ``sinkhorn_solve_batched_cuda`` (one per launch; a group too large to be
# co-resident takes several): the device executor's path.
ANNEAL_BATCHED_LAUNCHES = 0
# Launches of the warm-started, convergence-exit annealed solve made by
# ``sinkhorn_solve_adaptive_cuda`` (one per solve): the live service's
# warm round.
ANNEAL_ADAPTIVE_LAUNCHES = 0
# The counters are bumped from whichever thread launches (the device
# executor flushes from a cell's thread).
_COUNT_LOCK = threading.Lock()

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
        lib.sinkhorn_anneal_batched.argtypes = [ptr] * 4 + [
            ctypes.c_int] * 2 + [ptr] * 4 + [ctypes.c_int] * 3 + [ptr]
        lib.sinkhorn_anneal_batched.restype = ctypes.c_int
        lib.sinkhorn_anneal_adaptive.argtypes = [ptr] * 4 + [
            ctypes.c_float, ptr] + [ctypes.c_int] * 2 + [ptr] * 5 + [
            ctypes.c_int] * 2 + [ptr]
        lib.sinkhorn_anneal_adaptive.restype = ctypes.c_int
        lib.sinkhorn_anneal_max_blocks.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.sinkhorn_anneal_max_blocks.restype = ctypes.c_int
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
    with _COUNT_LOCK:
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
    _check_schedule(table, iters)
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
    with _COUNT_LOCK:
        ANNEAL_LAUNCHES += 1
    return f, g


def sinkhorn_solve_adaptive_cuda(C: torch.Tensor, log_a: torch.Tensor,
                                 log_b: torch.Tensor, g0: torch.Tensor,
                                 tol: float, eps_table, iters: int):
    """The warm-started annealed solve with a per-stage convergence exit on
    the card, in one launch: from f = 0 and g = ``g0``, each eps of
    ``eps_table`` (float32 values, one a stage) runs iterations while
    fewer than ``iters`` have run in the stage and the last one's
    ``max |g_new - g|`` is above float32 ``tol`` (a NaN change exits).
    C: [M, N]; log_a: [M]; g0/log_b: [N]; all float32, contiguous, on one
    CUDA device. Returns (f [M], g [N], used): ``used`` a 0-d int32 tensor
    on the card, the iterations run in all; f, g and used are bitwise
    those of the loop of ``sinkhorn_iteration_cuda`` under the same exit
    rule."""
    global ANNEAL_ADAPTIVE_LAUNCHES
    table = [float(e) for e in eps_table]
    _check_schedule(table, iters)
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
    _check("g0", g0, (N,))
    if not (log_a.device == log_b.device == g0.device == C.device):
        raise ValueError("C, log_a, log_b and g0 must be on one device")
    lib = _lib()
    nblocks = -(-M // _ROWS)
    # f [M] | g [N] | pmax [2, nblocks, N] | psum [2, nblocks, N], as for
    # the fixed schedule; the iteration count apart, as an int32.
    buf = torch.empty(M + N + 4 * nblocks * N, dtype=torch.float32,
                      device=C.device)
    used = torch.empty((), dtype=torch.int32, device=C.device)
    f, g = buf[:M], buf[M:M + N]
    pmax = buf.data_ptr() + 4 * (M + N)
    psum = pmax + 4 * 2 * nblocks * N
    host_table = (ctypes.c_float * len(table))(*table)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sinkhorn_anneal_adaptive(
            C.data_ptr(), log_a.data_ptr(), log_b.data_ptr(), g0.data_ptr(),
            float(tol), ctypes.cast(host_table, ctypes.c_void_p), len(table),
            int(iters), f.data_ptr(), g.data_ptr(), pmax, psum,
            used.data_ptr(), M, N, stream)
    if err == _TOO_LARGE:
        raise RuntimeError(f"the annealed Sinkhorn's {nblocks} blocks (M = "
                           f"{M}, N = {N}) cannot all be co-resident on "
                           f"this card")
    if err != 0:
        raise RuntimeError(f"sinkhorn_anneal_adaptive launch failed: CUDA "
                           f"error {err}")
    with _COUNT_LOCK:
        ANNEAL_ADAPTIVE_LAUNCHES += 1
    return f, g, used


def _check_schedule(table: list, iters) -> None:
    if not 1 <= len(table) <= MAX_STAGES:
        raise ValueError(f"the eps table needs 1 to {MAX_STAGES} stages, "
                         f"got {len(table)}")
    if int(iters) != iters or iters < 0:
        raise ValueError(f"iters must be a non-negative int, got {iters}")


# Co-resident blocks of the annealed launch, by (device index, N).
_MAX_BLOCKS: dict = {}


def max_blocks(N: int, device: torch.device) -> int:
    """How many blocks of the annealed launch at N columns fit on the card
    at once (the library's occupancy x SMs); a launch of B cells of M rows
    needs B x ceil(M / rows_per_block()) of them."""
    key = (device.index, int(N))
    if key not in _MAX_BLOCKS:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.sinkhorn_anneal_max_blocks(int(N), ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"sinkhorn_anneal_max_blocks failed: CUDA "
                               f"error {err}")
        _MAX_BLOCKS[key] = out.value
    return _MAX_BLOCKS[key]


def rows_per_block() -> int:
    """Rows one block of the annealed launch holds (from the library)."""
    _lib()
    return _ROWS


def sinkhorn_solve_batched_cuda(C: torch.Tensor, log_a: torch.Tensor,
                                log_b: torch.Tensor, eps_table, iters: int):
    """B cells' annealed solves on the card: ``iters`` iterations at each
    eps of ``eps_table`` from g = 0, for every cell. C: [B, M, N]; log_a:
    [B, M]; log_b: [B, N]; all float32, contiguous, on one CUDA device.
    Returns (f [B, M], g [B, N]); each cell's f and g are bitwise those of
    ``sinkhorn_solve_cuda`` on that cell. The cells go in launches of as
    many as can be co-resident (``max_blocks``), one launch when they all
    fit."""
    global ANNEAL_BATCHED_LAUNCHES
    table = [float(e) for e in eps_table]
    _check_schedule(table, iters)
    if C.dim() != 3:
        raise ValueError(f"C must be [B, M, N], got shape {tuple(C.shape)}")
    B, M, N = C.shape
    if B < 1 or M < 1 or not 1 <= N <= MAX_ANNEAL_COLUMNS:
        raise ValueError(f"unsupported cost shape {(B, M, N)} for the "
                         f"batched annealed launch (need B >= 1, M >= 1, "
                         f"1 <= N <= {MAX_ANNEAL_COLUMNS})")
    _check("C", C, (B, M, N))
    _check("log_a", log_a, (B, M))
    _check("log_b", log_b, (B, N))
    if not (log_a.device == log_b.device == C.device):
        raise ValueError("C, log_a and log_b must be on one device")
    lib = _lib()
    nblocks = -(-M // _ROWS)
    per_launch = min(B, max_blocks(N, C.device) // nblocks)
    if per_launch < 1:
        raise RuntimeError(f"the annealed Sinkhorn's {nblocks} blocks (M = "
                           f"{M}, N = {N}) cannot all be co-resident on "
                           f"this card")
    f = torch.empty((B, M), dtype=torch.float32, device=C.device)
    g = torch.empty((B, N), dtype=torch.float32, device=C.device)
    # pmax | psum, each [per_launch, 2, nblocks, N]: reused by every launch
    # of the split (one stream, so in order).
    part = per_launch * 2 * nblocks * N
    scratch = torch.empty(2 * part, dtype=torch.float32, device=C.device)
    pmax = scratch.data_ptr()
    psum = pmax + 4 * part
    host_table = (ctypes.c_float * len(table))(*table)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, B, per_launch):
            nb = min(per_launch, B - b0)
            err = lib.sinkhorn_anneal_batched(
                C.data_ptr() + 4 * b0 * M * N,
                log_a.data_ptr() + 4 * b0 * M,
                log_b.data_ptr() + 4 * b0 * N,
                ctypes.cast(host_table, ctypes.c_void_p), len(table),
                int(iters), f.data_ptr() + 4 * b0 * M,
                g.data_ptr() + 4 * b0 * N, pmax, psum, nb, M, N, stream)
            if err == _TOO_LARGE:
                raise RuntimeError(f"{nb} cells of the annealed Sinkhorn "
                                   f"({nb} x {nblocks} blocks) cannot all "
                                   f"be co-resident on this card")
            if err != 0:
                raise RuntimeError(f"sinkhorn_anneal_batched launch failed: "
                                   f"CUDA error {err}")
            with _COUNT_LOCK:
                ANNEAL_BATCHED_LAUNCHES += 1
    return f, g
