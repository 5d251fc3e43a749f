"""The Hopper RG-LRU kernels (``csrc/rglru_scan.cu``): ctypes binding and
launch of the fused layer (gate math + recurrence, forward and backward)
and of the scan alone over precomputed gates (forward and backward).

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan/rglru_scan.py::
rglru_scan_pallas`` and the reference's backward (``ops.py::_scan_bwd``,
one more kernel scan on reversed time), with the gate math of
``repro/models/rglru.py::_gates`` folded into the fused pair; see the note
at the top of the CUDA source for the design and what bounds it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Kernel launches made by the wrappers below in this process, by entry (one
# per call): the fused layer and the scan alone, each way. Plain counters,
# so a run can show that its main path went through the kernels.
LAUNCHES = {"layer_fwd": 0, "layer_bwd": 0, "fwd": 0, "bwd": 0}

# The kernels' time tiling (csrc/rglru_scan.cu): tiles of CHUNKS_PER_TILE
# chunks, one thread each; S up to CHUNKS_PER_TILE * MAX_CHUNK is one tile
# of chunks of ceil(S / 8) steps, a longer S tiles of LONG_CHUNK-step
# chunks. ``ref.rglru_scan_chunked_ref`` takes the same chunks.
CHUNKS_PER_TILE = 8
MAX_CHUNK = 16
LONG_CHUNK = 8

_FN = {}
# One ticket (an int32 that the fused backward leaves at 0) per device and
# stream: launches that share one must be ordered.
_TICKETS = {}

# Host work a call, kept small (the forecaster's launches are host-bound):
# the C functions are looked up once; each output is its own caching-
# allocator call, which costs ~3-4 us less host time a call on an H100
# machine than one allocation cut into views (``kernel_probe.py alloc``; a
# view of one buffer would also keep all of it alive as lam.grad); the
# current device is switched only when it is not the inputs'; the stream
# is read raw, without building a torch.cuda.Stream object.


def chunk_for(S: int) -> int:
    """Steps a chunk for a sequence of S steps, as the launch takes it."""
    if S <= CHUNKS_PER_TILE * MAX_CHUNK:
        return -(-S // CHUNKS_PER_TILE)
    return LONG_CHUNK


def _fns() -> dict:
    if not _FN:
        lib = _build.library("rglru_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr in (("rglru_layer_fwd", 5), ("rglru_layer_bwd", 12),
                            ("rglru_scan_chunked_fwd", 3),
                            ("rglru_scan_chunked_bwd", 5)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptr + [i32] * 4 + [ptr]
            fn.restype = i32
            _FN[name] = fn
    return _FN


def _check(*named) -> tuple:
    """Input checks over (name, tensor, shape or None for [B, S, W]) in
    order; returns ((B, S, W) of the first, its device index)."""
    first = named[0][1]
    if first.dim() != 3:
        raise ValueError(f"expected [B, S, W] tensors, got shape "
                         f"{tuple(first.shape)}")
    shape = first.shape
    if min(shape) < 1 or first.numel() >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(shape)}")
    index = first.get_device()
    for name, t, want in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        want = shape if want is None else want
        if t.shape != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.get_device() != index:
            raise ValueError("all inputs must be on one device")
    return tuple(shape), index


def _launch(name: str, index: int, *args) -> None:
    """Call the C launcher ``name`` on device ``index``'s current stream."""
    fn = _FN.get(name) or _fns()[name]
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def rglru_layer_fwd_cuda(pre_r: torch.Tensor, pre_i: torch.Tensor,
                         x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The fused forward on the card: y [B, S, W] of the recurrence over
    the gates of (pre_r, pre_i, x [B, S, W], lam [W])."""
    (B, S, W), index = _check(("pre_r", pre_r, None), ("pre_i", pre_i, None),
                              ("x", x, None),
                              ("lam", lam, (pre_r.shape[-1],)))
    y = torch.empty_like(pre_r)
    _launch("rglru_layer_fwd", index, pre_r.data_ptr(), pre_i.data_ptr(),
            x.data_ptr(), lam.data_ptr(), y.data_ptr(), B, S, W,
            chunk_for(S))
    LAUNCHES["layer_fwd"] += 1
    return y


def _ticket(index: int) -> torch.Tensor:
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                        device=f"cuda:{index}")
    return t


def rglru_layer_bwd_cuda(pre_r, pre_i, x, lam, y, gy):
    """The fused backward on the card, in one launch: (d_pre_r, d_pre_i,
    d_x [B, S, W], d_lam [W]) from the forward's inputs, its output ``y``
    and the output cotangent ``gy``."""
    (B, S, W), index = _check(("pre_r", pre_r, None), ("pre_i", pre_i, None),
                              ("x", x, None),
                              ("lam", lam, (pre_r.shape[-1],)),
                              ("y", y, None), ("gy", gy, None))
    d_pre_r, d_pre_i, d_x = (torch.empty_like(pre_r) for _ in range(3))
    d_lam = torch.empty_like(lam)
    partial = pre_r.new_empty(B * W)          # d_lam's per-block partials
    _launch("rglru_layer_bwd", index, pre_r.data_ptr(), pre_i.data_ptr(),
            x.data_ptr(), lam.data_ptr(), y.data_ptr(), gy.data_ptr(),
            d_pre_r.data_ptr(), d_pre_i.data_ptr(), d_x.data_ptr(),
            d_lam.data_ptr(), partial.data_ptr(), _ticket(index).data_ptr(),
            B, S, W, chunk_for(S))
    LAUNCHES["layer_bwd"] += 1
    return d_pre_r, d_pre_i, d_x, d_lam


def rglru_scan_fwd_cuda(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """y [B, S, W] with y_t = a_t * y_{t-1} + bx_t, on the card."""
    (B, S, W), index = _check(("a", a, None), ("bx", bx, None))
    y = torch.empty_like(a)
    _launch("rglru_scan_chunked_fwd", index, a.data_ptr(), bx.data_ptr(),
            y.data_ptr(), B, S, W, chunk_for(S))
    LAUNCHES["fwd"] += 1
    return y


def rglru_scan_bwd_cuda(a: torch.Tensor, y: torch.Tensor,
                        gy: torch.Tensor):
    """(da, dbx) of the forward scan, from its gates ``a``, its output
    ``y`` and the output cotangent ``gy``, in one launch on the card."""
    (B, S, W), index = _check(("a", a, None), ("y", y, None),
                              ("gy", gy, None))
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    _launch("rglru_scan_chunked_bwd", index, a.data_ptr(), y.data_ptr(),
            gy.data_ptr(), da.data_ptr(), dbx.data_ptr(), B, S, W,
            chunk_for(S))
    LAUNCHES["bwd"] += 1
    return da, dbx
