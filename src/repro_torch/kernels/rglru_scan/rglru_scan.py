"""The Hopper RG-LRU scan kernels (``csrc/rglru_scan.cu``): ctypes binding
and launch, forward and backward.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan/rglru_scan.py::
rglru_scan_pallas`` and the reference's backward (``ops.py::_scan_bwd``,
one more kernel scan on reversed time); see the note at the top of the CUDA
source for the design and what bounds it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Kernel launches made by the wrappers below in this process, by direction
# (one per call). Plain counters, so a run can show that its main path went
# through the kernels.
LAUNCHES = {"fwd": 0, "bwd": 0}

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("rglru_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_fwd.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.rglru_scan_fwd.restype = i32
        lib.rglru_scan_bwd.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
        lib.rglru_scan_bwd.restype = i32
        _LIB = lib
    return _LIB


def _check(tensors: dict) -> tuple:
    """Shared input checks; returns (B, S, W)."""
    first = next(iter(tensors.values()))
    if first.dim() != 3:
        raise ValueError(f"expected [B, S, W] tensors, got shape "
                         f"{tuple(first.shape)}")
    shape = tuple(first.shape)
    if min(shape) < 1 or first.numel() >= 2 ** 31:
        raise ValueError(f"unsupported shape {shape}")
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != first.device:
            raise ValueError("all inputs must be on one device")
    return shape


def rglru_scan_fwd_cuda(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """y [B, S, W] with y_t = a_t * y_{t-1} + bx_t, on the card."""
    B, S, W = _check(dict(a=a, bx=bx))
    lib = _lib()
    y = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_fwd(a.data_ptr(), bx.data_ptr(), y.data_ptr(),
                                 B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan forward launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["fwd"] += 1
    return y


def rglru_scan_bwd_cuda(a: torch.Tensor, y: torch.Tensor,
                        gy: torch.Tensor):
    """(da, dbx) of the forward scan, from its gates ``a``, its output
    ``y`` and the output cotangent ``gy``, in one launch on the card."""
    B, S, W = _check(dict(a=a, y=y, gy=gy))
    lib = _lib()
    out = torch.empty((2, B, S, W), dtype=torch.float32, device=a.device)
    da, dbx = out[0], out[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_bwd(a.data_ptr(), y.data_ptr(), gy.data_ptr(),
                                 da.data_ptr(), dbx.data_ptr(), B, S, W,
                                 stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["bwd"] += 1
    return da, dbx
