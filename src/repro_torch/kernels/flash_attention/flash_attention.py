"""The Hopper flash-attention kernel (``csrc/flash_attention.cu``): ctypes
binding and launch.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention_bh``; see the note at the top of the
CUDA source for the design and what bounds it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# Kernel launches made by ``flash_attention_bh_cuda`` in this process (one
# per call). A plain counter, so a run can show that its main path went
# through the kernel.
LAUNCHES = 0

HEAD_DIMS = (16, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = ([ptr] * 4 + [i32] * 8
                                            + [ctypes.c_float, ptr])
        lib.flash_attention_fwd.restype = i32
        _LIB = lib
    return _LIB


def flash_attention_bh_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, scale=None,
                            group: int = 1) -> torch.Tensor:
    """q: [BHq, Sq, D]; k, v: [BHkv, Skv, D] with BHq = BHkv * group, on
    the card. Returns [BHq, Sq, D] in q's dtype. Head ``h`` attends kv head
    ``h // group``; ``scale`` defaults to 1/sqrt(D) and is applied to q in
    float32."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [BH, S, D], got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share one dtype and device")
    BH, Sq, D = q.shape
    BHkv, Skv = k.shape[0], k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if tuple(v.shape) != tuple(k.shape) or k.shape[2] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be [BHkv, Skv, {D}]")
    if group < 1 or BH != BHkv * group:
        raise ValueError(f"BHq {BH} != BHkv {BHkv} * group {group}")
    if min(BH, Sq, Skv) < 1 or BH > 65535 or max(q.numel(),
                                                 k.numel()) >= 2 ** 31:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = float(np.float32(scale if scale is not None
                             else 1.0 / np.sqrt(D)))
    lib = _lib()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], BH, Sq, Skv, D, group, int(bool(causal)),
            int(window), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return o
