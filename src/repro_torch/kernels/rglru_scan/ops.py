"""Public wrapper for the RG-LRU scan kernels, differentiable.

For the linear recurrence y_t = a_t * y_{t-1} + b_t (y_{-1} = 0) the
reverse-mode cotangents satisfy the reverse recurrence

    g_t = gy_t + a_{t+1} * g_{t+1},   g_S = 0
    da_t = g_t * y_{t-1},             db_t = g_t

``rglru_scan`` is a ``torch.autograd.Function`` whose forward saves
(a, y) and whose backward computes that recurrence: on a CUDA tensor each
direction is one launch of its kernel (``rglru_scan.py``) and raises on
what the kernel does not take; on a CPU tensor each takes its plain
version (``ref.py``). There is no other path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan import rglru_scan as _kernel
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RG-LRU scan kernel for device {t.device}")
    return t.device.type


class _Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, bx):
        if _device_type(a) == "cuda":
            y = _kernel.rglru_scan_fwd_cuda(a, bx)
        else:
            y = rglru_scan_ref(a, bx)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        a, y = ctx.saved_tensors
        gy = gy.contiguous()
        if _device_type(a) == "cuda":
            return _kernel.rglru_scan_bwd_cuda(a, y, gy)
        return rglru_scan_bwd_ref(a, y, gy)


def rglru_scan(a: torch.Tensor, bx: torch.Tensor, *, chunk: int = 128):
    """a, bx: [B, S, W] float32 -> y with y_t = a_t * y_{t-1} + bx_t.
    Differentiable in both arguments. ``chunk`` is kept for signature
    parity with the reference and ignored: one thread walks all of S, so
    the kernel has no chunk and no ``S % chunk`` constraint."""
    del chunk
    return _Scan.apply(a, bx)
