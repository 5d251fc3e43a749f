"""Public wrappers for the RG-LRU kernels, differentiable.

``rglru_layer(pre_r, pre_i, x, lam)`` is Griffin's recurrence from the
gate pre-activations: the gate math of ``ref.rglru_gates`` and the linear
recurrence y_t = a_t * y_{t-1} + bx_t (y_{-1} = 0). On a CUDA tensor it is
a ``torch.autograd.Function`` whose forward and backward are one launch
each of the fused kernels (``rglru_scan.py``); on a CPU tensor it is the
plain version ``ref.rglru_layer_ref``, differentiated by autograd.

``rglru_scan(a, bx)`` is the recurrence alone over precomputed gates. For
it the reverse-mode cotangents satisfy the reverse recurrence

    g_t = gy_t + a_{t+1} * g_{t+1},   g_S = 0
    da_t = g_t * y_{t-1},             db_t = g_t

and ``_Scan``'s forward saves (a, y) and its backward computes that
recurrence: on a CUDA tensor each direction is one launch of the scan-only
kernels, on a CPU tensor each takes its plain version (``ref.py``).

On a CUDA tensor every wrapper launches its kernel or raises on what the
kernel does not take. There is no other path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_dtensors
from repro_torch.kernels.rglru_scan import rglru_scan as _kernel
from repro_torch.kernels.rglru_scan.ref import (rglru_layer_ref,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_ref)


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RG-LRU scan kernel for device {t.device}")
    return t.device.type


class _Layer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pre_r, pre_i, x, lam):
        y = _kernel.rglru_layer_fwd_cuda(pre_r, pre_i, x, lam)
        if any(ctx.needs_input_grad):     # not when serving
            ctx.save_for_backward(pre_r, pre_i, x, lam, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        return _kernel.rglru_layer_bwd_cuda(*ctx.saved_tensors,
                                            gy.contiguous())


def rglru_layer(pre_r: torch.Tensor, pre_i: torch.Tensor, x: torch.Tensor,
                lam: torch.Tensor) -> torch.Tensor:
    """pre_r, pre_i, x: [B, S, W] float32; lam: [W] -> y [B, S, W], the
    recurrence over ``ref.rglru_gates(pre_r, pre_i, x, lam)``.
    Differentiable in all four."""
    refuse_dtensors("rglru_layer", pre_r, pre_i, x, lam)
    if _device_type(pre_r) == "cuda":
        return _Layer.apply(pre_r, pre_i, x, lam)
    return rglru_layer_ref(pre_r, pre_i, x, lam)


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
    parity with the reference and ignored: the kernels choose their own
    chunks (``rglru_scan.chunk_for``) and take any S."""
    del chunk
    refuse_dtensors("rglru_scan", a, bx)
    return _Scan.apply(a, bx)
