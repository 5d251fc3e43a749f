"""Public wrapper for the flash-attention kernel, on the model's layout.

``flash_attention`` takes q [B, Sq, Kh, G, D], k [B, Skv, Kh, D] and v
[B, Skv, Kh, Dv] (``models/attention.py``); query head ``(kh, g)`` reads
kv head ``kh``. On a CPU tensor it takes the plain version (``ref.py``),
unpadded; on a CUDA tensor it launches the kernel ``kernel_call`` names,
raising on what that kernel does not take. There is no other path.

Both wrappers are differentiable. On the CPU autograd goes through the
plain version. On a CUDA tensor each is a ``torch.autograd.Function``:
the forward is the kernel, one launch a call, saving q, k and v; the
backward is the gradient of the plain blocked version
(``ref.flash_attention_blocked``, kv blocks of ``block_kv``, each
checkpointed) recomputed from them. That is the algorithm the reference
differentiates: its TPU kernel has no backward.

The wgmma kernel (bf16 at the (D, Dv) pairs of ``WGMMA_DIMS``: 64, 128
and 256 square, MLA's 96/64 and 192/128) reads q, k and v where they lie
and writes o in the model's layout: q is viewed as [B, Sq, Kh·G, D], and
no copy or permute is made. Every other call — float32 (the scalar
kernel), or bf16 at head dims with no instantiation of their own — puts
heads first in one copy, zero-padded to ``padded_dim``: zero columns
appended to q and k leave every q·k unchanged, and zero columns appended
to v give output columns that are sliced off, so one launch at the padded
D computes the reference's function exactly, given the scale of the
unpadded D (1/sqrt(D) unless the caller names one).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import plain_vjp, refuse_dtensors
from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bh_blocked, flash_attention_bh_ref,
    flash_attention_blocked, flash_attention_ref)


def padded_dim(D: int, Dv: int) -> int:
    """The smallest kernel head dim (``HEAD_DIMS``) that holds both D and
    Dv; raises above the largest."""
    for Dp in _kernel.HEAD_DIMS:
        if Dp >= max(D, Dv):
            return Dp
    raise ValueError(f"head dims {D} (q, k) and {Dv} (v): no flash kernel "
                     f"takes a head dim above {_kernel.HEAD_DIMS[-1]}")


def kernel_call(dtype, D: int, Dv: int) -> tuple:
    """(variant, D_qk, D_v) of the launch that serves a CUDA call at head
    dims (D, Dv): the wgmma kernel at them where it has an instantiation,
    else the kernel ``variant`` picks at ``padded_dim(D, Dv)``, square."""
    if _kernel.variant(dtype, D, Dv) == "wgmma":
        return "wgmma", D, Dv
    Dp = padded_dim(D, Dv)
    return _kernel.variant(dtype, Dp), Dp, Dp


def _heads_first(t, Dp: int):
    """[B, S, H..., D] -> [B·H..., S, Dp] contiguous, zero past D."""
    B, S, D = t.shape[0], t.shape[1], t.shape[-1]
    heads = t.shape[2:-1]
    perm = (0, *range(2, t.dim() - 1), 1, t.dim() - 1)
    if Dp == D:
        return t.permute(perm).reshape(-1, S, D).contiguous()
    out = t.new_zeros((B, *heads, S, Dp))
    out[..., :D] = t.permute(perm)
    return out.view(-1, S, Dp)


class _Flash(torch.autograd.Function):
    """Forward: ``kernel(q, k, v, **kw)``; backward: the gradient of
    ``plain(q, k, v, **kw)`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, kw, q, k, v):
        o = kernel(q, k, v, **kw)
        if any(ctx.needs_input_grad):      # not when serving
            ctx.save_for_backward(q, k, v)
            ctx.plain = functools.partial(plain, **kw)
        return o

    @staticmethod
    def backward(ctx, go):
        return (None, None, None,
                *plain_vjp(ctx.plain, ctx.saved_tensors, go))


def _device_type(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return q.device.type


def flash_attention_bh(q, k, v, *, causal=True, window=0, scale=None,
                       group=1, q_offset=0):
    """q: [BHq, Sq, D]; k: [BHkv, Skv, D]; v: [BHkv, Skv, Dv] ->
    [BHq, Sq, Dv]; query row ``i`` at key position ``q_offset + i``."""
    refuse_dtensors("flash_attention_bh", q, k, v)
    kw = dict(causal=causal, window=window, scale=scale, group=group,
              q_offset=q_offset)
    if _device_type(q) == "cpu":
        return flash_attention_bh_ref(q, k, v, **kw)
    return _Flash.apply(_kernel.flash_attention_bh_cuda,
                        flash_attention_bh_blocked, kw, q, k, v)


def _flash_cuda(q, k, v, *, causal, window, scale, q_offset):
    """The model layout on the card: one launch of the kernel
    ``kernel_call`` names."""
    B, Sq, Kh, G, D = q.shape
    Dv = v.shape[-1]
    call = kernel_call(q.dtype, D, Dv)
    if call == ("wgmma", D, Dv):
        try:
            qh = q.view(B, Sq, Kh * G, D)
        except RuntimeError as err:
            raise ValueError(
                f"q's kv-head and group dims must merge into one head dim "
                f"without a copy for the wgmma kernel, got strides "
                f"{q.stride()}") from err
        o = _kernel.flash_attention_cuda(qh, k, v, causal=causal,
                                         window=window, scale=scale,
                                         q_offset=q_offset)
        return o.view(B, Sq, Kh, G, Dv)
    Dp = call[1]
    if Dp != D:
        scale = scale if scale is not None else 1.0 / np.sqrt(D)
    o = _kernel.flash_attention_bh_cuda(
        *(_heads_first(t, Dp) for t in (q, k, v)), causal=causal,
        window=window, scale=scale, group=G, q_offset=q_offset)
    return o[..., :Dv].reshape(B, Kh, G, Sq, Dv).permute(0, 3, 1, 2, 4)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    block_kv=1024, q_offset=0):
    """q: [B, Sq, Kh, G, D]; k: [B, Skv, Kh, D]; v: [B, Skv, Kh, Dv] ->
    [B, Sq, Kh, G, Dv]. ``scale`` defaults to 1/sqrt(D); ``block_kv`` is
    the backward's kv block (the model's ``cfg.block_kv``); query row
    ``i`` sits at key position ``q_offset + i`` (a sequence segment's
    queries against its prefix's keys; the backward at the same
    positions)."""
    refuse_dtensors("flash_attention", q, k, v)
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if _device_type(q) == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    return _Flash.apply(
        _flash_cuda,
        functools.partial(flash_attention_blocked, block_kv=block_kv),
        kw, q, k, v)
