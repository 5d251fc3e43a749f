"""Public wrapper for the SSD scan kernel.

``ssd_scan`` on a CUDA tensor launches the kernel (``ssd_scan.py``) and
raises on what it does not take; on a CPU tensor it takes the plain
chunked version (``ref.py``, the model's ``ssd_chunked``) with the same
chunk length. There is no other path.

It is differentiable. On the CPU autograd goes through the plain version.
On a CUDA tensor it is a ``torch.autograd.Function``: the forward is the
kernel, saving its inputs; the backward is the gradient of the plain
chunked version recomputed from them, the algorithm the reference
differentiates (its TPU kernel has no backward).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import plain_vjp, refuse_dtensors
from repro_torch.kernels.ssd_scan import ssd_scan as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_ref


class _Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, chunk, x, dt, A, Bm, Cm):
        y, state = _kernel.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
        if any(ctx.needs_input_grad):      # not when serving
            ctx.save_for_backward(x, dt, A, Bm, Cm)
            ctx.chunk = min(chunk, x.shape[1])
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        plain = functools.partial(ssd_ref, chunk=ctx.chunk)
        return (None, *plain_vjp(plain, ctx.saved_tensors, (gy, gstate)))


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=256):
    """x [b,S,H,P], dt [b,S,H], A [H], Bm/Cm [b,S,G,N] ->
    (y [b,S,H,P], final state [b,H,P,N]) in x's dtype; chunks of
    ``min(chunk, S)`` rows."""
    refuse_dtensors("ssd_scan", x, dt, A, Bm, Cm)
    if x.device.type == "cuda":
        return _Scan.apply(chunk, x, dt, A, Bm, Cm)
    if x.device.type != "cpu":
        raise ValueError(f"no SSD scan kernel for device {x.device}")
    return ssd_ref(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1]))
