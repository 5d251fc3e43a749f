"""Public wrappers for the SSD scan kernels.

``ssd_scan`` on a CUDA tensor launches the kernel (``ssd_scan.py``) and
raises on what it does not take; on a CPU tensor it takes the plain
chunked version (``ref.py``, the model's ``ssd_chunked``) with the same
chunk length. There is no other path. It starts from ``h0``, the state
entering the first chunk (float32), where it is given.

It is differentiable. On the CPU autograd goes through the plain version.
On a CUDA tensor it is a ``torch.autograd.Function``: the forward is the
kernel, saving its inputs; the backward is the gradient of the plain
chunked version recomputed from them (``h0``'s too), the algorithm the
reference differentiates (its TPU kernel has no backward).

``ssd_final`` is the final state from zero in the plain SSD's work dtype,
and no y: the kernels' entry ``ssd_final_cuda`` on the card (forward
only, as the launchers are: its caller, the context-parallel segment's
scan ``models.ssm._SegmentScan``, differentiates the segment whole), the
plain ``ssd_final_ref`` on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import plain_vjp, refuse_dtensors
from repro_torch.kernels.ssd_scan import ssd_scan as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_final_ref, ssd_ref


def _plain_scan(x, dt, A, Bm, Cm, h0=None, *, chunk):
    return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, init_state=h0)


class _Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, chunk, x, dt, A, Bm, Cm, h0=None):
        # h0 only where given: the call from zero is the one it ever was.
        kw = {} if h0 is None else dict(h0=h0)
        y, state = _kernel.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, **kw)
        if any(ctx.needs_input_grad):      # not when serving
            ctx.save_for_backward(x, dt, A, Bm, Cm,
                                  *(() if h0 is None else (h0,)))
            ctx.chunk = min(chunk, x.shape[1])
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        plain = functools.partial(_plain_scan, chunk=ctx.chunk)
        grads = plain_vjp(plain, saved, (gy, gstate))
        return (None, *grads, *((None,) if len(saved) == 5 else ()))


def _device(where, x, *tensors) -> None:
    refuse_dtensors(where, x, *tensors)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no SSD scan kernel for device {x.device}")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk=256, h0=None):
    """x [b,S,H,P], dt [b,S,H], A [H], Bm/Cm [b,S,G,N], h0 [b,H,P,N]
    float32 or None (zero) -> (y [b,S,H,P], final state [b,H,P,N]) in x's
    dtype; chunks of ``min(chunk, S)`` rows."""
    _device("ssd_scan", x, dt, A, Bm, Cm,
            *(() if h0 is None else (h0,)))
    if x.device.type == "cuda":
        return _Scan.apply(chunk, x, dt, A, Bm, Cm, h0)
    return ssd_ref(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1]),
                   init_state=h0)


def ssd_final(x, dt, A, Bm, Cm, *, chunk=256):
    """The final state [b,H,P,N] of ``ssd_scan`` from a zero state, in
    float32 (float64 for float64 inputs on the CPU), without forming y:
    the inputs as ``ssd_scan`` takes them."""
    _device("ssd_final", x, dt, A, Bm, Cm)
    if x.device.type == "cuda":
        return _kernel.ssd_final_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_final_ref(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1]))
