"""Hand-written Hopper kernels, one directory each, on the reference's
layout (``repro/kernels/<name>/``):

  <name>.py   the ctypes binding and launch wrapper of ``csrc/<name>.cu``
              (built with ``nvcc`` for ``sm_90a`` at first use, see
              ``_build.py``), with a launch counter
  ops.py      public wrapper: a CUDA tensor launches the kernel, a CPU
              tensor takes the plain version; differentiable (a kernel
              with no backward of its own returns its plain version's
              gradient, ``plain_vjp``)
  ref.py      the plain PyTorch version the kernel is held against

Kernels: sinkhorn (the scheduler's entropic-OT inner loop), rglru_scan
(the learned forecaster's linear recurrence, forward and backward),
flash_attention (LM prefill and training attention) and ssd_scan (the
Mamba-2 prefill's and training's chunked scan).
"""
from __future__ import annotations

import torch


def plain_vjp(plain, inputs, grad_outputs) -> tuple:
    """The gradients of ``plain(*inputs)`` against ``inputs`` for the
    output cotangents ``grad_outputs``, by autograd through ``plain``
    recomputed from detached copies of ``inputs``: the backward of a
    kernel whose TPU original has none, as the reference differentiates
    the plain algorithm."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(plain(*live), live, grad_outputs)
