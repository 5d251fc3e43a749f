"""Hand-written Hopper kernels, one directory each, on the reference's
layout (``repro/kernels/<name>/``):

  <name>.py   the ctypes binding and launch wrapper of ``csrc/<name>.cu``
              (built with ``nvcc`` for ``sm_90a`` at first use, see
              ``_build.py``), with a launch counter
  ops.py      public wrapper: a CUDA tensor launches the kernel, a CPU
              tensor takes the plain version; differentiable (a kernel
              with no backward of its own returns its plain version's
              gradient, ``plain_vjp``); a DTensor is refused
              (``refuse_dtensors``): kernels take each rank's local
              tensors
  ref.py      the plain PyTorch version the kernel is held against

Kernels: sinkhorn (the scheduler's entropic-OT inner loop), rglru_scan
(the learned forecaster's linear recurrence, forward and backward),
flash_attention (LM prefill and training attention) and ssd_scan (the
Mamba-2 prefill's and training's chunked scan).
"""
from __future__ import annotations

import torch

from repro_torch.runtime.sharding import is_dtensor


def refuse_dtensors(where: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a DTensor. A kernel
    (and its plain version) computes on one device's memory: the sharded
    step gathers a layer's parameters first and hands the kernels local
    tensors, so a DTensor here is a caller's mistake, never something to
    launch through ``ctypes`` or to send to the plain version."""
    for t in tensors:
        if is_dtensor(t):
            raise TypeError(
                f"{where} takes local tensors, got a DTensor "
                f"{tuple(t.shape)} placed {tuple(t.placements)}: gather "
                f"it (full_tensor) or pass its to_local() block")


def plain_vjp(plain, inputs, grad_outputs) -> tuple:
    """The gradients of ``plain(*inputs)`` against ``inputs`` for the
    output cotangents ``grad_outputs``, by autograd through ``plain``
    recomputed from detached copies of ``inputs``: the backward of a
    kernel whose TPU original has none, as the reference differentiates
    the plain algorithm."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(plain(*live), live, grad_outputs)
