"""Hand-written Hopper kernels, one directory each, on the reference's
layout (``repro/kernels/<name>/``):

  <name>.py   the ctypes binding and launch wrapper of ``csrc/<name>.cu``
              (built with ``nvcc`` for ``sm_90a`` at first use, see
              ``_build.py``), with a launch counter
  ops.py      public wrapper: a CUDA tensor launches the kernel, a CPU
              tensor takes the plain version
  ref.py      the plain PyTorch version the kernel is held against

Kernels: sinkhorn (the scheduler's entropic-OT inner loop), rglru_scan
(the learned forecaster's linear recurrence, forward and backward),
flash_attention (LM prefill self-attention) and ssd_scan (the Mamba-2
prefill's chunked scan).
"""
