"""PyTorch / CUDA port of the WaterWise scheduler (the JAX package ``repro``
is the reference).

Module paths mirror the reference: ``repro/core/problem.py`` has its
counterpart in ``repro_torch/core/problem.py``. The port imports neither
``jax`` nor anything of ``repro``; host code that is numpy there stays numpy
here, device work is PyTorch on an explicit ``device``, and every Pallas
kernel of the reference is a hand-written CUDA kernel
(``repro_torch.kernels``). Besides the scheduler it serves the reference's
``decoder`` LMs (``repro_torch.runtime.serve_loop``).
"""
