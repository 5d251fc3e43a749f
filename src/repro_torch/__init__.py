"""PyTorch / CUDA port of the WaterWise scheduler (the JAX package ``repro``
is the reference).

Module paths mirror the reference: ``repro/core/problem.py`` has its
counterpart in ``repro_torch/core/problem.py``. The port imports neither
``jax`` nor anything of ``repro``; host code that is numpy there stays numpy
here, device work is PyTorch on an explicit ``device``, and the Sinkhorn
inner loop is a hand-written CUDA kernel (``repro_torch.kernels.sinkhorn``).
"""
