"""PyTorch / CUDA port of the WaterWise scheduler (the JAX package ``repro``
is the reference).

Module paths mirror the reference: ``repro/core/problem.py`` has its
counterpart in ``repro_torch/core/problem.py``. The port imports neither
``jax`` nor anything of ``repro``; host code that is numpy there stays numpy
here, device work is PyTorch on an explicit ``device``, and every Pallas
kernel of the reference is a hand-written CUDA kernel
(``repro_torch.kernels``). The scheduler replays traces
(``repro_torch.sim``, ``repro_torch.experiments``), runs as a live service
(``repro_torch.serve``: arrival streams, bounded admission, the decision
loop with the warm-started Sinkhorn carry) and schedules workflow DAGs
(``repro_torch.workflows``). Besides the scheduler it serves the
reference's ``decoder`` LMs (``repro_torch.runtime.serve_loop``).
"""
