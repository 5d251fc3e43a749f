"""Plain PyTorch version of one fused Sinkhorn iteration (log-domain): the
counterpart of ``repro/kernels/sinkhorn/ref.py``, and what the CUDA kernel
is held against."""
from __future__ import annotations

import torch


def sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps):
    """One (f, g) update pair. C: [M, N]; f/log_a: [M]; g/log_b: [N]."""
    f_new = eps * (log_a - torch.logsumexp((g[None, :] - C) / eps, dim=1))
    g_new = eps * (log_b - torch.logsumexp((f_new[:, None] - C) / eps,
                                           dim=0))
    return f_new, g_new
