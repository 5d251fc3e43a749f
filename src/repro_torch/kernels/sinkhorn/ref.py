"""Plain PyTorch versions of the Sinkhorn kernels (log-domain): one fused
iteration, the counterpart of ``repro/kernels/sinkhorn/ref.py``, and the
annealed solve as a loop of it. What the CUDA kernels are held against."""
from __future__ import annotations

import torch


def sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps):
    """One (f, g) update pair. C: [M, N]; f/log_a: [M]; g/log_b: [N]."""
    f_new = eps * (log_a - torch.logsumexp((g[None, :] - C) / eps, dim=1))
    g_new = eps * (log_b - torch.logsumexp((f_new[:, None] - C) / eps,
                                           dim=0))
    return f_new, g_new


def sinkhorn_solve_ref(C, log_a, log_b, eps_table, iters):
    """``iters`` iterations at each eps of ``eps_table`` in turn, from
    f = g = 0. Returns (f [M], g [N])."""
    f = torch.zeros(C.shape[0], dtype=torch.float32, device=C.device)
    g = torch.zeros(C.shape[1], dtype=torch.float32, device=C.device)
    for eps in eps_table:
        for _ in range(iters):
            f, g = sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps)
    return f, g
