"""Plain PyTorch versions of the Sinkhorn kernels (log-domain): one fused
iteration, the counterpart of ``repro/kernels/sinkhorn/ref.py``, the
annealed solve as a loop of it, and that loop over a leading cell axis.
What the CUDA kernels are held against."""
from __future__ import annotations

import torch


def sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps):
    """One (f, g) update pair. C: [..., M, N]; f/log_a: [..., M]; g/log_b:
    [..., N]; leading axes are independent cells."""
    f_new = eps * (log_a - torch.logsumexp((g[..., None, :] - C) / eps,
                                           dim=-1))
    g_new = eps * (log_b - torch.logsumexp((f_new[..., :, None] - C) / eps,
                                           dim=-2))
    return f_new, g_new


def sinkhorn_solve_ref(C, log_a, log_b, eps_table, iters):
    """``iters`` iterations at each eps of ``eps_table`` in turn, from
    f = g = 0. C: [..., M, N]. Returns (f [..., M], g [..., N])."""
    f = torch.zeros(C.shape[:-1], dtype=torch.float32, device=C.device)
    g = torch.zeros(C.shape[:-2] + C.shape[-1:], dtype=torch.float32,
                    device=C.device)
    for eps in eps_table:
        for _ in range(iters):
            f, g = sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps)
    return f, g


def sinkhorn_solve_batched_ref(C, log_a, log_b, eps_table, iters):
    """The annealed solve of B cells at once: C [B, M, N], log_a [B, M],
    log_b [B, N]; returns (f [B, M], g [B, N]). Each cell's result is
    bitwise ``sinkhorn_solve_ref`` on that cell on the CPU (the reductions
    run within a cell, held so in tests/test_torch_sinkhorn.py)."""
    if C.dim() != 3:
        raise ValueError(f"C must be [B, M, N], got shape {tuple(C.shape)}")
    return sinkhorn_solve_ref(C, log_a, log_b, eps_table, iters)
