"""Plain PyTorch versions of the Sinkhorn kernels (log-domain): one fused
iteration, the counterpart of ``repro/kernels/sinkhorn/ref.py``, the
annealed solve as a loop of it, that loop over a leading cell axis, and
the warm-started loop with a per-stage convergence exit. What the CUDA
kernels are held against."""
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


def sinkhorn_solve_adaptive_ref(C, log_a, log_b, g0, tol, eps_table, iters):
    """The warm-started annealed solve with a per-stage convergence exit
    (the rule of the reference's ``jax_solver._sinkhorn_log_adaptive_impl``):
    from f = 0 and g = ``g0``, each stage of ``eps_table`` runs
    ``sinkhorn_iteration_ref`` while fewer than ``iters`` iterations have
    run and the last iteration's float32 ``max |g_new - g|`` is above
    float32 ``tol`` (the first iteration of a stage always runs; a NaN
    change exits). C: [M, N]; g0/log_b: [N]; log_a: [M]. Reads each change
    on the host. Returns (f [M], g [N], iterations run in all as a 0-d
    int32 tensor)."""
    tol32 = torch.tensor(tol, dtype=torch.float32)
    f = torch.zeros_like(log_a)
    g = g0
    used = 0
    for eps in eps_table:
        for _ in range(iters):
            f, g_new = sinkhorn_iteration_ref(C, f, g, log_a, log_b, eps)
            delta = (g_new - g).abs().max()
            g = g_new
            used += 1
            if not bool(delta.cpu() > tol32):
                break
    return f, g, torch.tensor(used, dtype=torch.int32, device=C.device)
