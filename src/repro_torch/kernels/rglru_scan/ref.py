"""Plain PyTorch versions of the RG-LRU recurrence, forward and backward:
the counterpart of ``repro/kernels/rglru_scan/ref.py`` (and of the
reference's custom VJP), and what the CUDA kernels are held against."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, bx):
    """a, bx: [B, S, W] (decay / gated input) -> y with
    y_t = a_t * y_{t-1} + bx_t, y_{-1} = 0. A sequential loop over S;
    differentiable through autograd."""
    B, S, W = a.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    ys = []
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1)


def rglru_scan_bwd_ref(a, y, gy):
    """Cotangents of ``rglru_scan_ref`` given its output ``y`` and the
    output cotangent ``gy`` (all [B, S, W]): the reverse recurrence
    g_t = gy_t + a_{t+1} * g_{t+1} (g_S = 0), then da_t = g_t * y_{t-1}
    (y_{-1} = 0) and dbx_t = g_t. Returns (da, dbx)."""
    S = a.shape[1]
    g = torch.zeros_like(gy[:, 0])
    gs = [None] * S
    for t in range(S - 1, -1, -1):
        g = gy[:, t] + (a[:, t + 1] * g if t + 1 < S else 0.0)
        gs[t] = g
    dbx = torch.stack(gs, dim=1)
    y_prev = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], dim=1)
    return dbx * y_prev, dbx
