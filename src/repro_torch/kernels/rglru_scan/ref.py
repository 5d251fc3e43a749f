"""Plain PyTorch versions of the RG-LRU recurrence: the gate math, the
scan forward and backward, the fused layer (gates then scan), and a twin
of the kernels' chunk order. The counterpart of ``repro/kernels/
rglru_scan/ref.py`` (and of the reference's custom VJP and
``repro/models/rglru.py::_gates``), and what the CUDA kernels are held
against."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.numerics import softplus

_C = 8.0  # Griffin's fixed constant


def rglru_gates(pre_r, pre_i, x, lam):
    """(a, gated input) of the recurrence, both [B, S, W] float32, from the
    gate pre-activations pre_r = x W_a + b_a and pre_i = x W_x + b_x, the
    input x and the decay parameter lam [W] — ``repro/models/rglru.py::
    _gates`` after its two matmuls."""
    r = torch.sigmoid(pre_r)
    i = torch.sigmoid(pre_i)
    log_a = -_C * softplus(lam) * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * x)
    return a, gated_x


def rglru_layer_ref(pre_r, pre_i, x, lam):
    """The fused layer's function: ``rglru_scan_ref`` over
    ``rglru_gates``; differentiable through autograd."""
    return rglru_scan_ref(*rglru_gates(pre_r, pre_i, x, lam))


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


def rglru_scan_chunked_ref(a, bx, chunk: int, chunks_per_tile: int = 8):
    """``rglru_scan_ref`` in the kernels' order (``csrc/rglru_scan.cu``):
    time in tiles of ``chunks_per_tile`` chunks of ``chunk`` steps. In a
    tile every chunk scans its steps from zero, keeping (P, h) = (prod a,
    local end); chunk c's carry folds the pairs of the chunks before it
    onto the tile's carry with the reference's combine, P * carry + h; each
    chunk rescans from its carry; the tile's last step carries into the
    next tile. Steps past S read as zero, as the kernel's zero-filled
    staging does. a, bx: [B, S, W] -> y [B, S, W]."""
    B, S, W = a.shape
    L, NC = int(chunk), int(chunks_per_tile)
    TS = L * NC
    nt = -(-S // TS)
    pad = nt * TS - S
    a_t = F.pad(a, (0, 0, 0, pad)).reshape(B, nt, NC, L, W)
    b_t = F.pad(bx, (0, 0, 0, pad)).reshape(B, nt, NC, L, W)
    ys = []
    carry = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for k in range(nt):
        A, X = a_t[:, k], b_t[:, k]                       # [B, NC, L, W]
        h = torch.zeros((B, NC, W), dtype=torch.float32, device=a.device)
        P = torch.ones_like(h)
        for j in range(L):
            h = A[:, :, j] * h + X[:, :, j]
            P = P * A[:, :, j]
        carries = []
        c = carry
        for cc in range(NC):
            carries.append(c)
            c = P[:, cc] * c + h[:, cc]
        h = torch.stack(carries, dim=1)
        tile = []
        for j in range(L):
            h = A[:, :, j] * h + X[:, :, j]
            tile.append(h)
        carry = h[:, -1]
        ys.append(torch.stack(tile, dim=2).reshape(B, TS, W))
    return torch.cat(ys, dim=1)[:, :S]
