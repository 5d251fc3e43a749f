"""Plain PyTorch attention: the counterpart of
``repro/kernels/flash_attention/ref.py``, and what the CUDA kernel is held
against."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: [BH, Sq, D]; k: [BH, Skv, D]; v: [BH, Skv, Dv] (kv heads already
    expanded). float32 softmax attention over the whole score matrix."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * float(np.float32(scale))
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kp <= qp
    if window:
        valid &= qp - kp < window
    s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)


def flash_attention_bh_ref(q, k, v, *, causal=True, window=0, scale=None,
                           group=1):
    """The kernel's function on its layout: q [BHq, Sq, D], k [BHkv, Skv,
    D] and v [BHkv, Skv, Dv], head ``h`` attending kv head ``h //
    group``."""
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """The kernel's function on the model layout, unpadded: q [B, Sq, Kh,
    G, D], k [B, Skv, Kh, D], v [B, Skv, Kh, Dv] -> [B, Sq, Kh, G, Dv], at
    any strides; query head ``(kh, g)`` attends kv head ``kh``."""
    B, Sq, Kh, G, D = q.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    o = attention_ref(q.permute(0, 2, 3, 1, 4).reshape(-1, Sq, D),
                      k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                      .reshape(-1, Skv, D),
                      v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                      .reshape(-1, Skv, Dv),
                      causal=causal, window=window, scale=scale)
    return o.view(B, Kh, G, Sq, Dv).permute(0, 3, 1, 2, 4)
