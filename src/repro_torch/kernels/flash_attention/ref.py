"""Plain PyTorch attention: the counterpart of
``repro/kernels/flash_attention/ref.py``, and what the CUDA kernel is held
against."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: [BH, Sq, D]; k, v: [BH, Skv, D] (kv heads already expanded).
    float32 softmax attention over the whole score matrix."""
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
    """The kernel's function on its layout: q [BHq, Sq, D], k and v
    [BHkv, Skv, D], head ``h`` attending kv head ``h // group``."""
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
