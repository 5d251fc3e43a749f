"""Plain PyTorch attention: the counterpart of
``repro/kernels/flash_attention/ref.py``, and what the CUDA kernel is held
against; and the blocked online softmax (``online_softmax_attention``,
the reference's ``models/attention.py::blocked_attention`` loop) that the
model runs on the CPU and whose gradient the kernel wrappers return
(``ops.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                  q_offset=0):
    """q: [BH, Sq, D]; k: [BH, Skv, D]; v: [BH, Skv, Dv] (kv heads already
    expanded). float32 softmax attention over the whole score matrix, query
    row ``i`` at key position ``q_offset + i`` (a sequence segment's
    queries against its prefix's keys)."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * float(np.float32(scale))
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
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
                           group=1, q_offset=0):
    """The kernel's function on its layout: q [BHq, Sq, D], k [BHkv, Skv,
    D] and v [BHkv, Skv, Dv], head ``h`` attending kv head ``h //
    group``."""
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                        q_offset=0):
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
                      causal=causal, window=window, scale=scale,
                      q_offset=q_offset)
    return o.view(B, Kh, G, Sq, Dv).permute(0, 3, 1, 2, 4)


def mask_bias(q_pos, kv_pos, kind: str, window: int):
    """Additive mask bias [Sq, bk] from position vectors (kv position -1
    is padding)."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    valid = kp >= 0
    if kind == "causal":
        valid = valid & (kp <= qp)
    elif kind == "sliding":
        valid = valid & (kp <= qp) & (qp - kp < window)
    elif kind == "full":
        pass
    else:
        raise ValueError(kind)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def _kv_block(qf, kc, vc, bias, acc, m, l):
    """One kv block of the online softmax: (acc, m, l) updated by the
    scores of float32 ``qf`` against block ``kc``, ``vc`` under ``bias``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.to(torch.float32))
    s = s + bias[None, None, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p_ = torch.exp(s - m_new[..., None])
    l = l * alpha + p_.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p_,
                                                vc.to(torch.float32))
    return acc, m_new, l


def online_softmax_attention(qf, k, v, q_pos, kv_pos, *, kind="causal",
                             window=0, block_kv=1024):
    """Online-softmax attention, kv visited in blocks of ``block_kv`` under
    ``mask_bias``: qf [B, Sq, Kh, G, D] float32, already scaled; k
    [B, Skv, Kh, D]; v [B, Skv, Kh, Dv] -> float32 [B, Sq, Kh, G, Dv].
    Under grad each block is checkpointed, as the reference's scan body
    is: the backward recomputes a block's scores instead of saving them,
    so a call keeps O(Sq·D) per block for its backward, not
    [B, H, Sq, Skv]."""
    B, Sq, Kh, G, D = qf.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    bk = min(block_kv, Skv)
    nblk = math.ceil(Skv / bk)
    pad = nblk * bk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    acc = torch.zeros((B, Kh, G, Sq, Dv), dtype=torch.float32,
                      device=qf.device)
    m = torch.full((B, Kh, G, Sq), NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros((B, Kh, G, Sq), dtype=torch.float32, device=qf.device)
    remat = torch.is_grad_enabled()
    for i in range(nblk):
        blk = (qf, k[:, i * bk:(i + 1) * bk], v[:, i * bk:(i + 1) * bk],
               mask_bias(q_pos, kv_pos[i * bk:(i + 1) * bk], kind, window),
               acc, m, l)
        if remat:
            acc, m, l = checkpoint(_kv_block, *blk, use_reentrant=False)
        else:
            acc, m, l = _kv_block(*blk)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)


def flash_attention_blocked(q, k, v, *, causal=True, window=0, scale=None,
                            block_kv=1024, q_offset=0):
    """The kernel's function on the model layout (q [B, Sq, Kh, G, D], k
    [B, Skv, Kh, D], v [B, Skv, Kh, Dv]) by ``online_softmax_attention``
    at q positions ``q_offset + arange(Sq)`` and kv positions
    ``arange(Skv)``, the algorithm the reference differentiates.
    The scale (1/sqrt(D) unless given) is applied in float32, as the
    kernel applies it."""
    if not causal and window:
        raise ValueError("a windowed flash call must be causal")
    Sq, Skv, D = q.shape[1], k.shape[1], q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(D) if scale is None else scale)
    return online_softmax_attention(
        q.to(torch.float32) * float(scale), k, v,
        q_offset + torch.arange(Sq, device=q.device),
        torch.arange(Skv, device=q.device),
        kind="full" if not causal else "sliding" if window else "causal",
        window=window, block_kv=block_kv).to(q.dtype)


def flash_attention_bh_blocked(q, k, v, *, causal=True, window=0,
                               scale=None, group=1, block_kv=1024,
                               q_offset=0):
    """``flash_attention_blocked`` on the kernel's layout: q [BHq, Sq, D],
    k [BHkv, Skv, D], v [BHkv, Skv, Dv], head ``h`` attending kv head
    ``h // group`` — viewed as the model layout with one kv head a row."""
    BHq, Sq, D = q.shape
    qm = q.view(BHq // group, group, Sq, D).permute(0, 2, 1, 3)[:, :, None]
    o = flash_attention_blocked(qm, k[:, :, None], v[:, :, None],
                                causal=causal, window=window, scale=scale,
                                block_kv=block_kv, q_offset=q_offset)
    return o[:, :, 0].permute(0, 2, 1, 3).reshape(BHq, Sq, -1)

