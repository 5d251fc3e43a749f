"""Public wrapper for the flash-attention kernel, on the model's layout.

``flash_attention`` takes q [B, Sq, Kh, G, D], k [B, Skv, Kh, D] and v
[B, Skv, Kh, Dv] (``models/attention.py``), flattens heads into the
kernel's BH axis (query head ``(b, kh, g)`` reads kv head ``(b, kh)``, so
the kernel's group is G) and, on a CUDA tensor, launches the kernel
(``flash_attention.py``), raising on what it does not take; on a CPU
tensor it takes the plain version (``ref.py``). There is no other path.

Head dims the kernels do not take as they are — v's D unlike q's and k's
(MLA: D_qk 96 / D_v 64 for MiniCPM3, 192 / 128 for DeepSeek-V2), or a D
not in ``HEAD_DIMS`` — are zero-padded to ``padded_dim``: zero columns
appended to q and k leave every q·k unchanged, and zero columns appended
to v give output columns that are sliced off, so one launch at the padded
D computes the reference's function exactly, given the scale of the
unpadded D (1/sqrt(D_qk) unless the caller names one). The cost is the
padded work: (2 Dp) / (D_qk + D_v) times the products the function needs,
1.6x at both MLA shapes, plus one copy of q, k and v into the padded
layout (which the unpadded path makes anyway to put heads first).
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_bh_ref


def padded_dim(D: int, Dv: int) -> int:
    """The smallest kernel head dim (``HEAD_DIMS``) that holds both D and
    Dv; raises above the largest."""
    for Dp in _kernel.HEAD_DIMS:
        if Dp >= max(D, Dv):
            return Dp
    raise ValueError(f"head dims {D} (q, k) and {Dv} (v): no flash kernel "
                     f"takes a head dim above {_kernel.HEAD_DIMS[-1]}")


def _heads_first(t, Dp: int):
    """[B, S, H..., D] -> [B·H..., S, Dp] contiguous, zero past D."""
    B, S, D = t.shape[0], t.shape[1], t.shape[-1]
    heads = t.shape[2:-1]
    perm = (0, *range(2, t.dim() - 1), 1, t.dim() - 1)
    if Dp == D:
        return t.permute(perm).reshape(-1, S, D).contiguous()
    out = t.new_zeros((B, *heads, S, Dp))
    out[..., :D] = t.permute(perm)
    return out.view(-1, S, Dp)


def flash_attention_bh(q, k, v, *, causal=True, window=0, scale=None,
                       group=1):
    """q: [BHq, Sq, D]; k, v: [BHkv, Skv, D] -> [BHq, Sq, D]."""
    if q.device.type == "cuda":
        return _kernel.flash_attention_bh_cuda(
            q, k, v, causal=causal, window=window, scale=scale, group=group)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return flash_attention_bh_ref(q, k, v, causal=causal, window=window,
                                  scale=scale, group=group)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: [B, Sq, Kh, G, D]; k: [B, Skv, Kh, D]; v: [B, Skv, Kh, Dv] ->
    [B, Sq, Kh, G, Dv]. Heads are put first and padded to
    ``padded_dim(D, Dv)`` in one copy; one launch of the kernel
    ``variant`` picks for the padded D (on a CPU tensor the plain version
    on the same padded inputs)."""
    B, Sq, Kh, G, D = q.shape
    Dv = v.shape[-1]
    Dp = padded_dim(D, Dv)
    if Dp != D:
        scale = scale if scale is not None else 1.0 / np.sqrt(D)
    o = flash_attention_bh(*(_heads_first(t, Dp) for t in (q, k, v)),
                           causal=causal, window=window, scale=scale,
                           group=G)
    return o[..., :Dv].reshape(B, Kh, G, Sq, Dv).permute(0, 3, 1, 2, 4)
