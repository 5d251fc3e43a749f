"""Public wrapper for the flash-attention kernel, on the model's layout.

``flash_attention`` takes q [B, Sq, Kh, G, D] and k, v [B, Skv, Kh, D]
(``models/attention.py``), flattens heads into the kernel's BH axis
(query head ``(b, kh, g)`` reads kv head ``(b, kh)``, so the kernel's
group is G) and, on a CUDA tensor, launches the kernel
(``flash_attention.py``), raising on what it does not take; on a CPU
tensor it takes the plain version (``ref.py``). There is no other path.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_bh_ref


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
    """q: [B, Sq, Kh, G, D]; k, v: [B, Skv, Kh, D] -> [B, Sq, Kh, G, D]."""
    B, Sq, Kh, G, D = q.shape
    Skv = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * Kh * G, Sq, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * Kh, Skv, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * Kh, Skv, D)
    o = flash_attention_bh(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                           causal=causal, window=window, scale=scale,
                           group=G)
    return o.reshape(B, Kh, G, Sq, D).permute(0, 3, 1, 2, 4)
