"""Gradient compression for cross-pod sync — the counterpart of
``repro/optim/compression.py``, on trees of tensors.

  int8 stochastic rounding   8x volume reduction; unbiased; stateless.
  top-k + error feedback     k-sparsification with residual accumulation;
                             the residual rides in the train loop's state.

The rounding noise comes from a ``torch.Generator``, not ``jax.random``,
so the int8 payloads differ from the reference's draw for draw (their
distribution and error bound are the same); top-k with error feedback is
deterministic and equals the reference's on the same gradients.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def compress_int8(g, gen: torch.Generator):
    """Per-tensor scale + stochastic-rounded int8 payload; the noise is
    drawn from ``gen``, a generator on ``g``'s device."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    noise = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127).to(
        torch.int8)
    return q, scale


def decompress_int8(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def int8_roundtrip(grads, gen: torch.Generator):
    """Quantize-dequantize the whole gradient tree (what crosses pods),
    leaf by leaf in ``tree_leaves`` order from one generator."""
    out = []
    for g in tree_leaves(grads):
        q, s = compress_int8(g, gen)
        out.append(decompress_int8(q, s, g.dtype))
    return tree_unflatten(grads, out)


def topk_error_feedback(grads, residual, frac: float = 0.01
                        ) -> Tuple[Any, Any]:
    """Keep the top-``frac`` magnitude entries per tensor (every entry at
    or above the k-th largest magnitude); the rest accumulates into
    ``residual`` (error feedback, Stich et al.). Returns (sent, residual);
    ``residual`` None starts from zeros."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)
    sent, res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
        acc = g.to(torch.float32) + r
        k = max(int(acc.numel() * frac), 1)
        thresh = torch.topk(acc.abs().reshape(-1), k).values[-1]
        kept = torch.where(acc.abs() >= thresh, acc, torch.zeros_like(acc))
        sent.append(kept.to(g.dtype))
        res.append(acc - kept)
    return tree_unflatten(grads, sent), tree_unflatten(grads, res)
