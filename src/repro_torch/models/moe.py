"""Mixture-of-Experts MLP (DBRX, DeepSeek-V2) — the counterpart of
``repro/models/moe.py``.

Top-k softmax router + sort-based capacity dispatch, per batch row:

  1. router scores [S, E] in float32 → top-k (expert ids, gate weights)
     per token, the gates renormalised over the k;
  2. the S·k assignments are sorted by expert id (stably); each
     assignment's rank within its expert's segment is its capacity slot;
  3. tokens scatter into an [E, C, d] buffer; an assignment whose slot is
     ≥ C is dropped;
  4. batched per-expert SwiGLU GEMMs [E, B·C, d] × [E, d, f];
  5. results gather back and combine with the gate weights.

``n_shared`` always-on experts (DeepSeek-V2) are one SwiGLU MLP added on
top. The reference leaves all of this to XLA, so it is plain PyTorch here
too: the router, the sort and scatter, and the expert GEMMs
(``torch.bmm``).

Ties: ``jax.lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order among ties, so the top k are taken from a
stable descending sort, which keeps the reference's order.
"""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import dense_init


def init(gen, d_model, d_ff, n_experts, *, n_shared=0, shared_d_ff=None,
         dtype=torch.float32) -> dict:
    """Draws in the order router, wi, wg, wo, shared. The expert weights'
    fan-in is their leading axis, n_experts, as the reference's
    ``dense_init`` takes it."""
    p = dict(router=dense_init(gen, (d_model, n_experts),
                               ("embed", "experts"), dtype),
             wi=dense_init(gen, (n_experts, d_model, d_ff),
                           ("experts", "embed", "mlp"), dtype),
             wg=dense_init(gen, (n_experts, d_model, d_ff),
                           ("experts", "embed", "mlp"), dtype),
             wo=dense_init(gen, (n_experts, d_ff, d_model),
                           ("experts", "mlp", "embed"), dtype, fan_in=d_ff))
    if n_shared:
        p["shared"] = common.mlp_init(gen, d_model,
                                      shared_d_ff or d_ff * n_shared, dtype)
    return p


def capacity(S: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per (row, expert): the reference's Python float arithmetic."""
    return max(int(S * top_k / n_experts * capacity_factor), 1)


def route(x, router, top_k: int):
    """(gate [B, S, k] float32, ids [B, S, k]) of the float32 router."""
    probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[..., :top_k], ids[..., :top_k]
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), ids


def apply(x, p, *, top_k, n_experts, capacity_factor=1.25):
    """x: [B, S, d] → [B, S, d]."""
    B, S, d = x.shape
    C = capacity(S, top_k, n_experts, capacity_factor)
    A = S * top_k                                           # assignments/row
    gate, ids = route(x, p["router"], top_k)

    flat_ids = ids.reshape(B, A)
    sort_idx = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, sort_idx)
    experts = torch.arange(n_experts, device=x.device).expand(B, n_experts)
    seg_starts = torch.searchsorted(sorted_ids, experts.contiguous())
    slot = (torch.arange(A, device=x.device)
            - torch.gather(seg_starts, 1, sorted_ids))
    keep = slot < C
    token_of = sort_idx // top_k
    rows = torch.arange(B, device=x.device)[:, None].expand(B, A)
    e_idx = torch.where(keep, sorted_ids, 0)
    s_idx = torch.where(keep, slot, 0)

    tokens = torch.gather(x, 1, token_of[..., None].expand(B, A, d))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    buf = torch.zeros((n_experts, B, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, rows, s_idx),
                   torch.where(keep[..., None], tokens, zero),
                   accumulate=True)

    # [E, B·C, d]: one batched GEMM per product over every row's slots, no
    # copy of the expert weights per row.
    h = buf.view(n_experts, B * C, d)
    wi, wg, wo = (p[k].to(x.dtype) for k in ("wi", "wg", "wo"))
    y = torch.bmm(torch.nn.functional.silu(torch.bmm(h, wi))
                  * torch.bmm(h, wg), wo).view(n_experts, B, C, d)

    out_sorted = torch.where(keep[..., None], y[e_idx, rows, s_idx], zero)
    gate_sorted = torch.gather(gate.reshape(B, A), 1, sort_idx)
    contrib = out_sorted * gate_sorted[..., None].to(x.dtype)
    out = torch.zeros_like(x).index_put_((rows, token_of), contrib,
                                         accumulate=True)
    if "shared" in p:
        out = out + common.mlp_apply(x, p["shared"])
    return out



def aux_load_balance_loss(logits, ids, n_experts, top_k):
    """Switch-style auxiliary load-balancing loss over T tokens: router
    logits [T, E], expert ids [T, k]. ``Model.loss`` does not add it, as
    the reference's does not."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=0)                                    # [E]
    one_hot = torch.nn.functional.one_hot(ids.long(), n_experts).sum(1)
    ce = one_hot.to(torch.float32).mean(dim=0) / top_k
    return n_experts * torch.sum(me * ce)
