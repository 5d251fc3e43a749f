"""Mixture-of-Experts MLP (DBRX, DeepSeek-V2) — the counterpart of
``repro/models/moe.py``.

Top-k softmax router + sort-based capacity dispatch, per batch row:

  1. router scores [S, E] in float32 → top-k (expert ids, gate weights)
     per token, the gates renormalised over the k;
  2. the S·k assignments are sorted by expert id (stably); each
     assignment's rank within its expert's segment is its capacity slot;
  3. tokens gather into an [E, C, d] buffer; an assignment whose slot is
     ≥ C is dropped;
  4. batched per-expert SwiGLU GEMMs [E, B·C, d] × [E, d, f];
  5. results gather back and combine with the gate weights.

``n_shared`` always-on experts (DeepSeek-V2) are one SwiGLU MLP added on
top. The reference leaves all of this to XLA, so it is plain PyTorch here
too: the router, the sort and gathers, and the expert GEMMs
(``torch.bmm``).

In a sharded step whose rules split the MoE over ``model``
(``sharding.local_params``) the tokens are already on every ``model``
rank (``act_batch`` never takes ``model``), so no all-to-all is needed:
each rank routes all of its rows with the whole router (gathered whole,
as a gate is) and computes its part of every token's output, which the
sum over ``model`` adds up. Where ``model`` divides the experts the part
is the rank's experts (expert-parallel): it dispatches only the
assignments to them, into ``[E/m, B, C, d]``, keeping exactly the slots
the unsharded dispatch keeps (a slot is the assignment's rank within its
own expert's segment). Otherwise the rules split each expert's ``d_ff``
over ``model`` and the rank computes every expert on its columns, as the
dense MLP does. The routing is the same on every rank: the gates'
gradient is summed over ``model`` (each gate's from the ranks that
computed its expert) before the float32 router's backward, which every
rank then runs whole, so the router's gradient and the routing path's
part of the input's are the unsharded step's on every rank, not float32
partial sums. The shared expert is the dense tensor-parallel MLP
(``common.mlp_apply``).

With the residual stream split over ``model`` (``seqpar``, ``act2d``)
the tokens enter gathered (``sharding.sublayer_in``: each row's whole
sequence, so the capacity slots are the unsharded dispatch's), every rank
routes them all, and the output leaves as the rank's block
(``sublayer_out``). The gates' gradient is then left as the rank's part:
the router's backward gives each rank a partial sum of the input's and
the router's gradients, which the entry's reduce-scatter and
``_GatherParam``'s sum over ``model`` add up.

Under context parallelism (``sharding.context_parallel``) a row's
sequence is split into segments: the capacity C comes from the whole
sequence's S, and an assignment's slot counts the same expert's
assignments on the earlier segments first (an exclusive prefix over the
segments of the per-expert counts, all-gathered), so each segment keeps
exactly the unsharded dispatch's assignments; each rank computes its
own tokens' rows of the [E, C] buffer.

The dispatch and the combine are gathers, with no scatter of rows:
each buffer slot takes its token's row (a zero row where the slot is
empty), and each token sums its k results weighted by its gates (a zero
row where the assignment was dropped or, under expert parallelism, is
another rank's). The shapes depend on no routing, so nothing waits on
the card, and the backward is the embedding's sum by index.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order among ties, so the top k are taken from a
stable descending sort, which keeps the reference's order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.runtime import sharding


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


def dispatch(ids, top_k: int, n_experts: int, C: int, lo: int = 0,
             hi: int = None, before=None):
    """The capacity dispatch of ``ids`` [B, S, k] to experts ``[lo, hi)``
    (every expert by default): per row's S·k assignments, sorted stably
    by expert id, (sort_idx, keep, local expert index, slot) [B, A]; an
    assignment is kept where its expert is in the range and its slot —
    its rank within its expert's segment, after ``before`` [B, E] (the
    row's assignments to each expert that come earlier: the earlier
    sequence segments') — is below ``C``, so a range's kept assignments
    are the unsharded dispatch's kept assignments to it, and their
    (expert, slot) pairs in a row are distinct."""
    B = ids.shape[0]
    hi = n_experts if hi is None else hi
    A = ids.shape[1] * top_k
    flat_ids = ids.reshape(B, A)
    sort_idx = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, sort_idx)
    experts = torch.arange(n_experts, device=ids.device).expand(B, n_experts)
    seg_starts = torch.searchsorted(sorted_ids, experts.contiguous())
    slot = (torch.arange(A, device=ids.device)
            - torch.gather(seg_starts, 1, sorted_ids))
    if before is not None:
        slot = slot + torch.gather(before, 1, sorted_ids)
    keep = slot < C
    if (lo, hi) != (0, n_experts):
        keep &= (sorted_ids >= lo) & (sorted_ids < hi)
    return sort_idx, keep, sorted_ids - lo, slot


def earlier_counts(ids, n_experts: int, cp):
    """[B, E]: each row's assignments ``ids`` [B, S, k] to each expert on
    the segments before this one (the segments' counts all-gathered)."""
    B = ids.shape[0]
    counts = torch.zeros((B, n_experts), dtype=torch.int64,
                         device=ids.device).scatter_add_(
        1, ids.reshape(B, -1), torch.ones_like(ids.reshape(B, -1)))
    return cp.stack(counts)[:cp.index].sum(0)


def apply(x, p, *, top_k, n_experts, capacity_factor=1.25):
    """x: [B, S, d] → [B, S, d]."""
    experts, tp = sharding.local_params(
        {k: v for k, v in p.items() if k != "shared"})
    x_in = x          # the shared expert's input (and the routing's)
    split = sharding.residual_split() is not None
    x = sharding.sublayer_in(x, tp)
    B, S, d = x.shape
    cp = sharding.context_parallel()
    C = capacity(S * (1 if cp is None else cp.size), top_k, n_experts,
                 capacity_factor)
    gate, ids = route(x if split else x_in, experts["router"], top_k)
    held = experts["wi"].shape[0]             # the rank's experts, or all
    lo = 0 if held == n_experts else tp.rank * held
    sort_idx, keep, e_idx, s_idx = dispatch(
        ids, top_k, n_experts, C, lo, lo + held,
        None if cp is None else earlier_counts(ids, n_experts, cp))
    A, dev = S * top_k, x.device
    rows = torch.arange(B, device=dev)[:, None]
    slots = held * B * C                 # the buffer's rows, then a zero row
    at = torch.where(keep, (e_idx * B + rows) * C + s_idx, slots)
    # Each slot's token (rows of x flattened), B·S (a zero row) where the
    # slot is empty: the kept slots are distinct, and every other
    # assignment writes a place of its own past them.
    src = torch.full((slots + 1 + B * A,), B * S, device=dev)
    spare = slots + 1 + rows * A + torch.arange(A, device=dev)
    src.scatter_(0, torch.where(keep, at, spare).reshape(-1),
                 (rows * S + sort_idx // top_k).reshape(-1))
    xz = torch.cat([x.reshape(B * S, d), x.new_zeros(1, d)])
    h = F.embedding(src[:slots], xz, padding_idx=B * S)

    # [E, B·C, d]: one batched GEMM per product over every row's slots, no
    # copy of the expert weights per row.
    h = h.view(held, B * C, d)
    wi, wg, wo = (experts[k].to(x.dtype) for k in ("wi", "wg", "wo"))
    y = torch.bmm(F.silu(torch.bmm(h, wi)) * torch.bmm(h, wg), wo)

    # Each token's k results in the router's order (the zero row where
    # dropped or another rank's), weighted by its gates and summed.
    back = torch.empty_like(at).scatter_(1, sort_idx, at)
    yz = torch.cat([y.reshape(slots, d), y.new_zeros(1, d)])
    gates = gate.to(x.dtype)
    if tp is not None and not split:
        gates = tp.copy(gates)
    out = sharding.sublayer_out(
        (F.embedding(back.view(B, S, top_k), yz, padding_idx=slots)
         * gates[..., None]).sum(2), tp)
    if "shared" in p:
        out = out + common.mlp_apply(x_in, p["shared"])
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
