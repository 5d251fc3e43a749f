"""Shared model building blocks — the counterpart of
``repro/models/common.py``: parameters with their logical axes,
truncated-normal and fan-in-scaled inits, RMS and layer norm, the gated
MLP, RoPE, the token embedding and logits head over a padded vocabulary,
and the training loss.

Parameter convention
--------------------
Init functions return trees whose leaves are ``P(value, axes)``: the
tensor together with its *logical* sharding axes (e.g. ("embed", "heads",
"head_dim")), the reference's names. ``split_tree`` separates them into
(values, axes); ``runtime/sharding.py`` resolves the axes to mesh specs
and DTensor placements. Value and axes are made in one call, so the two
trees cannot drift. The port keeps per-layer lists where the reference
stacks layers, so the reference's leading ``"layers"`` axis is not on the
port's leaves.

Values are plain tensors in the reference's layouts (a dense weight is
``[in, out]`` and applied as ``x @ W``; attention weights keep
``[d, heads, head_dim]``). ``jax.random`` cannot be reproduced, so inits
draw from a seeded ``torch.Generator``: on the CPU by default, so the same
seed gives the same parameters on the card and on the CPU; or on the card,
with a generator on the card, where a model is too large to draw on the
host (the card's draw is its own stream of numbers). ``META`` stands in
for a generator on the meta device: every init then returns meta tensors
of the right shapes and dtypes, draws nothing and allocates nothing
(``Model.abstract_params``).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.runtime import sharding

_TN_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_TN_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


class P:
    """A parameter (or cache, or input) leaf: tensor + logical axes, one
    name per dimension."""
    __slots__ = ("value", "axes")

    def __init__(self, value, axes: Tuple[str, ...]):
        axes = tuple(axes)
        if len(axes) != value.dim():
            raise ValueError(f"axes {axes} do not name the {value.dim()} "
                             f"dimensions of a {tuple(value.shape)} leaf")
        self.value = value
        self.axes = axes

    def __repr__(self):
        return f"P({tuple(self.value.shape)}, {self.axes})"


def is_param(x) -> bool:
    return isinstance(x, P)


def split_tree(tree):
    """(values, axes) from a tree of P leaves: nested dicts, lists and
    tuples keep their kind; None stays None in both."""
    if isinstance(tree, P):
        return tree.value, tree.axes
    if isinstance(tree, dict):
        pairs = {k: split_tree(v) for k, v in tree.items()}
        return ({k: v for k, (v, _) in pairs.items()},
                {k: a for k, (_, a) in pairs.items()})
    if isinstance(tree, (list, tuple)):
        pairs = [split_tree(v) for v in tree]
        return (type(tree)(v for v, _ in pairs),
                type(tree)(a for _, a in pairs))
    if tree is None:
        return None, None
    raise TypeError(f"not a P leaf: {type(tree).__name__}")


class _MetaGenerator:
    """The stand-in for a generator on the meta device (``torch`` has
    none): inits that get it return meta tensors and draw nothing."""
    device = torch.device("meta")


META = _MetaGenerator()


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2] (the
    reference's ``trunc_normal``), drawn from ``gen`` by inverse CDF on
    the generator's device, returned in ``dtype``. On the CPU the draw is
    float64; on the card it is float32 (a 2.7 B-parameter model would
    otherwise spend minutes of host erfinv and a float64 temporary per
    embedding). With ``META``, an empty meta tensor."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    wide = torch.float64 if gen.device.type == "cpu" else torch.float32
    u = torch.rand(shape, generator=gen, dtype=wide, device=gen.device)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (_TN_LO + u * (_TN_HI - _TN_LO))
                                      - 1.0)
    return (scale * x.clamp(-2.0, 2.0)).to(dtype)


def dense_init(gen: torch.Generator, shape, axes, dtype=torch.float32,
               fan_in=None) -> P:
    """Fan-in-scaled init (the MaxText default)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return P(trunc_normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype), axes)


def zeros_init(shape, axes, dtype=torch.float32, device=None) -> P:
    return P(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones_init(shape, axes, dtype=torch.float32, device=None) -> P:
    return P(torch.ones(shape, dtype=dtype, device=device), axes)


def norm_block(d: int) -> int:
    """The channels a norm's statistic over ``d`` sums in float32 before
    the float64 sum of those sums: the largest power of two dividing
    d / 16, at most 512 (a whole number of blocks on each rank wherever
    ``act2d`` splits d over up to 16 ranks), or d where 16 does not divide
    it. The split norm's statistic then rounds as the whole row's does: a
    float32 sum over the ranks' blocks would round otherwise, by an ulp
    that the float32 SSD and loss carry into the gradients."""
    if d % 16:
        return d
    b = 1
    while b < 512 and (d // 16) % (2 * b) == 0:
        b *= 2
    return b


def _mean(t, tp=None):
    """The mean of float32 ``t`` over its last dimension: ``norm_block``
    sums in float32, their sum in float64, rounded once to float32. With
    ``tp`` the dimension is the rank's block of one split over ``model``:
    the ranks' float64 partial sums are summed over ``model``."""
    n = t.shape[-1]
    d = n * (1 if tp is None else tp.size)
    block = math.gcd(norm_block(d), n)
    s = t.unflatten(-1, (n // block, block)).sum(-1).to(
        torch.float64).sum(-1, keepdim=True)
    if tp is not None:
        s = tp.sum(s)
    return (s / d).to(t.dtype)


def _block(w, tp):
    """The rank's block of a norm's scale or bias with ``tp``."""
    return w if tp is None else w[tp.block(w.shape[0])]


def rms_norm(x, scale, eps=1e-6, tp=None):
    """RMS norm with the reference's ``(1 + scale)`` gain (zero-init scale
    is the identity gain), its mean of squares summed by blocks
    (``_mean``, ``norm_block``). With ``tp`` ``x`` is the rank's block of
    the channels (``act2d``): the mean of squares sums every rank's, and
    the rank applies its block of the scale."""
    xf = x.to(torch.float32)
    var = _mean(torch.square(xf), tp)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + _block(scale, tp).to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5, tp=None):
    """Layer norm; with ``tp`` over the rank's block of the channels, as
    ``rms_norm``."""
    xf = x.to(torch.float32)
    mu = _mean(xf, tp)
    var = _mean(torch.square(xf - mu), tp)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * _block(scale, tp).to(torch.float32)
            + _block(bias, tp).to(torch.float32)).to(x.dtype)


def norm_init(d, kind, dtype, device=None) -> dict:
    if kind == "rmsnorm":
        return dict(scale=zeros_init((d,), ("embed_nosplit",), dtype,
                                     device))
    return dict(scale=ones_init((d,), ("embed_nosplit",), dtype, device),
                bias=zeros_init((d,), ("embed_nosplit",), dtype, device))


def apply_norm(x, p, kind, tp=None):
    """``kind``'s norm of ``x``; ``tp``: ``x`` is the rank's block of the
    channels (``sharding.embed_split``)."""
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"], tp=tp)
    return layer_norm(x, p["scale"], p["bias"], tp=tp)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, dtype) -> dict:
    """Draws in the order wi, wg, wo; either gate takes these weights."""
    return dict(wi=dense_init(gen, (d_model, d_ff), ("embed", "mlp"), dtype),
                wg=dense_init(gen, (d_model, d_ff), ("embed", "mlp"), dtype),
                wo=dense_init(gen, (d_ff, d_model), ("mlp", "embed"), dtype,
                              fan_in=d_ff))


def mlp_apply(x, p, gate="silu"):
    """SwiGLU, or GeGLU with ``gate="gelu"``: ``jax.nn.gelu``'s default,
    the tanh approximation. In a sharded step whose rules split ``mlp``
    over ``model``: ``wi`` and ``wg`` column-parallel on the rank's
    columns, ``wo`` row-parallel, the sum over ``model`` after it (with
    the residual stream split over ``model``, the entry's all-gather and
    the exit's reduce-scatter: ``sharding.sublayer_in`` /
    ``sublayer_out``)."""
    p, tp = sharding.local_params(p)
    x = sharding.sublayer_in(x, tp)
    wi = x @ p["wi"].to(x.dtype)
    act = F.silu(wi) if gate == "silu" else F.gelu(wi, approximate="tanh")
    out = (act * (x @ p["wg"].to(x.dtype))) @ p["wo"].to(x.dtype)
    return sharding.sublayer_out(out, tp)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # torch.full fills on the device; torch.tensor would copy from the
    # host and synchronize the stream on every call.
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Split halves
    (not interleaved), in float32, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [d/2]
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Token embedding + logits head (padded vocab)
# ---------------------------------------------------------------------------

def pad_vocab(vocab: int, multiple: int = 2048) -> int:
    return int(np.ceil(vocab / multiple) * multiple)


def embedding_init(gen, vocab_padded, d_model, dtype, tied=True) -> dict:
    # 1/sqrt(d) rows keep tied logits ~unit-scale at init.
    out = dict(tokens=P(trunc_normal(gen, (vocab_padded, d_model),
                                     1.0 / math.sqrt(d_model), dtype),
                        ("vocab", "embed")))
    if not tied:
        out["head"] = dense_init(gen, (d_model, vocab_padded),
                                 ("embed", "vocab"), dtype)
    return out


def embed_tokens(tokens, p, dtype, tp=None):
    """Each token's row of the table. Vocab-parallel with ``tp`` (the
    table the rank's rows, ``sharding.local_params``): each rank looks up
    the tokens in its range, zeros for the rest, and the sum over
    ``model`` has every row once (with the residual stream split over
    ``model``, the rank's block of that sum: ``sharding.sublayer_out``)."""
    table = p["tokens"].to(dtype)
    if tp is None:
        return table[tokens]
    local = tokens - tp.rank * table.shape[0]
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    return sharding.sublayer_out(torch.where(
        mine[..., None], rows, torch.zeros_like(rows)), tp)


def logits_from_hidden(h, p, true_vocab, dtype, tp=None):
    """Logits over the padded vocabulary, the padded tail set to -1e9 in
    the compute dtype (out of the partition function). With ``tp``: the
    rank's vocabulary rows only (column-parallel), masked by their global
    indices, at every position (the entry gathers a split residual
    stream: ``sharding.sublayer_in``)."""
    table = p.get("head")
    if tp is not None:
        h = sharding.sublayer_in(h, tp)
    if table is None:
        logits = h @ p["tokens"].to(dtype).T
    else:
        logits = h @ table.to(dtype)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    if tp is not None:
        iota = iota + tp.rank * logits.shape[-1]
    return logits.masked_fill(iota >= true_vocab, -1e9)


# The cross-entropy sums its exponentials over blocks of this many
# vocabulary entries, then over the blocks: an order that does not depend
# on how many ranks split the vocabulary, so the vocab-parallel loss (its
# ranks all-gather the block sums, 1/64 of the logits) is bitwise the
# unsharded one. A sum over ranks would round otherwise, and Adam's first
# step carries that into every parameter whose gradient is near eps.
XENT_BLOCK = 64


def softmax_xent(logits, labels, tp=None):
    """Mean cross-entropy in float32. labels: integer, logits' leading
    shape. Vocab-parallel with ``tp`` (``logits`` the rank's block of the
    vocabulary, in rank order): the max over ``model``, the sum of
    exponentials from every rank's ``XENT_BLOCK`` sums, the label's logit
    from the rank that holds it."""
    logits = logits.to(torch.float32)
    big = logits.amax(-1, keepdim=True).detach()
    if tp is not None:
        big = tp.max(big)
    e = torch.exp(logits - big)
    n = e.shape[-1]
    if n % XENT_BLOCK == 0:
        e = e.unflatten(-1, (n // XENT_BLOCK, XENT_BLOCK)).sum(-1)
    if tp is not None:
        e = tp.gather(e, -1)
    lse = big[..., 0] + torch.log(e.sum(-1))
    local = labels.long()
    if tp is not None:
        local = local - tp.rank * n
    mine = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    if tp is not None:
        ll = tp.reduce(torch.where(mine, ll, torch.zeros_like(ll)))
    return torch.mean(lse - ll)
