"""Multi-head attention with grouped query heads — the counterpart of
``repro/models/attention.py``.

Every prefill attention — causal or sliding self-attention, the
bidirectional encoder (kind ``full``), cross-attention to image or
encoder K/V (kind ``full``, Sq ≠ Skv) and MLA's (q/k and v of unequal
head dims) — goes through ``prefill_attention``: the hand-written
flash-attention kernel (``kernels/flash_attention``) on a CUDA tensor, in
the place where the TPU ran the Pallas kernel, and the plain blocked twin
``blocked_attention`` on the CPU, so the CPU tests compare like with like.
In training the kernel's wrapper returns the gradient of that blocked
twin, which checkpoints each kv block as the reference does.
Decode attention (one query against the cache) and the projections are
plain PyTorch, as the reference leaves them to XLA. In a sharded decode
whose cache is split by sequence (``runtime/sharding.py``), each rank
attends its segment of the cache and the segments' partial softmaxes are
combined across ranks (``combine_segments``).

Under context parallelism (``runtime/sharding.py``'s
``ContextParallel``: a rank holds segment ``r`` of ``n`` of a sequence)
a layer projects the segment's own Q, K and V at their global positions
(RoPE too) and all-gathers K and V over the segments (its backward a
reduce-scatter: each segment's K and V gradient sums every later
segment's queries' parts). A causal or sliding layer's queries attend the
prefix ``[0, (r+1) S/n)`` at query offset ``r S/n`` — the flash kernel's
offset on the card, the blocked twin's positions on the CPU; the encoder
and cross-attention to the encoder's memory attend every gathered key,
cross-attention to whole image patches its own. A prefill's cache is the
segment's own K and V, placed by ``cache_seq``; a cross-attention's
static cache the gathered memory's.

In a sharded step whose rules split the heads over ``model`` the
sub-layer is tensor-parallel (``sharding.local_params``): each rank
projects its q heads and the kv heads they read (column-parallel),
attends them — through the flash kernel in prefill — and applies its
rows of ``wo`` (row-parallel), and the sum over ``model`` follows. Where
the kv heads do not divide ``model`` their weights are replicated and
each rank slices the ones its q heads read before the product
(``_Heads``); a rank whose q heads straddle two kv groups reads its kv
heads by index, one a q head.

Shapes (canonical): q [B, Sq, Kh, G, D]; k, v [B, Skv, Kh, D] where
Kh = kv heads, G = query-group fan-out (n_heads = Kh·G).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, mask_bias, online_softmax_attention)
from repro_torch.models import common
from repro_torch.models.common import dense_init, zeros_init
from repro_torch.runtime import sharding


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init(gen, d_model, n_heads, n_kv, head_dim, *, qkv_bias=False,
         dtype=torch.float32) -> dict:
    """QKV + output projections (P leaves), drawn in the order wq, wk,
    wv, wo. K/V read a stream of width ``d_model`` (cross-attention's
    too: every config's image patches and encoder frames come at that
    width)."""
    p = dict(
        wq=dense_init(gen, (d_model, n_heads, head_dim),
                      ("embed", "heads", "head_dim"), dtype),
        wk=dense_init(gen, (d_model, n_kv, head_dim),
                      ("embed", "kv_heads", "head_dim"), dtype),
        wv=dense_init(gen, (d_model, n_kv, head_dim),
                      ("embed", "kv_heads", "head_dim"), dtype),
        wo=dense_init(gen, (n_heads, head_dim, d_model),
                      ("heads", "head_dim", "embed"), dtype,
                      fan_in=n_heads * head_dim),
    )
    if qkv_bias:
        dev = gen.device
        p["bq"] = zeros_init((n_heads, head_dim), ("heads", "head_dim"),
                             dtype, dev)
        p["bk"] = zeros_init((n_kv, head_dim), ("kv_heads", "head_dim"),
                             dtype, dev)
        p["bv"] = zeros_init((n_kv, head_dim), ("kv_heads", "head_dim"),
                             dtype, dev)
    return p


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(
        *x.shape[:-1], h, k)


def project_q(x, p, rope_theta, positions):
    """``rope_theta=None`` disables RoPE."""
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if rope_theta is not None:
        q = common.apply_rope(q, positions, rope_theta)
    return q


def project_kv(x, p, rope_theta, positions):
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if rope_theta is not None:
        k = common.apply_rope(k, positions, rope_theta)
    return k, v


def project_out(o, p):
    # o: [B, Sq, H, D]
    h, k, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], h * k) @ p["wo"].to(o.dtype).reshape(
        h * k, d)


# ---------------------------------------------------------------------------
# Scaling
# ---------------------------------------------------------------------------

def _weak_scale(q, scale: float):
    """q * scale as JAX computes it for a weakly typed Python float: the
    scalar is first rounded to q's dtype."""
    return q * torch.full((), scale, dtype=q.dtype, device=q.device)


def _scaled_f32(q, softmax_scale):
    """q * scale as float32, with the reference's promotion: a numpy
    floating scale — its default ``1 / np.sqrt(D)`` (``softmax_scale``
    None) and MLA's ``1 / np.sqrt(d_nope + d_rope)`` — is strongly typed,
    so q goes to float32 before the product with the float32 scale; a
    Python float is weakly typed and scales in q's dtype."""
    if softmax_scale is None:
        softmax_scale = 1.0 / np.sqrt(q.shape[-1])
    if isinstance(softmax_scale, np.floating):
        return q.to(torch.float32) * float(np.float32(softmax_scale))
    return _weak_scale(q, softmax_scale).to(torch.float32)


# ---------------------------------------------------------------------------
# Blocked attention (train / prefill; the plain twin of the kernel)
# ---------------------------------------------------------------------------

def blocked_attention(q, k, v, q_pos, kv_pos, *, kind="causal", window=0,
                      block_kv=1024, softmax_scale=None):
    """Online-softmax attention, KV visited in blocks
    (``online_softmax_attention``, each block checkpointed under grad), q
    scaled with the reference's promotion (``_scaled_f32``).

    q: [B, Sq, Kh, G, D]; k, v: [B, Skv, Kh, D]. Returns [B, Sq, Kh, G, D].
    """
    return online_softmax_attention(
        _scaled_f32(q, softmax_scale), k, v, q_pos, kv_pos, kind=kind,
        window=window, block_kv=block_kv).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention (single query position against a cache)
# ---------------------------------------------------------------------------

def decode_attention(q, cache_k, cache_v, pos, *, kind="causal", window=0,
                     softmax_scale=None, segment=None):
    """q: [B, 1, Kh, G, D]; cache_k/v: [B, Smax, Kh, D]; pos: int — the
    position being generated. The cache already holds this token's own K/V
    at index ``pos``. ``full`` kind attends the whole cache.

    ``segment`` (``runtime.sharding.Segment``, in a sharded decode whose
    cache is split by sequence): the cache holds positions ``[start,
    start + length)`` only, and the ranks holding the others combine
    their partial softmaxes (``combine_segments``)."""
    Smax = cache_k.shape[1]
    start = 0 if segment is None else segment.start
    kv_pos = start + torch.arange(Smax, device=q.device)
    if kind == "full":
        valid = torch.ones((Smax,), dtype=torch.bool, device=q.device)
    else:
        valid = kv_pos <= pos
        if kind == "sliding":
            valid &= kv_pos > pos - window
    s = torch.einsum("bqhgd,bkhd->bhgqk", _scaled_f32(q, softmax_scale),
                     cache_k.to(torch.float32))
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    if segment is None:
        p_ = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bhgqd", p_,
                           cache_v.to(torch.float32))
    else:
        out = combine_segments(s, valid, lambda p_: torch.einsum(
            "bhgqk,bkhd->bhgqd", p_, cache_v.to(torch.float32)), segment)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def combine_segments(s, valid, values, segment):
    """softmax(s) applied to the values across the ranks that hold the
    cache's segments (split-K decoding): s [..., k] float32 scores of this
    rank's segment, ``valid`` [k] its positions in the mask, ``values(p)``
    the unnormalised float32 output of weights p [..., k] (a trailing
    value dimension). Each rank takes its row max m over its valid
    positions, its sum l and output o; M is the all-reduced max and the
    result sum(o e^(m-M)) / sum(l e^(m-M)). A segment with no valid
    position (past ``pos``, or outside a sliding window) has m = -inf
    and weight 0; the owner of ``pos`` always has one, so M is finite and
    no NaN arises."""
    m = torch.where(valid, s, torch.full_like(s, -torch.inf)).amax(
        -1, keepdim=True)
    p_ = torch.where(valid, torch.exp(s - torch.where(
        torch.isfinite(m), m, torch.zeros_like(m))), torch.zeros_like(s))
    big = segment.all_reduce(m.clone(), "max")
    w = torch.exp(m - big)
    ol = segment.all_reduce(torch.cat(
        [values(p_) * w, p_.sum(-1, keepdim=True) * w], dim=-1), "sum")
    return ol[..., :-1] / ol[..., -1:]


def update_cache(cache_k, cache_v, k_new, v_new, pos, segment=None):
    """Write [B, 1, Kh, D] new KV at position ``pos``, in place (the
    reference returns updated copies; the port's caches are owned by the
    caller's decode loop, so writing in place saves a copy per step).
    With a ``segment`` (a sequence-split cache) only the rank that holds
    ``pos`` writes, at its offset in the segment."""
    if segment is not None:
        if not segment.owns(pos):
            return cache_k, cache_v
        pos = pos - segment.start
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


# ---------------------------------------------------------------------------
# Full module forward (used by transformer.py)
# ---------------------------------------------------------------------------

def prefill_attention(q, k, v, *, kind="causal", window=0, block_kv=1024,
                      softmax_scale=None, q_offset=0):
    """Every prefill attention: q [B, Sq, Kh, G, D]; k [B, Skv, Kh, D];
    v [B, Skv, Kh, Dv] (Dv may differ from D: MLA), at q positions
    ``q_offset + arange(Sq)`` and kv positions ``arange(Skv)`` on every
    device (``q_offset``, a sequence segment's first position, is 0 for a
    whole sequence). On a CUDA tensor the flash kernel, causal unless
    ``kind`` is ``"full"`` and windowed only for ``"sliding"``, at that
    offset (under grad its wrapper's backward is ``blocked_attention``'s
    gradient at ``block_kv``); on the CPU ``blocked_attention`` at those
    positions. A causal or sliding call's queries must be the last Sq of
    the keys' positions (q_offset + Sq == Skv: a segment against its
    prefix, or Sq == Skv from 0); any other raises (on either device)
    rather than mis-masks. The scale: a numpy float (MLA's) goes to the
    kernel, which applies it in float32 as the reference promotes; a
    Python float scales q in its own dtype first, as the reference
    does."""
    Sq, Skv = q.shape[1], k.shape[1]
    if kind not in ("causal", "sliding", "full"):
        raise ValueError(kind)
    if kind != "full" and q_offset + Sq != Skv:
        raise ValueError(
            f"a {kind} prefill attention needs its queries at the keys' "
            f"last positions (q_offset + Sq == Skv), got Sq {Sq} at offset "
            f"{q_offset}, Skv {Skv}")
    if kind == "full":
        q_offset = 0
    if q.device.type != "cuda":
        return blocked_attention(
            q, k, v, q_offset + torch.arange(Sq, device=q.device),
            torch.arange(Skv, device=q.device), kind=kind, window=window,
            block_kv=block_kv, softmax_scale=softmax_scale)
    scale = softmax_scale
    if softmax_scale is not None and not isinstance(softmax_scale,
                                                    np.floating):
        q, scale = _weak_scale(q, softmax_scale), 1.0
    return flash_ops.flash_attention(
        q, k, v, causal=kind != "full",
        window=window if kind == "sliding" else 0, scale=scale,
        block_kv=block_kv, q_offset=q_offset)


def segment_keys(kv, Sq: int, kind: str, segmented: bool = True):
    """(the keys and values a prefill's ``Sq`` queries attend, their
    offset) from ``kv``, a tuple of [B, S, ...] tensors projected from
    this rank's positions: as they are, at offset 0, outside context
    parallelism or where they are not ``segmented`` (whole on every
    rank); else gathered over the segments along the sequence and, for a
    causal or sliding ``kind``, cut to the prefix that ends with this
    segment, the queries at offset ``r Sq``."""
    cp = sharding.context_parallel()
    if cp is None or not segmented:
        return kv, 0
    keys = tuple(cp.gather(t, 1) for t in kv)
    if kind == "full":
        return keys, 0
    offset = cp.start(Sq)
    return tuple(t[:, :offset + Sq] for t in keys), offset


class _Heads:
    """The q heads a rank computes and the kv heads they read: q heads
    ``[start, start + n_q)`` of the layer's, over kv heads ``[lo, lo +
    n)``; each kv head serves ``n_q // n`` consecutive q heads, or, where
    the rank's q heads straddle kv groups unevenly, ``index`` (one kv
    head a q head, counted from ``lo``) says which."""

    def __init__(self, p, n_heads: int, n_kv: int, tp):
        self.n_q, kv_held = p["wq"].shape[1], p["wk"].shape[1]
        self.start = 0 if tp is None else tp.rank * self.n_q
        self.index = None
        if tp is None or kv_held != n_kv:
            # every head, or the kv heads split over model with the q
            # heads: the rank's own
            self.lo = 0 if tp is None else tp.rank * kv_held
            self.n = kv_held
            return
        group = n_heads // n_kv
        kv = [(self.start + j) // group for j in range(self.n_q)]
        self.lo, self.n = kv[0], kv[-1] - kv[0] + 1
        if self.n_q % self.n or any(k - self.lo != j // (self.n_q // self.n)
                                    for j, k in enumerate(kv)):
            self.index = [k - self.lo for k in kv]

    @property
    def layout(self) -> tuple:
        """(kv heads, group) of the rank's q as [B, S, kv, group, D]."""
        if self.index is not None:
            return self.n_q, 1
        return self.n, self.n_q // self.n

    def weights(self, p) -> dict:
        """``p`` with the kv projections cut to the kv heads the rank
        reads, where they hold more (replicated over ``model``)."""
        if p["wk"].shape[1] == self.n:
            return p
        cut = slice(self.lo, self.lo + self.n)
        out = dict(p, wk=p["wk"][:, cut], wv=p["wv"][:, cut])
        if "bk" in p:
            out.update(bk=p["bk"][cut], bv=p["bv"][cut])
        return out

    def select(self, t):
        """The rank's kv heads of k or v [B, S, kv, D] holding them, or
        every kv head; one a q head where ``index`` says so."""
        if t.shape[2] != self.n:
            t = t[:, :, self.lo:self.lo + self.n]
        if self.index is None:
            return t
        return t[:, :, torch.tensor(self.index, device=t.device)]


def apply(x, p, *, n_kv, n_heads, positions, kind="causal", window=0,
          rope_theta=10000.0, block_kv=1024, kv_x=None, kv_positions=None,
          softmax_scale=None, cache=None, decode_pos=None, keep_kv=True,
          kv_split=sharding.AS_RESIDUAL):
    """One attention sub-layer. Returns (out, kv).

    Train/prefill (cache=None): x is [B, S, d] at positions
    ``arange(S)`` (the mask's; ``positions`` feeds RoPE); ``kv_x`` ≠ None
    makes it cross-attention (K/V projected from ``kv_x``, RoPE at
    ``kv_positions``; kind should be ``"full"``). Returns the projected
    (k, v): a self-attention prefill keeps them as its cache, a
    cross-attention as its static one. ``keep_kv=False`` (train, the
    encoder) says the caller drops them: a tensor-parallel rank then
    projects only the kv heads its q heads read.
    Decode (cache=(k, v), decode_pos set): x is [B, 1, d].
    Self-attention writes this token's K/V at ``decode_pos`` and attends
    [0, decode_pos]; kind ``"full"`` (cross-attention) attends the static
    (encoder or image) cache without writing it. Returns the cache.

    Tensor-parallel (``sharding.local_params``): the head counts come
    from the rank's blocks; a cache split over ``model`` holds the rank's
    kv heads, a replicated one every kv head (each rank writes them all
    and reads its own). A decode cache split by sequence over ``model``
    itself gathers q over ``model``, attends every head over the rank's
    segment, combines the segments and keeps the rank's heads.

    With the residual stream split over ``model`` (``Layout.split``) ``x``
    is the rank's block and enters gathered (``sharding.sublayer_in``),
    ``kv_x`` too, along ``kv_split`` (by default the residual stream's
    dimension; None where it is whole on every rank, as the image
    patches' sequence is); the output leaves as the rank's block
    (``sublayer_out``).

    Under context parallelism (``sharding.context_parallel``) ``x`` is the
    rank's segment at global ``positions``; K and V are gathered over the
    segments (``kv_x`` too where it is laid out as the residual stream:
    the encoder's memory), a causal or sliding layer attends the prefix
    at its segment's offset, and the K and V returned are the segment's
    own (self-attention: the cache placed by ``cache_seq``) or the
    gathered memory's (cross-attention's static cache).
    """
    p, tp = sharding.local_params(p)
    x = sharding.sublayer_in(x, tp)
    if kv_x is not None:
        kv_x = sharding.sublayer_in(kv_x, tp, kv_split)
    heads = _Heads(p, n_heads, n_kv, tp)
    q = project_q(x, p, rope_theta, positions)
    B, Sq = q.shape[:2]
    if cache is None:
        src = x if kv_x is None else kv_x
        kv_pos = positions if kv_positions is None else kv_positions
        kv = project_kv(src, p if keep_kv else heads.weights(p), rope_theta,
                        kv_pos)
        keys, offset = segment_keys(kv, Sq, kind, kv_x is None
                                    or kv_split == sharding.AS_RESIDUAL)
        if kv_x is not None:
            kv = keys
        out = prefill_attention(q.reshape(B, Sq, *heads.layout, -1),
                                *map(heads.select, keys), kind=kind,
                                window=window, block_kv=block_kv,
                                softmax_scale=softmax_scale, q_offset=offset)
    else:
        kv, segment = cache, None
        if kind != "full":      # static cross caches are never split
            segment = sharding.cache_segment(cache[0].shape[1])
            k, v = project_kv(x, p, rope_theta, positions)
            if k.shape[2] != cache[0].shape[2]:
                # the cache holds every kv head and the rank its block of
                # the weights: a cache split by sequence over model
                k, v = tp.gather(k, 2), tp.gather(v, 2)
            kv = update_cache(*cache, k, v, decode_pos, segment)
        if tp is not None and segment is not None and \
                sharding.MODEL in segment.axes:
            q = tp.gather(q, 2).reshape(B, Sq, n_kv, n_heads // n_kv, -1)
            out = decode_attention(q, *kv, decode_pos, kind=kind,
                                   window=window,
                                   softmax_scale=softmax_scale,
                                   segment=segment).reshape(
                B, Sq, n_heads, -1)[:, :, heads.start:heads.start
                                    + heads.n_q]
        else:
            out = decode_attention(q.reshape(B, Sq, *heads.layout, -1),
                                   *map(heads.select, kv), decode_pos,
                                   kind=kind, window=window,
                                   softmax_scale=softmax_scale,
                                   segment=segment)
    out = project_out(out.reshape(B, Sq, heads.n_q, -1), p)
    return sharding.sublayer_out(out, tp), kv
