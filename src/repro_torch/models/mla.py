"""Multi-head Latent Attention (DeepSeek-V2, MiniCPM3) — the counterpart
of ``repro/models/mla.py``.

KV is compressed into a low-rank latent c_kv (kv_lora) plus one shared
RoPE key head (d_rope). The prefill expands the latent to per-head K/V
(MHA: Kh = H, G = 1) and runs the prefill attention of
``models/attention.py``: the flash kernel on a CUDA tensor, which takes
q/k at D_qk = d_nope + d_rope and v at d_v by zero-padding both to one of
its head dims (``kernels/flash_attention/ops.py``), and the plain blocked
attention on the CPU. Decode uses the absorbed form over the compressed
cache [B, S, kv_lora] + [B, S, d_rope] (W^UK folded into the query, W^UV
into the output), in plain PyTorch, as the reference leaves it to XLA;
over a cache split by sequence it combines the segments across ranks as
``attention.decode_attention`` does.

In a sharded step whose rules split the heads over ``model`` the
sub-layer is tensor-parallel (``sharding.local_params``): every rank
computes the latents (c_kv, k_rope) and the query latent whole from the
replicated ``wq_a`` / ``wkv_a`` (their gradients summed over ``model``),
expands q, k_nope and v for its own heads only through its blocks of
``wq_b`` (or ``wq``), ``wkv_b_k`` and ``wkv_b_v``, attends them — through
the flash kernel in prefill — and applies its rows of ``wo``; the sum
over ``model`` follows. The latent cache has no ``model`` axis: every
rank writes it whole and reads it whole. Where the cache is split by
sequence over ``model`` too (``seqshard``), q is gathered over ``model``,
every head attends the rank's segment, the segments are combined and
the rank keeps its heads, as ``models/attention.py`` does.

Under context parallelism (``sharding.context_parallel``) a rank's
segment computes its own latents at their global positions, all-gathers
the latents (c_kv, k_rope) over the segments — [S, kv_lora + d_rope] a
row, where the expanded K and V would be heads × (D_qk + D_v) — and
expands the prefix that ends with its segment into its heads' K and V;
its queries attend them at the segment's offset. The prefill's cache is
the segment's own latents, placed by ``cache_seq``.

RoPE runs at the default base 1e4 in both places, as the reference calls
it without the config's ``rope_theta``. The softmax scale is the
reference's ``1 / np.sqrt(d_nope + d_rope)``, a numpy float64, which
promotes a bf16 q to float32 before the product (``attention._scaled_f32``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention, common
from repro_torch.models.attention import _project
from repro_torch.models.common import apply_norm, dense_init, norm_init
from repro_torch.runtime import sharding


def init(gen, d_model, n_heads, *, q_lora, kv_lora, d_nope, d_rope, d_v,
         dtype=torch.float32) -> dict:
    """Draws in the order wkv_a, wkv_b_k, wkv_b_v, wo, then wq_a and wq_b
    (or wq without a query latent)."""
    dev = gen.device
    p = dict(
        wkv_a=dense_init(gen, (d_model, kv_lora + d_rope),
                         ("embed", "mla_latent"), dtype),
        kv_norm=norm_init(kv_lora, "rmsnorm", dtype, dev),
        wkv_b_k=dense_init(gen, (kv_lora, n_heads, d_nope),
                           ("mla_latent", "heads", "head_dim"), dtype),
        wkv_b_v=dense_init(gen, (kv_lora, n_heads, d_v),
                           ("mla_latent", "heads", "head_dim"), dtype),
        wo=dense_init(gen, (n_heads, d_v, d_model),
                      ("heads", "head_dim", "embed"), dtype,
                      fan_in=n_heads * d_v),
    )
    if q_lora:
        p["wq_a"] = dense_init(gen, (d_model, q_lora),
                               ("embed", "mla_latent"), dtype)
        p["q_norm"] = norm_init(q_lora, "rmsnorm", dtype, dev)
        p["wq_b"] = dense_init(gen, (q_lora, n_heads, d_nope + d_rope),
                               ("mla_latent", "heads", "head_dim"), dtype)
    else:
        p["wq"] = dense_init(gen, (d_model, n_heads, d_nope + d_rope),
                             ("embed", "heads", "head_dim"), dtype)
    return p


def _queries(x, p, d_nope, positions):
    if "wq_a" in p:
        cq = apply_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], "rmsnorm")
        q = _project(cq, p["wq_b"])
    else:
        q = _project(x, p["wq"])
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    return q_nope, common.apply_rope(q_rope, positions)


def latent(x, p, kv_lora, positions):
    """(c_kv [B, S, kv_lora], k_rope [B, S, d_rope]): the decode cache's
    entries for ``x`` at ``positions``."""
    ckr = x @ p["wkv_a"].to(x.dtype)
    c_kv, k_rope = ckr[..., :kv_lora], ckr[..., kv_lora:]
    c_kv = apply_norm(c_kv, p["kv_norm"], "rmsnorm")
    k_rope = common.apply_rope(k_rope[:, :, None, :], positions)[:, :, 0]
    return c_kv, k_rope


def apply(x, p, *, n_heads, q_lora, kv_lora, d_nope, d_rope, d_v,
          positions, block_kv=1024, cache=None, decode_pos=None):
    """Returns (out, cache). Prefill (cache=None): x [B, S, d] at positions
    ``arange(S)``; the cache returned is the latents (c_kv, k_rope) it
    computed, which the reference recomputes to the same values. Decode
    (cache=(c_kv [B, Smax, kv_lora], k_rope [B, Smax, d_rope])): x
    [B, 1, d]; writes this token's latents at ``decode_pos`` in place and
    attends [0, decode_pos]."""
    p, tp = sharding.local_params(p)
    x = sharding.sublayer_in(x, tp)
    heads = p["wkv_b_k"].shape[1]                      # the rank's
    B, Sq, _ = x.shape
    scale = 1.0 / np.sqrt(d_nope + d_rope)            # a numpy float64
    q_nope, q_rope = _queries(x, p, d_nope, positions)
    c_new, r_new = latent(x, p, kv_lora, positions)

    if cache is None:
        (c_kv, k_rope), offset = attention.segment_keys((c_new, r_new), Sq,
                                                        "causal")
        k_nope = _project(c_kv, p["wkv_b_k"])
        v = _project(c_kv, p["wkv_b_v"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, c_kv.shape[1], heads, d_rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = attention.prefill_attention(
            q[:, :, :, None, :], k, v, kind="causal", block_kv=block_kv,
            softmax_scale=scale, q_offset=offset)[:, :, :, 0]
        new_cache = (c_new, r_new)
    else:
        cc, cr = cache
        seg = sharding.cache_segment(cc.shape[1])
        attention.update_cache(cc, cr, c_new, r_new, decode_pos, seg)
        # Absorbed attention over the compressed cache.
        dt = x.dtype
        q_lat = torch.einsum("bshk,lhk->bshl", q_nope,
                             p["wkv_b_k"].to(dt))          # [B,1,H,kv_lora]
        every = (tp is not None and seg is not None
                 and sharding.MODEL in seg.axes)
        if every:
            # the segments over model hold other heads: attend them all
            q_lat, q_rope = tp.gather(q_lat, 2), tp.gather(q_rope, 2)
        s = (torch.einsum("bshl,btl->bhst", q_lat, cc.to(dt))
             + torch.einsum("bshk,btk->bhst", q_rope, cr.to(dt)))
        s = attention._scaled_f32(s, scale)
        kv_pos = torch.arange(cc.shape[1], device=x.device)
        if seg is not None:
            kv_pos = kv_pos + seg.start
        valid = kv_pos <= decode_pos
        s = torch.where(valid, s, torch.full_like(s, attention.NEG_INF))
        if seg is None:
            w = torch.softmax(s, dim=-1).to(dt)
            o_lat = torch.einsum("bhst,btl->bshl", w, cc.to(dt))
        else:
            o_lat = attention.combine_segments(
                s, valid, lambda w: torch.einsum(
                    "bhst,btl->bhsl", w, cc.to(torch.float32)),
                seg).permute(0, 2, 1, 3).to(dt)
        if every:
            o_lat = o_lat[:, :, tp.block(n_heads)]
        out = torch.einsum("bshl,lhv->bshv", o_lat, p["wkv_b_v"].to(dt))
        new_cache = (cc, cr)

    out = attention.project_out(out, p)
    return sharding.sublayer_out(out, tp), new_cache
