"""Architecture assembly — every family of ``repro/models/transformer.py``
in three modes: ``train`` (logits, no cache; differentiable, each layer's
body under ``cfg.remat``), ``prefill`` (logits + built cache) and
``decode`` (one token in, cache updated).

- ``decoder``: dense-GQA attention, MLA (``models/mla.py``) or Mamba-2
  SSD mixers; SwiGLU MLPs or MoE (``models/moe.py``); ``first_dense``
  leading dense-MLP layers (``dense_layers``, width ``dense_d_ff``) ahead
  of ``layers``.
- ``gemma3``: the decoder stack with a 5:1 local:global pattern (every
  ``attn_every``-th layer global): local layers attend a sliding window of
  ``window`` at RoPE base ``rope_theta``, global ones the reference's
  ``BIG_WINDOW`` at ``rope_theta_global``.
- ``griffin``: groups of (RG-LRU, RG-LRU, local MQA attention) layers,
  then a tail of ``n_layers mod 3`` RG-LRU layers, with GeGLU MLPs.
- ``vision``: groups of one tanh-gated cross-attention layer (to K/V
  projected from ``batch["patches"]``, no RoPE) and ``cross_every - 1``
  decoder layers.
- ``encdec``: a bidirectional encoder over ``batch["frames"]`` (``enc_norm``
  after it), then decoder layers of causal self-attention,
  cross-attention to the encoder memory and an MLP.

``embed_scale`` multiplies the embeddings by sqrt(d_model) rounded to the
compute dtype, as the reference does.

The reference scans over layer-stacked parameters (``lax.scan``); here a
Python loop walks lists of per-layer (or per-group) parameter dicts, and
the cache holds lists of per-layer caches. Where the reference
rematerializes a scan body in train mode (``_maybe_remat``), the port
checkpoints the same body (``_remat``: a decoder or encoder layer,
griffin's group and tail layer, vision's group and each of its decoder
layers): ``remat="full"`` saves nothing and recomputes the body in the
backward, ``"dots"`` saves the matmuls' outputs (the reference's
``checkpoint_dots``), ``"none"`` keeps every activation.

Under the sharded steps (``runtime/train_loop.py`` with a mesh) the
parameters come as ``runtime.sharding.ShardedLeaf`` blocks, and each layer
takes its own inside its checkpointed body (``_remat``), so no gathered
copy is kept for the backward. The sub-layers that compute
tensor-parallel over ``model`` (``tensor_parallel_mask``: the embedding
and logits head, dense attention, dense MLPs, MLA, MoE, the Mamba-2 and
RG-LRU mixers) take their leaves as the rank's ``model`` block
(``sharding.local_params``); the norms, the gates and MoE's router are
gathered whole. In
decode the caches come as ``runtime.sharding.CacheBlock`` blocks through
the same hook: an attention cache's heads, a Mamba-2 state's heads and
an RG-LRU cache's channels are read and written in place; Mamba-2's
packed conv tail is gathered over ``model`` and the rank's block of
what the layer leaves written back. ``constrain`` pins the activations
at the embedding and the logits to their logical axes, as the reference
does.

Where the rules split the residual stream over ``model``
(``sharding.Layout.split``: its sequence under ``seqpar``, its embedding
under ``act2d``) every residual add, ``embed_scale``, gate and norm runs
on the rank's block (a norm's statistics summed over ``model`` under
``act2d``: ``_norm``), every sub-layer gathers its input on entry and
leaves its output as the rank's block (``sharding.sublayer_in`` /
``sublayer_out``; a sub-layer computed whole, heads that ``model`` does
not divide, the same way), and ``positions`` are the whole sequence's:
the tokens stay whole over ``model``. The encoder's frames take the
rank's block as the decoder's stream does; the image patches' sequence
stays whole, their embedding split under ``act2d``. A decode token's
sequence of 1 does not split: ``seqpar`` decodes as the baseline does,
``act2d`` carries [B, 1, d/m] between sub-layers.

Where the rules split the sequence over ``data`` (context parallelism:
``sharding.Layout.segment_axes``, a batch that ``data`` does not divide)
each rank runs its segment of every row: its tokens, ``positions`` from
the segment's first global position, the encoder's frames likewise. The
sub-layers that mix positions exchange across segments (attention's K
and V, the Mamba-2 and RG-LRU states and conv halos, MoE's capacity
counts); the rest is per position.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention, mla, moe, rglru, ssm
from repro_torch.runtime import sharding
from repro_torch.models.common import (apply_norm, embed_tokens,
                                       embedding_init, logits_from_hidden,
                                       mlp_apply, mlp_init, norm_init,
                                       zeros_init)

FAMILIES = ("decoder", "gemma3", "griffin", "vision", "encdec")
# gemma3's global layers: a sliding window wider than any sequence (the
# reference's BIG_WINDOW), so the mask is the causal one.
BIG_WINDOW = 1 << 30


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a family of the "
            f"reference; the port runs {', '.join(FAMILIES)}")


def embed_scale(d_model: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(d_model) as a 0-dim tensor of ``dtype``, rounded from the
    float64 value as the reference's ``np.sqrt(d).astype(dtype)`` rounds
    it (50.5 in bf16 at d 2560, not 50.596)."""
    return torch.tensor(math.sqrt(d_model), dtype=torch.float64).to(dtype)


def attention_args(cfg, i: int) -> tuple:
    """(kind, window, rope_theta) of attention layer ``i``."""
    if cfg.family == "gemma3":
        if i % cfg.attn_every == cfg.attn_every - 1:         # global
            return ("sliding", BIG_WINDOW,
                    cfg.rope_theta_global or cfg.rope_theta)
        return "sliding", max(cfg.window, 1), cfg.rope_theta
    return ("sliding" if cfg.window else "causal"), cfg.window, \
        cfg.rope_theta


# The outputs ``remat="dots"`` saves: every matmul (einsums lower to bmm).
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default]
_REMATS = ("none", "dots", "full")


def constrain(x, axes, vocab=None):
    """The reference's ``with_sharding_constraint`` by logical axes at the
    embedding and the logits. A no-op outside the sharded steps. Inside
    them, ``x`` holds this rank's rows of the batch, split over
    ``act_batch``'s mesh axes, and of the residual stream the rank's
    block of the dimension ``Layout.split`` names (the sequence where
    ``act_seq`` resolves to ``model``, the embedding where ``act_embed``
    does), checked against the layout here (``sharding.check_rows``). The
    logits (last dimension ``vocab`` whole) hold every position — the
    head's entry gathers a split sequence — and the rank's block of the
    vocabulary where ``act_vocab`` splits it over ``model``
    (``sharding.check_logits``). Under context parallelism the rank holds
    its segment of the sequence (``Layout.segment_axes``). A layout whose
    rules would split the embedding over another axis than ``model``
    raises."""
    layout = sharding.current_layout()
    if layout is None:
        return x
    if vocab is not None:
        return sharding.check_logits(x, axes, layout, vocab)
    return sharding.check_rows(x, axes, layout)


def _norm(cfg, x, p):
    """The config's norm of the residual stream ``x`` (the rank's block of
    its channels under ``act2d``: ``sharding.embed_split``)."""
    return apply_norm(x, p, cfg.norm, sharding.embed_split())


# A sub-layer's parameter dict by a key only it holds: MLA (``wkv_a``),
# MoE (``router``), the Mamba-2 mixer (``in_proj``) and the RG-LRU block
# (``w_a``).
_TP_KEYS = ("wkv_a", "router", "in_proj", "w_a")
# Leaves of those that every rank uses whole, for the same whole gradient:
# MoE's router (every rank routes all of its tokens).
_WHOLE_KEYS = ("router",)


def tensor_parallel_mask(tree):
    """``tree`` (a parameter tree, any leaves) with True at the leaves of
    the sub-layers that compute tensor-parallel over ``model`` in the
    sharded steps, each of which takes them through
    ``sharding.local_params``: the token embedding and logits head
    (``embed``), every dense attention (self, cross and the encoder's: a
    dict holding ``wq``, ``wk``, ``wv`` and ``wo``), every dense MLP (a
    dict of ``wi``, ``wg`` and ``wo``), MLA (its norms too), MoE (routed
    and shared experts), the Mamba-2 mixer and the RG-LRU block; False at
    the layers' norms, the cross layers' gates and MoE's router, which
    are gathered whole."""
    def walk(t, on):
        if isinstance(t, dict):
            on = on or {"wq", "wk", "wv", "wo"} <= t.keys() or \
                set(t) == {"wi", "wg", "wo"} or any(k in t for k in _TP_KEYS)
            return {k: walk(v, on and k not in _WHOLE_KEYS)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, on) for v in t)
        return on
    return {k: walk(v, k == "embed") for k, v in tree.items()}


def _remat(cfg, mode, fn, *args):
    """``fn(*args)``, checkpointed by ``cfg.remat`` when training under
    grad (the reference's ``_maybe_remat``). Sharded parameters and cache
    blocks among the arguments are taken inside the checkpointed body: the
    tensor-parallel sub-layers' leaves as the rank's ``model`` blocks (by
    the sub-layer, ``sharding.local_params``), the others gathered whole
    here; in decode the rank's block of the cache ``fn`` returns (its
    result's second item) is written back where the layer did not write it
    in place."""
    if cfg.remat not in _REMATS:
        raise ValueError(f"remat must be one of {_REMATS}, got "
                         f"{cfg.remat!r}")
    if sharding.current_layout() is not None:
        body = fn

        def fn(*a):
            out = body(*sharding.materialize(a))
            if mode == "decode":
                sharding.write_back(a, out)
            return out
    if mode != "train" or cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=(
            functools.partial(create_selective_checkpoint_contexts, _DOTS)))
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _attn_init(cfg, gen) -> dict:
    return attention.init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                          cfg.head_dim_, qkv_bias=cfg.qkv_bias,
                          dtype=cfg.params_dtype)


def decoder_layer_init(cfg, gen, use_moe: bool = False,
                       d_ff: int = 0) -> dict:
    """A decoder layer: norm, mixer (SSM, MLA or attention), norm, MLP
    (MoE when ``use_moe``; a dense one of width ``d_ff or cfg.d_ff``)."""
    dt, dev = cfg.params_dtype, gen.device
    p = dict(ln1=norm_init(cfg.d_model, cfg.norm, dt, dev))
    if cfg.ssm:
        p["mixer"] = ssm.block_init(
            gen, cfg.d_model, d_inner=cfg.d_inner,
            head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
            d_state=cfg.ssm_state, dtype=dt)
        return p
    if cfg.mla:
        p["attn"] = mla.init(gen, cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora,
                             kv_lora=cfg.kv_lora, d_nope=cfg.d_nope,
                             d_rope=cfg.d_rope, d_v=cfg.d_v, dtype=dt)
    else:
        p["attn"] = _attn_init(cfg, gen)
    p["ln2"] = norm_init(cfg.d_model, cfg.norm, dt, dev)
    if use_moe:
        p["mlp"] = moe.init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            n_shared=cfg.n_shared, dtype=dt)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, d_ff or cfg.d_ff, dt)
    return p


def rec_layer_init(cfg, gen) -> dict:
    dt, dev = cfg.params_dtype, gen.device
    return dict(ln1=norm_init(cfg.d_model, cfg.norm, dt, dev),
                mixer=rglru.block_init(gen, cfg.d_model,
                                       lru_width=cfg.lru_width, dtype=dt),
                ln2=norm_init(cfg.d_model, cfg.norm, dt, dev),
                mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, dt))


def cross_layer_init(cfg, gen) -> dict:
    """Gated cross-attention layer (llama-3.2-vision style). The gates are
    zero, as in the reference, so at init the layer is the identity:
    ``draw_live_gates`` gives a check something to see."""
    dt, dev = cfg.params_dtype, gen.device
    return dict(ln1=norm_init(cfg.d_model, cfg.norm, dt, dev),
                cross=_attn_init(cfg, gen),
                gate_attn=zeros_init((1,), ("scalar",), dt, dev),
                ln2=norm_init(cfg.d_model, cfg.norm, dt, dev),
                mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, dt),
                gate_mlp=zeros_init((1,), ("scalar",), dt, dev))


def draw_live_gates(rng: np.random.Generator) -> dict:
    """The two gates a cross layer's init leaves at zero (gate_attn,
    gate_mlp), drawn uniform in (0.5, 1), so tanh(gate) is 0.46-0.76: with
    the zero gates of ``cross_layer_init`` the layer adds exactly nothing,
    and a wrong cross-attention would pass any comparison. Float32 numpy
    arrays of shape (1,) under the init's names, one layer."""
    return {k: rng.uniform(0.5, 1.0, (1,)).astype(np.float32)
            for k in ("gate_attn", "gate_mlp")}


def encdec_dec_layer_init(cfg, gen) -> dict:
    dt, dev = cfg.params_dtype, gen.device
    return dict(ln1=norm_init(cfg.d_model, cfg.norm, dt, dev),
                self=_attn_init(cfg, gen),
                ln2=norm_init(cfg.d_model, cfg.norm, dt, dev),
                cross=_attn_init(cfg, gen),
                ln3=norm_init(cfg.d_model, cfg.norm, dt, dev),
                mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, dt))


def encoder_layer_init(cfg, gen) -> dict:
    dt, dev = cfg.params_dtype, gen.device
    return dict(ln1=norm_init(cfg.d_model, cfg.norm, dt, dev),
                attn=_attn_init(cfg, gen),
                ln2=norm_init(cfg.d_model, cfg.norm, dt, dev),
                mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, dt))


def init(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Full parameter tree on ``gen``'s device: ``embed``, ``final_norm``
    and, for ``decoder`` and ``gemma3``, ``layers`` (a list of per-layer
    dicts) after ``dense_layers`` where ``first_dense``; for ``griffin``,
    ``groups``, a list of dict(rec1, rec2, attn), and ``tail``, a list of
    recurrent layers (absent when n_layers is a multiple of 3); for
    ``vision``, ``groups``, a list of dict(cross, selfs=[decoder layers]);
    for ``encdec``, ``enc_layers``, ``enc_norm`` and ``layers``. The
    reference's layouts with its stacks unstacked into lists; draws in the
    order embedding, then layer by layer. Leaves are ``P(value, axes)``
    with the reference's logical axes (``common.split_tree`` separates
    them); ``gen`` may be ``common.META``."""
    check_supported(cfg)
    params = dict(
        embed=embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                             cfg.params_dtype, tied=cfg.tie_embeddings),
        final_norm=norm_init(cfg.d_model, cfg.norm, cfg.params_dtype,
                             gen.device))
    if cfg.family == "griffin":
        n_groups, rem = divmod(cfg.n_layers, 3)
        params["groups"] = [dict(rec1=rec_layer_init(cfg, gen),
                                 rec2=rec_layer_init(cfg, gen),
                                 attn=decoder_layer_init(cfg, gen))
                            for _ in range(n_groups)]
        if rem:
            params["tail"] = [rec_layer_init(cfg, gen) for _ in range(rem)]
    elif cfg.family == "vision":
        per = cfg.cross_every
        params["groups"] = [
            dict(cross=cross_layer_init(cfg, gen),
                 selfs=[decoder_layer_init(cfg, gen) for _ in range(per - 1)])
            for _ in range(cfg.n_layers // per)]
    elif cfg.family == "encdec":
        params["enc_layers"] = [encoder_layer_init(cfg, gen)
                                for _ in range(cfg.enc_layers)]
        params["enc_norm"] = norm_init(cfg.d_model, cfg.norm,
                                       cfg.params_dtype, gen.device)
        params["layers"] = [encdec_dec_layer_init(cfg, gen)
                            for _ in range(cfg.n_layers)]
    else:
        if cfg.first_dense:
            params["dense_layers"] = [
                decoder_layer_init(cfg, gen, d_ff=cfg.dense_d_ff)
                for _ in range(cfg.first_dense)]
        params["layers"] = [decoder_layer_init(cfg, gen, cfg.n_experts > 0)
                            for _ in range(cfg.n_layers - cfg.first_dense)]
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def decoder_layer_apply(cfg, p, x, positions, mode, cache, decode_pos,
                        i: int = 0, use_moe: bool = False):
    """Layer ``i`` of a decoder stack, or griffin's attention layer."""
    h = _norm(cfg, x, p["ln1"])
    if cfg.ssm:
        mix, new_cache = ssm.block_apply(h, p["mixer"], cfg, mode=mode,
                                         cache=cache, chunk=cfg.ssd_chunk)
        return x + mix, new_cache
    if cfg.mla:
        mix, new_cache = mla.apply(
            h, p["attn"], n_heads=cfg.n_heads, q_lora=cfg.q_lora,
            kv_lora=cfg.kv_lora, d_nope=cfg.d_nope, d_rope=cfg.d_rope,
            d_v=cfg.d_v, positions=positions, block_kv=cfg.block_kv,
            cache=cache if mode == "decode" else None, decode_pos=decode_pos)
    else:
        kind, window, theta = attention_args(cfg, i)
        mix, new_cache = attention.apply(
            h, p["attn"], n_kv=cfg.n_kv, n_heads=cfg.n_heads,
            positions=positions, kind=kind, window=window, rope_theta=theta,
            block_kv=cfg.block_kv, softmax_scale=cfg.softmax_scale,
            cache=cache if mode == "decode" else None, decode_pos=decode_pos,
            keep_kv=mode != "train")
    x = x + mix
    h2 = _norm(cfg, x, p["ln2"])
    if use_moe:
        y = moe.apply(h2, p["mlp"], top_k=cfg.top_k, n_experts=cfg.n_experts,
                      capacity_factor=cfg.moe_capacity_factor)
    else:
        y = mlp_apply(h2, p["mlp"],
                      gate="gelu" if cfg.family == "griffin" else "silu")
    return x + y, (new_cache if mode != "train" else None)


def rec_layer_apply(cfg, p, x, mode, cache):
    """Griffin's recurrent layer: RG-LRU block, then a GeGLU MLP."""
    h = _norm(cfg, x, p["ln1"])
    mix, new_cache = rglru.block_apply(h, p["mixer"], mode=mode,
                                       cache=cache)
    x = x + mix
    h2 = _norm(cfg, x, p["ln2"])
    return x + mlp_apply(h2, p["mlp"], gate="gelu"), new_cache


def _cross_attend(cfg, p, h, positions, memory=None, cache=None,
                  keep_kv=True, kv_split=sharding.AS_RESIDUAL):
    """Cross-attention of ``h`` to static K/V (image or encoder memory),
    no RoPE, kind ``full``: in prefill K/V are projected from ``memory``
    (split over ``model`` along ``kv_split``: by default as the residual
    stream, as the encoder's memory is); in decode ``cache`` is read and
    never written. Returns (out, (k, v)), the second the static cross
    cache (``keep_kv=False``: dropped)."""
    return attention.apply(h, p, n_kv=cfg.n_kv, n_heads=cfg.n_heads,
                           positions=positions, kind="full",
                           rope_theta=None, block_kv=cfg.block_kv,
                           kv_x=memory, kv_split=kv_split, cache=cache,
                           decode_pos=None if cache is None else 0,
                           keep_kv=keep_kv)


def cross_layer_apply(cfg, p, x, positions, patches=None, cache=None,
                      keep_kv=True):
    """Gated cross-attention to static image K/V (from ``patches`` in
    prefill, ``cache`` in decode), then a gated MLP. Returns (x, (k, v))."""
    h = _norm(cfg, x, p["ln1"])
    # The patches' sequence (``act_img``) stays whole; under act2d their
    # embedding is the rank's block, as the residual stream's is.
    split = sharding.residual_split()
    mix, img_kv = _cross_attend(cfg, p["cross"], h, positions, patches,
                                cache, keep_kv,
                                split if split == sharding.EMBED else None)
    x = x + torch.tanh(p["gate_attn"].to(x.dtype)) * mix
    h2 = _norm(cfg, x, p["ln2"])
    return x + torch.tanh(p["gate_mlp"].to(x.dtype)) * mlp_apply(
        h2, p["mlp"]), img_kv


def _griffin_stack(cfg, params, x, positions, mode, cache, decode_pos):
    """The groups, then the tail. The cache is ``(groups, tail)``: a list
    of dict(rec1, rec2, attn) and a list of recurrent caches (None without
    a tail), the reference's ``(gout, tout)`` unstacked."""
    gcache, tcache = cache if cache is not None else (None, None)

    def group(x, gp, gc):
        x, c1 = rec_layer_apply(cfg, gp["rec1"], x, mode, gc.get("rec1"))
        x, c2 = rec_layer_apply(cfg, gp["rec2"], x, mode, gc.get("rec2"))
        x, ca = decoder_layer_apply(cfg, gp["attn"], x, positions, mode,
                                    gc.get("attn"), decode_pos)
        return x, dict(rec1=c1, rec2=c2, attn=ca)

    gout, tout = [], []
    for g, gp in enumerate(params["groups"]):
        x, c = _remat(cfg, mode, group, x, gp,
                      gcache[g] if gcache is not None else {})
        gout.append(c)
    for j, lp in enumerate(params.get("tail", ())):
        x, c = _remat(cfg, mode, rec_layer_apply, cfg, lp, x, mode,
                      tcache[j] if tcache is not None else None)
        tout.append(c)
    return x, (gout, tout or None)


def _decoder_stack(cfg, params, x, positions, mode, cache, decode_pos):
    """``dense_layers`` (if any), then ``layers``. The cache is
    ``(dense, rest)``: lists of per-layer caches, ``dense`` None without
    leading dense layers — the reference's pair unstacked."""
    c_dense, c_rest = cache if cache is not None else (None, None)
    dense = None
    if cfg.first_dense:
        dense = []
        for i, lp in enumerate(params["dense_layers"]):
            x, c = _remat(cfg, mode, decoder_layer_apply, cfg, lp, x,
                          positions, mode,
                          c_dense[i] if c_dense is not None else None,
                          decode_pos, i)
            dense.append(c)
    rest = []
    for i, lp in enumerate(params["layers"]):
        x, c = _remat(cfg, mode, decoder_layer_apply, cfg, lp, x, positions,
                      mode, c_rest[i] if c_rest is not None else None,
                      decode_pos, i, cfg.n_experts > 0)
        rest.append(c)
    return x, (dense, rest)


def _vision_stack(cfg, params, batch, x, positions, mode, cache,
                  decode_pos):
    """Per group: the cross layer over image K/V (projected from
    ``batch["patches"]`` in prefill, read from the cache in decode), then
    the group's decoder layers. The cache is a list of dict(img=(k, v),
    selfs=[per-layer cache])."""
    patches = (None if mode == "decode" else
               batch["patches"].to(cfg.compute_dtype))

    def group(x, gp, gc):
        x, img_kv = cross_layer_apply(
            cfg, gp["cross"], x, positions, patches,
            gc["img"] if mode == "decode" else None, mode != "train")
        selfs = []
        for i, lp in enumerate(gp["selfs"]):
            x, c = _remat(cfg, mode, decoder_layer_apply, cfg, lp, x,
                          positions, mode,
                          gc["selfs"][i] if gc is not None else None,
                          decode_pos, i)
            selfs.append(c)
        return x, (dict(img=img_kv, selfs=selfs) if mode != "train"
                   else None)

    out = []
    for g, gp in enumerate(params["groups"]):
        x, c = _remat(cfg, mode, group, x, gp,
                      cache[g] if cache is not None else None)
        out.append(c)
    return x, out


def _positions(n: int, device):
    """The global positions of the rank's ``n`` positions of a sequence:
    ``arange(n)``, from its segment's first position under context
    parallelism."""
    cp = sharding.context_parallel()
    return torch.arange(n, device=device) + (0 if cp is None
                                              else cp.start(n))


def encode(cfg, params, frames, mode="prefill"):
    """Bidirectional encoder over frame embeddings [B, S_src, d] (RoPE at
    ``rope_theta``), then ``enc_norm``: the decoder's cross-attention
    memory. Each layer is checkpointed in ``train`` mode."""
    x = frames.to(cfg.compute_dtype)
    # Every position of the frames (the rank holds its block of them
    # where the layout splits the sequence over model).
    n = x.shape[1] * (sharding.current_layout().split_ways
                      if sharding.residual_split() == sharding.SEQ else 1)
    positions = _positions(n, x.device)

    def layer(x, lp):
        h = _norm(cfg, x, lp["ln1"])
        mix, _ = attention.apply(h, lp["attn"], n_kv=cfg.n_kv,
                                 n_heads=cfg.n_heads, positions=positions,
                                 kind="full", rope_theta=cfg.rope_theta,
                                 block_kv=cfg.block_kv, keep_kv=False)
        x = x + mix
        h2 = _norm(cfg, x, lp["ln2"])
        return x + mlp_apply(h2, lp["mlp"])

    for lp in params["enc_layers"]:
        x = _remat(cfg, mode, layer, x, lp)
    return _norm(cfg, x, params["enc_norm"])


def _encdec_stack(cfg, params, batch, x, positions, mode, cache,
                  decode_pos):
    """The encoder (not in decode), then per decoder layer: causal
    self-attention, cross-attention to the memory, MLP. The cache is a
    list of dict(self=(k, v), cross=(k, v))."""
    memory = None if mode == "decode" else encode(cfg, params,
                                                  batch["frames"], mode)

    def layer(x, lp, cc):
        h = _norm(cfg, x, lp["ln1"])
        mix, kv = attention.apply(
            h, lp["self"], n_kv=cfg.n_kv, n_heads=cfg.n_heads,
            positions=positions, kind="causal", rope_theta=cfg.rope_theta,
            block_kv=cfg.block_kv,
            cache=cc["self"] if mode == "decode" else None,
            decode_pos=decode_pos, keep_kv=mode != "train")
        x = x + mix
        h2 = _norm(cfg, x, lp["ln2"])
        mix, cross_kv = _cross_attend(
            cfg, lp["cross"], h2, positions, memory,
            cc["cross"] if mode == "decode" else None, mode != "train")
        x = x + mix
        h3 = _norm(cfg, x, lp["ln3"])
        x = x + mlp_apply(h3, lp["mlp"])
        return x, (dict(self=kv, cross=cross_kv) if mode != "train"
                   else None)

    out = []
    for i, lp in enumerate(params["layers"]):
        x, c = _remat(cfg, mode, layer, x, lp,
                      cache[i] if cache is not None else None)
        out.append(c)
    return x, out


def apply(cfg, params, batch, mode, cache=None, decode_pos=None):
    """Returns (logits, new_cache). batch: tokens [B, S] (int32, as the
    reference draws them, on the parameters' device), and ``frames`` [B, S_src, d] (encdec) or
    ``patches`` [B, n_img, d] (vision) outside decode. In a sharded step
    whose head splits the vocabulary over ``model`` the logits are the
    rank's block of it. The cache is
    ``(dense, rest)`` for ``decoder`` and ``gemma3`` (dense None without
    leading dense layers), ``(groups, tail)`` for ``griffin``, and a list
    per group (vision) or per decoder layer (encdec)."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if sharding.current_layout() is not None:
        params = dict(params, **sharding.materialize(
            {k: v for k, v in params.items()
             if k in ("final_norm", "enc_norm")}))
    embed, tp = sharding.local_params(params["embed"])
    if tp is None and sharding.residual_split() is not None:
        raise NotImplementedError(
            "a residual stream split over model needs the vocab-parallel "
            "embedding and head (the rules' vocab over model)")
    dtype = cfg.compute_dtype
    tokens = batch["tokens"]            # every position, on every rank
    B, S = tokens.shape
    x = embed_tokens(tokens, embed, dtype, tp)
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    if cfg.embed_scale:
        x = x * embed_scale(cfg.d_model, dtype)
    if mode == "decode":
        positions = torch.full((1,), decode_pos, dtype=torch.int64,
                               device=x.device)
    else:
        positions = _positions(S, x.device)

    if cfg.family == "griffin":
        x, new_cache = _griffin_stack(cfg, params, x, positions, mode,
                                      cache, decode_pos)
    elif cfg.family == "vision":
        x, new_cache = _vision_stack(cfg, params, batch, x, positions, mode,
                                     cache, decode_pos)
    elif cfg.family == "encdec":
        x, new_cache = _encdec_stack(cfg, params, batch, x, positions, mode,
                                     cache, decode_pos)
    else:
        x, new_cache = _decoder_stack(cfg, params, x, positions, mode, cache,
                                      decode_pos)
    if mode == "train":
        new_cache = None

    x = _norm(cfg, x, params["final_norm"])
    logits = logits_from_hidden(x, embed, cfg.vocab, dtype, tp)
    return constrain(logits, ("act_batch", "act_seq", "act_vocab"),
                     cfg.padded_vocab), new_cache
