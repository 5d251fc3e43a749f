"""Architecture assembly — the ``decoder``, ``gemma3`` and ``griffin``
families of ``repro/models/transformer.py`` in three modes: ``train``
(logits, no cache; forward only), ``prefill`` (logits + built cache) and
``decode`` (one token in, cache updated).

- ``decoder``: dense-GQA attention or Mamba-2 SSD mixers, SwiGLU MLPs.
- ``gemma3``: the decoder stack with a 5:1 local:global pattern (every
  ``attn_every``-th layer global): local layers attend a sliding window of
  ``window`` at RoPE base ``rope_theta``, global ones the reference's
  ``BIG_WINDOW`` at ``rope_theta_global``.
- ``griffin``: groups of (RG-LRU, RG-LRU, local MQA attention) layers,
  then a tail of ``n_layers mod 3`` RG-LRU layers, with GeGLU MLPs.

``embed_scale`` multiplies the embeddings by sqrt(d_model) rounded to the
compute dtype, as the reference does.

The reference scans over layer-stacked parameters (``lax.scan``); here a
Python loop walks lists of per-layer (or per-group) parameter dicts, and
the cache holds lists of per-layer caches. MoE, MLA, ``first_dense`` and
the vision and encdec families raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import attention, rglru, ssm
from repro_torch.models.common import (apply_norm, embed_tokens,
                                       embedding_init, logits_from_hidden,
                                       mlp_apply, mlp_init, norm_init)

FAMILIES = ("decoder", "gemma3", "griffin")
# gemma3's global layers: a sliding window wider than any sequence (the
# reference's BIG_WINDOW), so the mask is the causal one.
BIG_WINDOW = 1 << 30


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    missing = []
    if cfg.family not in FAMILIES:
        missing.append(f"family {cfg.family!r}")
    for flag in ("mla", "n_experts", "first_dense"):
        if getattr(cfg, flag):
            missing.append(flag)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            "queue 1 item 2b); the port runs the decoder family with "
            "attention or SSM mixers, gemma3 and griffin")


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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def decoder_layer_init(cfg, gen) -> dict:
    dt, dev = cfg.params_dtype, gen.device
    p = dict(ln1=norm_init(cfg.d_model, cfg.norm, dt, dev))
    if cfg.ssm:
        p["mixer"] = ssm.block_init(
            gen, cfg.d_model, d_inner=cfg.d_inner,
            head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
            d_state=cfg.ssm_state, dtype=dt)
        return p
    p["attn"] = attention.init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                               cfg.head_dim_, qkv_bias=cfg.qkv_bias,
                               dtype=dt)
    p["ln2"] = norm_init(cfg.d_model, cfg.norm, dt, dev)
    p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def rec_layer_init(cfg, gen) -> dict:
    dt, dev = cfg.params_dtype, gen.device
    return dict(ln1=norm_init(cfg.d_model, cfg.norm, dt, dev),
                mixer=rglru.block_init(gen, cfg.d_model,
                                       lru_width=cfg.lru_width, dtype=dt),
                ln2=norm_init(cfg.d_model, cfg.norm, dt, dev),
                mlp=mlp_init(gen, cfg.d_model, cfg.d_ff, dt))


def init(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Full parameter tree on ``gen``'s device: ``embed``, ``final_norm``
    and, for ``decoder`` and ``gemma3``, ``layers``, a list of per-layer
    dicts; for ``griffin``, ``groups``, a list of dict(rec1, rec2, attn),
    and ``tail``, a list of recurrent layers (absent when n_layers is a
    multiple of 3). The reference's layouts; draws in the order embedding,
    then layer by layer."""
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
    else:
        params["layers"] = [decoder_layer_init(cfg, gen)
                            for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def decoder_layer_apply(cfg, p, x, positions, mode, cache, decode_pos,
                        i: int = 0):
    """Layer ``i`` of a decoder stack, or griffin's attention layer."""
    h = apply_norm(x, p["ln1"], cfg.norm)
    if cfg.ssm:
        mix, new_cache = ssm.block_apply(h, p["mixer"], cfg, mode=mode,
                                         cache=cache, chunk=cfg.ssd_chunk)
        return x + mix, new_cache
    kind, window, theta = attention_args(cfg, i)
    mix, kv = attention.apply(
        h, p["attn"], n_kv=cfg.n_kv, n_heads=cfg.n_heads,
        positions=positions, kind=kind, window=window, rope_theta=theta,
        block_kv=cfg.block_kv, softmax_scale=cfg.softmax_scale,
        cache=cache if mode == "decode" else None, decode_pos=decode_pos)
    x = x + mix
    h2 = apply_norm(x, p["ln2"], cfg.norm)
    gate = "gelu" if cfg.family == "griffin" else "silu"
    return x + mlp_apply(h2, p["mlp"], gate=gate), \
        (kv if mode != "train" else None)


def rec_layer_apply(cfg, p, x, mode, cache):
    """Griffin's recurrent layer: RG-LRU block, then a GeGLU MLP."""
    h = apply_norm(x, p["ln1"], cfg.norm)
    mix, new_cache = rglru.block_apply(h, p["mixer"], mode=mode,
                                       cache=cache)
    x = x + mix
    h2 = apply_norm(x, p["ln2"], cfg.norm)
    return x + mlp_apply(h2, p["mlp"], gate="gelu"), new_cache


def _griffin_stack(cfg, params, x, positions, mode, cache, decode_pos):
    """The groups, then the tail. The cache is ``(groups, tail)``: a list
    of dict(rec1, rec2, attn) and a list of recurrent caches (None without
    a tail), the reference's ``(gout, tout)`` unstacked."""
    gcache, tcache = cache if cache is not None else (None, None)
    gout, tout = [], []
    for g, gp in enumerate(params["groups"]):
        gc = gcache[g] if gcache is not None else {}
        x, c1 = rec_layer_apply(cfg, gp["rec1"], x, mode, gc.get("rec1"))
        x, c2 = rec_layer_apply(cfg, gp["rec2"], x, mode, gc.get("rec2"))
        x, ca = decoder_layer_apply(cfg, gp["attn"], x, positions, mode,
                                    gc.get("attn"), decode_pos)
        gout.append(dict(rec1=c1, rec2=c2, attn=ca))
    for j, lp in enumerate(params.get("tail", ())):
        x, c = rec_layer_apply(cfg, lp, x, mode,
                               tcache[j] if tcache is not None else None)
        tout.append(c)
    return x, (gout, tout or None)


def apply(cfg, params, batch, mode, cache=None, decode_pos=None):
    """Returns (logits, new_cache). batch: tokens [B, S] (int64 on the
    parameters' device). The cache is ``(None, [per-layer cache])`` for
    ``decoder`` and ``gemma3`` (the reference's ``(dense, rest)`` pair
    with no dense layers) and ``(groups, tail)`` for ``griffin``."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    dtype = cfg.compute_dtype
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(tokens, params["embed"], dtype)
    if cfg.embed_scale:
        x = x * embed_scale(cfg.d_model, dtype)
    if mode == "decode":
        positions = torch.full((1,), decode_pos, dtype=torch.int64,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device)

    if cfg.family == "griffin":
        x, new_cache = _griffin_stack(cfg, params, x, positions, mode,
                                      cache, decode_pos)
    else:
        layer_caches = cache[1] if cache is not None else None
        new = []
        for i, lp in enumerate(params["layers"]):
            c = layer_caches[i] if layer_caches is not None else None
            x, c = decoder_layer_apply(cfg, lp, x, positions, mode, c,
                                       decode_pos, i)
            new.append(c)
        new_cache = (None, new)
    if mode == "train":
        new_cache = None

    x = apply_norm(x, params["final_norm"], cfg.norm)
    return logits_from_hidden(x, params["embed"], cfg.vocab, dtype), \
        new_cache
