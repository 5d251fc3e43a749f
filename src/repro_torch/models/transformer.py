"""Architecture assembly — the ``decoder`` family of
``repro/models/transformer.py``, with dense-GQA attention or Mamba-2 SSD
mixers, in three modes: ``train`` (logits, no cache; forward only),
``prefill`` (logits + built cache) and ``decode`` (one token in, cache
updated).

The reference scans over layer-stacked parameters (``lax.scan``); here a
Python loop walks a list of per-layer parameter dicts, and the cache is a
list of per-layer caches. Every other family and flag (MoE, MLA,
``first_dense``, gemma-style embedding scale, gemma3, griffin, vision,
encdec) raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention, ssm
from repro_torch.models.common import (apply_norm, embed_tokens,
                                       embedding_init, logits_from_hidden,
                                       mlp_apply, mlp_init, norm_init)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    missing = []
    if cfg.family != "decoder":
        missing.append(f"family {cfg.family!r}")
    for flag in ("mla", "n_experts", "first_dense", "embed_scale"):
        if getattr(cfg, flag):
            missing.append(flag)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            "queue 1 item 2b); the port runs the decoder family with "
            "attention or SSM mixers")


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


def init(cfg, gen: torch.Generator) -> Dict[str, Any]:
    """Full parameter tree on ``gen``'s device: ``embed``, ``final_norm``
    and ``layers``, a list of per-layer dicts in the reference's layouts.
    Draws in the order embedding, then layer by layer."""
    check_supported(cfg)
    return dict(
        embed=embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                             cfg.params_dtype, tied=cfg.tie_embeddings),
        final_norm=norm_init(cfg.d_model, cfg.norm, cfg.params_dtype,
                             gen.device),
        layers=[decoder_layer_init(cfg, gen) for _ in range(cfg.n_layers)])


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def decoder_layer_apply(cfg, p, x, positions, mode, cache, decode_pos):
    h = apply_norm(x, p["ln1"], cfg.norm)
    if cfg.ssm:
        mix, new_cache = ssm.block_apply(h, p["mixer"], cfg, mode=mode,
                                         cache=cache, chunk=cfg.ssd_chunk)
        return x + mix, new_cache
    kind = "sliding" if cfg.window else "causal"
    mix, kv = attention.apply(
        h, p["attn"], n_kv=cfg.n_kv, n_heads=cfg.n_heads,
        positions=positions, kind=kind, window=cfg.window,
        rope_theta=cfg.rope_theta, block_kv=cfg.block_kv,
        softmax_scale=cfg.softmax_scale,
        cache=cache if mode == "decode" else None, decode_pos=decode_pos)
    x = x + mix
    h2 = apply_norm(x, p["ln2"], cfg.norm)
    return x + mlp_apply(h2, p["mlp"]), (kv if mode != "train" else None)


def apply(cfg, params, batch, mode, cache=None, decode_pos=None):
    """Returns (logits, new_cache). batch: tokens [B, S] (int64 on the
    parameters' device). The cache is ``(None, [per-layer cache])``, the
    reference's ``(dense, rest)`` pair with no dense layers."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    dtype = cfg.compute_dtype
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(tokens, params["embed"], dtype)
    if mode == "decode":
        positions = torch.full((1,), decode_pos, dtype=torch.int64,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device)

    layer_caches = cache[1] if cache is not None else None
    new = []
    for i, lp in enumerate(params["layers"]):
        c = layer_caches[i] if layer_caches is not None else None
        x, c = decoder_layer_apply(cfg, lp, x, positions, mode, c,
                                   decode_pos)
        new.append(c)
    new_cache = (None, new) if mode != "train" else None

    x = apply_norm(x, params["final_norm"], cfg.norm)
    return logits_from_hidden(x, params["embed"], cfg.vocab, dtype), \
        new_cache
