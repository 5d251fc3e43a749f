"""Model facade: init, parameter count, the training loss, prefill,
decode, the decode cache and step inputs — the counterpart of
``repro/models/model.py`` for every family (KV caches for attention,
latent caches for MLA, conv + state caches for Mamba-2 and the RG-LRU,
static image and encoder K/V for cross-attention). The logical axes the
reference attaches to caches and inputs come with sharding, which the port
does not have yet (ROADMAP queue 1 item 3).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.common import softmax_xent


class Model:
    def __init__(self, cfg):
        transformer.check_supported(cfg)
        self.cfg = cfg

    # -- params ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> dict:
        """Parameters drawn from ``gen`` on its device (the reference's
        init: zero biases, zero conv and SSM scalars); ``to_device`` moves
        them."""
        return transformer.init(self.cfg, gen)

    def param_count(self) -> int:
        """Parameters of the tree ``init`` builds, from the shapes alone
        (nothing is allocated)."""
        cfg = self.cfg
        d = cfg.d_model
        norm = d if cfg.norm == "rmsnorm" else 2 * d
        n = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2) + norm
        q, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_
        attn = 2 * d * q + 2 * d * kv + ((q + 2 * kv) if cfg.qkv_bias else 0)
        mlp = lambda f: 3 * d * f                                # noqa
        if cfg.mla:
            H, dqk = cfg.n_heads, cfg.d_nope + cfg.d_rope
            attn = (d * (cfg.kv_lora + cfg.d_rope) + cfg.kv_lora
                    + cfg.kv_lora * H * (cfg.d_nope + cfg.d_v)
                    + H * cfg.d_v * d
                    + (d * cfg.q_lora + cfg.q_lora + cfg.q_lora * H * dqk
                       if cfg.q_lora else d * H * dqk))
        layer = 2 * norm + attn + mlp(cfg.d_ff)
        if cfg.family == "griffin":
            W = cfg.lru_width
            rec = 2 * norm + 3 * d * W + 2 * W * W + 8 * W + mlp(cfg.d_ff)
            n_groups, rem = divmod(cfg.n_layers, 3)
            return n + n_groups * (2 * rec + layer) + rem * rec
        if cfg.family == "vision":
            per = cfg.cross_every
            cross = layer + 2                                    # gates
            return n + cfg.n_layers // per * (cross + (per - 1) * layer)
        if cfg.family == "encdec":
            dec = 3 * norm + 2 * attn + mlp(cfg.d_ff)
            return n + cfg.enc_layers * layer + norm + cfg.n_layers * dec
        if cfg.ssm:
            H = cfg.d_inner // cfg.ssm_head_dim
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            rest = (norm + d * (cfg.d_inner + conv_dim + H) + 5 * conv_dim
                    + 3 * H + cfg.d_inner + cfg.d_inner * d)
        elif cfg.n_experts:
            E = cfg.n_experts
            rest = (2 * norm + attn + d * E + E * mlp(cfg.d_ff)
                    + (mlp(cfg.d_ff * cfg.n_shared) if cfg.n_shared else 0))
        else:
            rest = layer
        dense = 2 * norm + attn + mlp(cfg.dense_d_ff or cfg.d_ff)
        return (n + cfg.first_dense * dense
                + (cfg.n_layers - cfg.first_dense) * rest)

    # -- steps ----------------------------------------------------------------

    def loss(self, params, batch):
        """Mean next-token cross-entropy (float32) of ``batch``: tokens
        and labels [B, S] integer tensors on the parameters' device, and
        ``frames`` or ``patches`` as ``prefill`` takes them. Train mode:
        each layer under ``cfg.remat``."""
        logits, _ = transformer.apply(self.cfg, params, batch, "train")
        return softmax_xent(logits, batch["labels"])

    def prefill(self, params, batch):
        logits, cache = transformer.apply(self.cfg, params, batch, "prefill")
        return logits[:, -1], cache

    def decode(self, params, cache, tokens, pos: int):
        """One token per row at position ``pos``; the KV caches are
        written in place and returned."""
        logits, cache = transformer.apply(self.cfg, params,
                                          dict(tokens=tokens), "decode",
                                          cache=cache, decode_pos=pos)
        return logits[:, 0], cache

    # -- cache ----------------------------------------------------------------

    def cache_lengths(self, batch) -> dict:
        """``init_cache``'s cross-cache lengths for a prefill ``batch``, as
        the reference's ``Server`` sizes them: ``src_len`` the frames'
        length (encdec, else 0), ``n_img`` the config's
        ``n_img_tokens``."""
        cfg = self.cfg
        return dict(src_len=(batch["frames"].shape[1]
                             if cfg.family == "encdec" else 0),
                    n_img=cfg.n_img_tokens)

    def init_cache(self, batch: int, max_seq: int, device, *,
                   src_len: int = 0, n_img: int = 0):
        """Zero decode cache in the compute dtype on ``device``, in the
        reference's layouts unstacked: (k, v) of [B, max_seq, n_kv,
        head_dim] per attention layer; (c_kv [B, max_seq, kv_lora], k_rope
        [B, max_seq, d_rope]) per MLA layer; dict(conv [B, 3, conv_dim],
        state [B, H, P, N]) per Mamba-2 layer; dict(conv [B, 3, lru_width],
        state [B, lru_width]) per RG-LRU layer. For ``decoder`` and
        ``gemma3`` it is ``(dense, rest)``, per-layer lists (``dense`` None
        without leading dense layers); for ``griffin`` ``(groups, tail)``:
        a list of dict(rec1, rec2, attn) and a list of recurrent caches, or
        None without a tail; for ``vision`` a list per group of dict(img=
        (k, v) of [B, n_img, n_kv, head_dim], selfs=[...]); for
        ``encdec`` a list per decoder layer of dict(self=(k, v), cross=
        (k, v) of [B, src_len, n_kv, head_dim])."""
        cfg = self.cfg
        dt = cfg.compute_dtype

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=device)

        def kv(length=max_seq):
            return (zeros(batch, length, cfg.n_kv, cfg.head_dim_),
                    zeros(batch, length, cfg.n_kv, cfg.head_dim_))

        if cfg.family == "griffin":
            def rec():
                return dict(conv=zeros(batch, 3, cfg.lru_width),
                            state=zeros(batch, cfg.lru_width))
            n_groups, rem = divmod(cfg.n_layers, 3)
            groups = [dict(rec1=rec(), rec2=rec(), attn=kv())
                      for _ in range(n_groups)]
            return (groups, [rec() for _ in range(rem)] if rem else None)
        if cfg.family == "vision":
            per = cfg.cross_every
            return [dict(img=kv(n_img), selfs=[kv() for _ in range(per - 1)])
                    for _ in range(cfg.n_layers // per)]
        if cfg.family == "encdec":
            return [dict(self=kv(), cross=kv(src_len))
                    for _ in range(cfg.n_layers)]
        if cfg.ssm:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            H = cfg.d_inner // cfg.ssm_head_dim
            layer = lambda: dict(conv=zeros(batch, 3, conv_dim),   # noqa
                                 state=zeros(batch, H, cfg.ssm_head_dim,
                                             cfg.ssm_state))
        elif cfg.mla:
            layer = lambda: (zeros(batch, max_seq, cfg.kv_lora),  # noqa
                             zeros(batch, max_seq, cfg.d_rope))
        else:
            layer = kv
        dense = ([layer() for _ in range(cfg.first_dense)]
                 if cfg.first_dense else None)
        return (dense, [layer() for _ in range(cfg.n_layers
                                               - cfg.first_dense)])


    # -- step inputs ------------------------------------------------------------

    def make_inputs(self, shape, device, enc_ctx: int = 4096
                    ) -> Dict[str, Any]:
        """Zero step inputs of a ``ShapeSpec`` on ``device``: train
        {tokens, labels [, frames | patches]}, prefill {tokens [, frames |
        patches]}, decode {tokens [B, 1], cache} (an ``init_cache`` of
        ``seq_len`` positions, ``enc_ctx`` encoder positions for encdec).
        Tokens are int64; frames [B, S, d] and patches [B, n_img_tokens,
        d] in the compute dtype."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        dt = cfg.compute_dtype

        def tok(s):
            return torch.zeros((B, s), dtype=torch.int64, device=device)
        out: Dict[str, Any] = {}
        if shape.kind in ("train", "prefill"):
            out["tokens"] = tok(S)
            if shape.kind == "train":
                out["labels"] = tok(S)
            if cfg.family == "encdec":
                out["frames"] = torch.zeros((B, S, cfg.d_model), dtype=dt,
                                            device=device)
            if cfg.family == "vision":
                out["patches"] = torch.zeros(
                    (B, cfg.n_img_tokens, cfg.d_model), dtype=dt,
                    device=device)
        elif shape.kind == "decode":
            out["tokens"] = tok(1)
            out["cache"] = self.init_cache(
                B, S, device,
                src_len=enc_ctx if cfg.family == "encdec" else 0,
                n_img=cfg.n_img_tokens)
        else:
            raise ValueError(f"unknown shape kind {shape.kind!r}")
        return out


def to_device(tree, device):
    """A copy of a parameter (or cache) tree with every tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
