"""Model facade: init, parameter count, prefill, decode and the decode
cache — the counterpart of ``repro/models/model.py`` for the port's
``decoder``, ``gemma3`` and ``griffin`` families (KV caches for attention,
conv + state caches for Mamba-2 and the RG-LRU)."""
from __future__ import annotations

import torch

from repro_torch.models import transformer


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
        attn = (2 * norm + 2 * d * q + 2 * d * kv + 3 * d * cfg.d_ff
                + ((q + 2 * kv) if cfg.qkv_bias else 0))
        if cfg.family == "griffin":
            W = cfg.lru_width
            rec = 2 * norm + 3 * d * W + 2 * W * W + 8 * W + 3 * d * cfg.d_ff
            n_groups, rem = divmod(cfg.n_layers, 3)
            return n + n_groups * (2 * rec + attn) + rem * rec
        if cfg.ssm:
            H = cfg.d_inner // cfg.ssm_head_dim
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            layer = (norm + d * (cfg.d_inner + conv_dim + H) + 5 * conv_dim
                     + 3 * H + cfg.d_inner + cfg.d_inner * d)
        else:
            layer = attn
        return n + cfg.n_layers * layer

    # -- steps ----------------------------------------------------------------

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

    def init_cache(self, batch: int, max_seq: int, device) -> tuple:
        """Zero decode cache in the compute dtype on ``device``: (k, v) of
        [B, max_seq, n_kv, head_dim] per attention layer; dict(conv
        [B, 3, conv_dim], state [B, H, P, N]) per Mamba-2 layer; dict(conv
        [B, 3, lru_width], state [B, lru_width]) per RG-LRU layer. For
        ``decoder`` and ``gemma3`` it is ``(None, [per-layer cache])``; for
        ``griffin`` ``(groups, tail)``: a list of dict(rec1, rec2, attn)
        and a list of recurrent caches, or None without a tail."""
        cfg = self.cfg
        dt = cfg.compute_dtype

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=device)

        def kv():
            return (zeros(batch, max_seq, cfg.n_kv, cfg.head_dim_),
                    zeros(batch, max_seq, cfg.n_kv, cfg.head_dim_))

        if cfg.family == "griffin":
            def rec():
                return dict(conv=zeros(batch, 3, cfg.lru_width),
                            state=zeros(batch, cfg.lru_width))
            n_groups, rem = divmod(cfg.n_layers, 3)
            groups = [dict(rec1=rec(), rec2=rec(), attn=kv())
                      for _ in range(n_groups)]
            return (groups, [rec() for _ in range(rem)] if rem else None)
        if cfg.ssm:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            H = cfg.d_inner // cfg.ssm_head_dim
            layer = lambda: dict(conv=zeros(batch, 3, conv_dim),   # noqa
                                 state=zeros(batch, H, cfg.ssm_head_dim,
                                             cfg.ssm_state))
        else:
            layer = kv
        return (None, [layer() for _ in range(cfg.n_layers)])


def to_device(tree, device):
    """A copy of a parameter (or cache) tree with every tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
