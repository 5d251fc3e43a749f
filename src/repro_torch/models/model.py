"""Model facade: init, abstract parameters with their logical axes, the
parameter count, the training loss, prefill, decode, the decode cache and
step inputs — the counterpart of ``repro/models/model.py`` for every
family (KV caches for attention, latent caches for MLA, conv + state
caches for Mamba-2 and the RG-LRU, static image and encoder K/V for
cross-attention).

Every parameter, cache and input leaf is built once, as ``P(value,
axes)`` with the reference's logical axes: ``init``, ``init_cache`` and
``make_inputs`` return the values, ``abstract_params``, ``cache_axes``
and ``abstract_inputs`` the same trees on the meta device with their
axes, and ``runtime/sharding.py`` resolves the axes to mesh placements.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.common import META, P, split_tree, softmax_xent
from repro_torch.runtime import sharding


class Model:
    def __init__(self, cfg):
        transformer.check_supported(cfg)
        self.cfg = cfg

    # -- params ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> dict:
        """Parameters drawn from ``gen`` on its device (the reference's
        init: zero biases, zero conv and SSM scalars); ``to_device`` moves
        them."""
        return split_tree(transformer.init(self.cfg, gen))[0]

    def abstract_params(self):
        """(meta-tensor tree, logical-axes tree) of ``init``'s tree: the
        shapes and dtypes, and each leaf's axes, with nothing drawn or
        allocated."""
        return split_tree(transformer.init(self.cfg, META))

    def tensor_parallel_mask(self, params):
        """``params``'s tree with True at the leaves of the sub-layers
        that compute tensor-parallel over ``model`` in the sharded steps
        (``transformer.tensor_parallel_mask``)."""
        return transformer.tensor_parallel_mask(params)

    def param_count(self) -> int:
        """Parameters of the tree ``init`` builds, from
        ``abstract_params``."""
        shapes, _ = self.abstract_params()
        return sum(t.numel() for t in tree_tensors(shapes))

    # -- steps ----------------------------------------------------------------

    def loss(self, params, batch):
        """Mean next-token cross-entropy (float32) of ``batch``: tokens
        and labels [B, S] integer tensors on the parameters' device, and
        ``frames`` or ``patches`` as ``prefill`` takes them. Train mode:
        each layer under ``cfg.remat``. In a sharded step whose head
        splits the vocabulary over ``model``, the loss is vocab-parallel
        (``softmax_xent``'s ``tp``). A rank's loss is the mean over its
        rows and its segment of the sequence; the sharded step averages
        it over them (``sharding.Layout.mean_axes``: every rank's tokens
        are an equal share)."""
        logits, _ = transformer.apply(self.cfg, params, batch, "train")
        return softmax_xent(logits, batch["labels"],
                            sharding.model_split(params["embed"]))

    def prefill(self, params, batch):
        """(the last position's logits over the whole vocabulary, the
        built cache). Under context parallelism the last position is the
        last segment's, its logits all-gathered to every rank."""
        logits, cache = transformer.apply(self.cfg, params, batch, "prefill")
        last = logits[:, -1]
        cp = sharding.context_parallel()
        if cp is not None:
            last = cp.stack(last)[-1]
        return _whole_vocab(last, params), cache

    def decode(self, params, cache, tokens, pos: int):
        """One token per row at position ``pos``; the KV caches are
        written in place and returned, with the logits over the whole
        vocabulary."""
        logits, cache = transformer.apply(self.cfg, params,
                                          dict(tokens=tokens), "decode",
                                          cache=cache, decode_pos=pos)
        return _whole_vocab(logits[:, 0], params), cache

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
        return split_tree(self._cache_tree(batch, max_seq, device,
                                           src_len, n_img))[0]

    def cache_axes(self, batch: int, max_seq: int, *, src_len: int = 0,
                   n_img: int = 0):
        """(meta-tensor tree, logical-axes tree) of ``init_cache``'s tree
        (the reference's axes: ``cache_batch``, ``cache_seq``,
        ``cache_img``, ``kv_heads``, ``mla_latent``, ``rope_dim``,
        ``conv``, ``conv_channels`` ...), with nothing allocated."""
        return split_tree(self._cache_tree(batch, max_seq, "meta", src_len,
                                           n_img))

    def _cache_tree(self, batch, max_seq, device, src_len, n_img):
        cfg = self.cfg
        dt = cfg.compute_dtype

        def zeros(axes, *shape):
            return P(torch.zeros(shape, dtype=dt, device=device), axes)

        def kv(length=max_seq, seq="cache_seq"):
            axes = ("cache_batch", seq, "kv_heads", "head_dim")
            return (zeros(axes, batch, length, cfg.n_kv, cfg.head_dim_),
                    zeros(axes, batch, length, cfg.n_kv, cfg.head_dim_))

        if cfg.family == "griffin":
            def rec():
                return dict(conv=zeros(("cache_batch", "conv", "mlp"),
                                       batch, 3, cfg.lru_width),
                            state=zeros(("cache_batch", "mlp"), batch,
                                        cfg.lru_width))
            n_groups, rem = divmod(cfg.n_layers, 3)
            groups = [dict(rec1=rec(), rec2=rec(), attn=kv())
                      for _ in range(n_groups)]
            return (groups, [rec() for _ in range(rem)] if rem else None)
        if cfg.family == "vision":
            per = cfg.cross_every
            return [dict(img=kv(n_img, "cache_img"),
                         selfs=[kv() for _ in range(per - 1)])
                    for _ in range(cfg.n_layers // per)]
        if cfg.family == "encdec":
            return [dict(self=kv(), cross=kv(src_len, "cache_img"))
                    for _ in range(cfg.n_layers)]
        if cfg.ssm:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            H = cfg.d_inner // cfg.ssm_head_dim

            def layer():
                return dict(
                    conv=zeros(("cache_batch", "conv", "conv_channels"),
                               batch, 3, conv_dim),
                    state=zeros(("cache_batch", "heads", "head_dim",
                                 "ssm_state"), batch, H, cfg.ssm_head_dim,
                                cfg.ssm_state))
        elif cfg.mla:
            def layer():
                return (zeros(("cache_batch", "cache_seq", "mla_latent"),
                              batch, max_seq, cfg.kv_lora),
                        zeros(("cache_batch", "cache_seq", "rope_dim"),
                              batch, max_seq, cfg.d_rope))
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
        Tokens are int32, as the reference's; frames [B, S, d] and patches
        [B, n_img_tokens, d] in the compute dtype."""
        return split_tree(self._input_tree(shape, device, enc_ctx))[0]

    def abstract_inputs(self, shape, enc_ctx: int = 4096):
        """(meta-tensor tree, logical-axes tree) of ``make_inputs``'s tree
        (tokens ``act_batch, act_seq``; frames and patches ``act_batch,
        act_seq | act_img, act_embed``; the cache's as ``cache_axes``)."""
        return split_tree(self._input_tree(shape, "meta", enc_ctx))

    def _input_tree(self, shape, device, enc_ctx):
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        dt = cfg.compute_dtype

        def tok(s):
            return P(torch.zeros((B, s), dtype=torch.int32, device=device),
                     ("act_batch", "act_seq"))
        out: Dict[str, Any] = {}
        if shape.kind in ("train", "prefill"):
            out["tokens"] = tok(S)
            if shape.kind == "train":
                out["labels"] = tok(S)
            if cfg.family == "encdec":
                out["frames"] = P(torch.zeros((B, S, cfg.d_model), dtype=dt,
                                              device=device),
                                  ("act_batch", "act_seq", "act_embed"))
            if cfg.family == "vision":
                out["patches"] = P(torch.zeros(
                    (B, cfg.n_img_tokens, cfg.d_model), dtype=dt,
                    device=device), ("act_batch", "act_img", "act_embed"))
        elif shape.kind == "decode":
            out["tokens"] = tok(1)
            out["cache"] = self._cache_tree(
                B, S, device, enc_ctx if cfg.family == "encdec" else 0,
                cfg.n_img_tokens)
        else:
            raise ValueError(f"unknown shape kind {shape.kind!r}")
        return out


def _whole_vocab(logits, params):
    """Logits the head computed over the rank's vocabulary rows (a sharded
    step on a ``model`` axis that splits them) gathered over ``model``;
    others as they are."""
    tp = sharding.model_split(params["embed"])
    return logits if tp is None else tp.gather(logits, -1)


def tree_tensors(tree) -> list:
    """The tensor leaves of a tree of dicts, lists and tuples (None
    skipped), depth first."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return [] if tree is None else [tree]


def to_device(tree, device):
    """A copy of a parameter (or cache) tree with every tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
