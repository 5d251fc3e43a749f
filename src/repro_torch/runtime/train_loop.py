"""Step builders of the LM path — the counterpart of
``repro/runtime/train_loop.py``: ``make_train_step`` (loss, gradients
through each layer's remat, optional microbatch accumulation and int8
gradient compression, then the AdamW update), ``make_prefill_step`` and
``make_decode_step``.

Without a mesh the parameters are a plain tree (``Model.init``'s nested
dicts and lists of tensors) on one device; gradients come from
``torch.autograd.grad``. With ``mesh`` (a ``DeviceMesh`` with named
dimensions, over an initialised process group) the state lives sharded,
placed by its logical axes (``runtime/sharding.py``): parameters and
AdamW moments (``shard_train_state``), parameters and decode caches
(``shard_serve_state``) are DTensors. Every step takes the global batch,
the same on every rank; each rank computes its ``act_batch`` rows, and
each layer gathers its parameters just before use. In training each
gradient comes back to its parameter's placement, summed over the batch's
mesh axes and averaged as the global-batch loss is. A decode cache split
by ``cache_seq`` (batch 1 at long context, the reference's
sequence-parallel layout) stays split: decode attention combines its
segments across ranks (``models/attention.py``).

Ranks along ``model`` compute tensor-parallel where the rules split a
sub-layer over it: the embedding, the logits and the loss over the rank's
vocabulary rows, attention and MLA over its heads (an attention decode
cache's heads read and written in place; MLA's latent cache whole on
every rank), the dense MLPs over its columns, MoE over its experts (or
each expert's columns), the Mamba-2 mixer over its heads and the RG-LRU
block over its channels (their decode state in place), each gathered
over the other axes only (``sharding.local_params``). Only norms, gates
and MoE's router are gathered whole. The steps' logits come back
gathered over ``model``.

Where the rules split the residual stream over ``model`` — its sequence
(``act_seq`` to ``model``: the ``seqpar`` variants) or its embedding
(``act_embed`` to ``model``: ``act2d``) — each rank carries its block of
the stream between sub-layers, and each sub-layer gathers it on entry and
reduce-scatters its output (``sharding.sublayer_in`` / ``sublayer_out``);
the tokens and labels stay whole over ``model``.

Where the rules split the sequence over ``data`` (a train microbatch or a
prefill batch that ``data`` does not divide: the reference's fall-through
to ``act_seq``, and ``seqpar``'s over ``data`` and ``model``) each rank
takes its contiguous segment of every row's tokens, labels and frames
(``sharding.Layout.segment_axes``; the image patches stay whole) and the
model exchanges across segments what crosses their edges (context
parallelism). The loss and the gradients are averaged over the segments
as over the rows; a prefill's last logits are the last segment's, on
every rank, and its cache is placed by its logical axes (an attention
cache's positions are the rank's segment). A layout that would split an
embedding over ``data`` or ``pod`` raises
(``sharding.refuse_sequence_sharding``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.optim import compression
from repro_torch.optim.adamw import (as_placed, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.runtime import sharding


def make_train_step(model, opt, *, grad_accum: int = 1,
                    compress: Optional[str] = None, mesh=None):
    """Returns ``train_step(params, opt_state, batch, gen) -> (params,
    opt_state, dict(loss, grad_norm))``. ``batch`` holds tensors with the
    global batch on the leading axis; with ``grad_accum > 1`` it is split
    into that many microbatches there, whose float32 gradients and losses
    are summed and divided by ``grad_accum``, as the reference's scan
    does. ``compress="int8"`` round-trips the gradients through int8
    stochastic rounding (noise from ``gen``, a generator on the
    parameters' device; unused otherwise) before ``opt.update``.

    With ``mesh``, ``params`` and ``opt_state`` are DTensor trees
    (``shard_train_state``) and ``batch`` the global batch, the same on
    every rank; the loss returned is the global batch's. int8 compression
    rounds each rank's gradient blocks with its own draws."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    parts = train_parts(model, opt, compress, mesh)

    def train_step(params, opt_state, batch, gen=None):
        live = parts.live(params)
        loss, grads = accumulate(parts.grads, live, batch, grad_accum)
        params, opt_state, gnorm = parts.finish(params, opt_state, grads,
                                                gen)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return train_step


class TrainParts(NamedTuple):
    """A train step in three parts (``make_train_step`` runs them in
    turn; the dry run counts each on its own): ``live(params)`` the
    parameters as the loss takes them, ``grads(live, microbatch)`` ->
    (loss, gradient leaves), ``finish(params, opt_state, gradient leaves,
    gen)`` -> (params, opt_state, grad_norm): compression and the
    update."""
    live: object
    grads: object
    finish: object


def train_parts(model, opt, compress: Optional[str] = None,
                mesh=None) -> TrainParts:
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got "
                         f"{compress!r}")
    if mesh is not None:
        return _sharded_parts(model, opt, compress, mesh)

    def live(params):
        return tree_map(lambda t: t.detach().requires_grad_(True), params)

    def grads_of(live, batch):
        loss = model.loss(live, batch)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))

    def finish(params, opt_state, grads, gen=None):
        grads = tree_unflatten(params, grads)
        if compress == "int8":
            grads = compression.int8_roundtrip(grads, gen)
        return opt.update(grads, opt_state, params)

    return TrainParts(live, grads_of, finish)


def accumulate(grads_of, live, batch, grad_accum: int):
    """(loss, gradient leaves) of ``batch``: ``grads_of(live, batch)``, or
    with ``grad_accum > 1`` the mean over that many microbatches (leading
    rows) of their losses and float32 gradients."""
    if grad_accum == 1:
        return grads_of(live, batch)
    n = next(iter(batch.values())).shape[0]
    if n % grad_accum:
        raise ValueError(f"global batch {n} is not a multiple of "
                         f"grad_accum {grad_accum}")
    micro = n // grad_accum
    loss, acc = 0.0, None
    for i in range(grad_accum):
        mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
        mb_loss, g = grads_of(live, mb)
        loss = loss + mb_loss
        if acc is None:
            acc = [x.to(torch.float32) for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x)
        del g
    return loss / grad_accum, [a / grad_accum for a in acc]


def shard_train_state(model, params, opt, mesh, rules=None):
    """(params, opt_state) of a full parameter tree (the same on every
    rank) as DTensors on ``mesh``, placed by the parameters' logical axes;
    the moments mirror the parameters."""
    _, axes = model.abstract_params()
    specs = sharding.tree_specs(axes, params, mesh, rules)
    sharded = sharding.shard_tree(params, specs, mesh)
    return sharded, opt.init(sharded)


def shard_serve_state(model, params, cache, mesh, rules=None):
    """(params, cache) of a full parameter tree and a full decode cache
    (``Model.init_cache``; None for prefill alone), the same on every
    rank, as DTensors on ``mesh`` placed by their logical axes: the
    cache's rows over ``cache_batch``'s axes, its heads or channels over
    ``model``, and at a batch the batch axes do not divide (long context)
    its positions over ``cache_seq``'s."""
    _, axes = model.abstract_params()
    params = sharding.shard_tree(
        params, sharding.tree_specs(axes, params, mesh, rules), mesh)
    if cache is not None:
        _, caxes = _cache_axes(model)
        cache = sharding.shard_tree(
            cache, sharding.tree_specs(caxes, cache, mesh, rules), mesh)
    return params, cache


def _cache_axes(model):
    """(meta tree, logical axes tree) of every cache ``Model.init_cache``
    (and a prefill) builds: its structure, its axes and the sizes of its
    dimensions other than rows and lengths depend on no length."""
    return model.cache_axes(1, 1, src_len=1, n_img=1)


def _need_group(what: str, mesh) -> None:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what}(mesh=...) needs an initialised process group "
            f"(torch.distributed.init_process_group) whose ranks make up "
            f"the mesh; without one, call it with mesh=None")
    if not (mesh.mesh_dim_names or ()):
        raise ValueError("the mesh needs named dimensions (data, model, "
                         "and pod across pods)")


# Logical axes of each input's dimensions past the rows.
_INPUT_AXES = dict(tokens="act_seq", labels="act_seq", frames="act_seq",
                   patches="act_img")
# Inputs every ``model`` rank holds whole past its rows: the
# vocab-parallel embedding looks every position up in the rank's
# vocabulary rows, and the vocab-parallel loss reads every position of
# the head's output (whose entry gathered a split sequence).
_WHOLE_OVER_MODEL = ("tokens", "labels")


def _local_rows(model, mesh, batch):
    """This rank's rows of a (micro)batch of global rows, and the layout
    they make (``sharding.step_layout``: the residual stream's split over
    ``model``, if any, and its sequence's segments). ``frames`` and
    ``patches`` take the rank's block of what their rules split over
    ``model``, which must be the residual stream's dimension (the frames'
    sequence or embedding, the patches' embedding); ``tokens`` and
    ``labels`` only their rows. Under context parallelism every input's
    sequence but the patches' takes the rank's segment, which must be the
    residual stream's. A layout that would split anything else past the
    rows over another axis raises."""
    n, S = batch["tokens"].shape
    layout = sharding.step_layout(mesh, n, S, model.cfg.d_model)
    out = {}
    for k, v in batch.items():
        logical = ("act_batch", _INPUT_AXES[k], "act_embed")[:v.dim()]
        spec = sharding.spec_for(logical, v.shape, mesh)
        sharding.refuse_sequence_sharding(f"input {k}", logical, v.shape,
                                          spec, mesh)
        segments = sharding._segment_names(spec[1], mesh)
        if k != "patches" and segments != layout.segment_axes:
            raise NotImplementedError(
                f"input {k} {tuple(v.shape)} resolves to {spec}: its "
                f"sequence splits over {segments}, the residual stream's "
                f"over {layout.segment_axes}")
        if k in _WHOLE_OVER_MODEL:
            spec = spec[:1] + (segments or None,) + (None,) * (v.dim() - 2)
        else:
            dims = sharding._model_dims(logical, spec)
            want = layout.split if k == "frames" else (
                sharding.EMBED if layout.split == sharding.EMBED else None)
            if (dims[0] if dims else None) != want:
                raise NotImplementedError(
                    f"input {k} {tuple(v.shape)} resolves to {spec}, split "
                    f"over model at {dims}; the residual stream's layout "
                    f"needs it split at {want}")
        out[k] = v[sharding.local_slices(
            spec, v.shape, sharding.mesh_sizes(mesh),
            sharding.coordinates(mesh))]
    return out, layout


def _sharded_leaves(model, params, requires_grad: bool):
    """Each DTensor parameter as a ``ShardedLeaf`` of its local block,
    flagged where its sub-layer computes tensor-parallel
    (``Model.tensor_parallel_mask``)."""
    from torch.distributed.tensor import DTensor
    if not all(isinstance(p, DTensor) for p in tree_leaves(params)):
        raise TypeError("with a mesh the parameters must be DTensors "
                        "(shard_train_state / shard_serve_state)")

    def leaf(p, tp):
        local = p.to_local().detach()
        return sharding.ShardedLeaf(
            local.requires_grad_(True) if requires_grad else local,
            p.placements, p.device_mesh, tp)
    return tree_map(leaf, params, model.tensor_parallel_mask(params))


def _serving_leaves(model):
    """``live(params)``: the serving steps' ``ShardedLeaf`` tree of a
    DTensor tree, built once per parameter tree object (a serving loop
    passes the same tree every step; the blocks are views of its
    DTensors, so values written into them in place are seen). A new tree
    object builds anew."""
    memo = [None, None]

    def live(params):
        if memo[0] is not params:
            memo[:] = [params, _sharded_leaves(model, params, False)]
        return memo[1]
    return live


def _sharded_parts(model, opt, compress, mesh) -> TrainParts:
    import torch.distributed as dist
    _need_group("make_train_step", mesh)
    names = list(mesh.mesh_dim_names)

    def grads_of(live, mb):
        rows, layout = _local_rows(model, mesh, mb)
        locals_ = [leaf.local for leaf in tree_leaves(live)]
        with sharding.activation_layout(layout):
            loss = model.loss(live, rows)
            grads = torch.autograd.grad(loss, locals_)
        loss = loss.detach()
        if layout.mean_ways > 1:
            for name in layout.mean_axes:
                dist.all_reduce(loss, group=mesh.get_group(
                    names.index(name)))
            loss = loss / layout.mean_ways
        return loss, grads

    def finish(params, opt_state, grads, gen=None):
        grads = tree_unflatten(params, grads)
        if compress == "int8":
            grads = compression.int8_roundtrip(grads, gen)
        grads = tree_map(as_placed, grads, params)
        return opt.update(grads, opt_state, params)

    return TrainParts(lambda params: _sharded_leaves(model, params, True),
                      grads_of, finish)


def make_prefill_step(model, mesh=None):
    """``prefill_step(params, batch) -> (last logits, cache)``. With
    ``mesh``: ``params`` a DTensor tree (``shard_serve_state``) and
    ``batch`` the global batch, the same on every rank; the logits are
    this rank's rows over the whole vocabulary and the cache its blocks,
    as DTensors placed by the cache's logical axes at the global batch."""
    if mesh is None:
        def prefill_step(params, batch):
            return model.prefill(params, batch)
        return prefill_step
    _need_group("make_prefill_step", mesh)
    full, axes = _cache_axes(model)
    live = _serving_leaves(model)

    def sharded_prefill_step(params, batch):
        rows, layout = _local_rows(model, mesh, batch)
        with sharding.activation_layout(layout):
            logits, cache = model.prefill(live(params), rows)
        return logits, sharding.place_cache(cache, axes, layout, full)
    return sharded_prefill_step


def make_decode_step(model, mesh=None):
    """``decode_step(params, cache, tokens, pos) -> (next tokens, logits,
    cache)``, the next tokens int32 [B, 1], as the reference's. With ``mesh``: ``params`` and ``cache`` DTensor trees
    (``shard_serve_state``, or a sharded prefill's cache spliced into
    one) and ``tokens`` the global [B, 1], the same on every rank; the
    tokens and logits returned are this rank's rows (the logits over the
    whole vocabulary, so the argmax is the unsharded one's), and the
    cache's blocks are written in place and returned."""
    if mesh is None:
        def decode_step(params, cache, tokens, pos):
            logits, cache = model.decode(params, cache, tokens, pos)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            return next_tok, logits, cache
        return decode_step
    _need_group("make_decode_step", mesh)
    _, axes = _cache_axes(model)
    live = _serving_leaves(model)
    # The cache's blocks, built once per cache tree object and rows
    # layout (a decode loop passes the tree it was given back; the blocks
    # are views of its DTensors, written in place).
    memo = [None, None, None]

    def sharded_decode_step(params, cache, tokens, pos):
        rows, layout = _local_rows(model, mesh, dict(tokens=tokens))
        if memo[0] is not cache or memo[1] != layout:
            memo[:] = [cache, layout,
                       sharding.cache_blocks(cache, axes, layout)]
        blocks, layout = memo[2]
        with sharding.activation_layout(layout):
            logits, _ = model.decode(live(params), blocks, rows["tokens"],
                                     pos)
        return (torch.argmax(logits, dim=-1).to(torch.int32)[:, None],
                logits, cache)
    return sharded_decode_step
