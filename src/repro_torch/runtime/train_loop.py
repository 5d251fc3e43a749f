"""Step builders of the LM path — the counterpart of
``repro/runtime/train_loop.py``: ``make_train_step`` (loss, gradients
through each layer's remat, optional microbatch accumulation and int8
gradient compression, then the AdamW update), ``make_prefill_step`` and
``make_decode_step``.

Without a mesh the parameters are a plain tree (``Model.init``'s nested
dicts and lists of tensors) on one device; gradients come from
``torch.autograd.grad``. With ``mesh`` (a ``DeviceMesh`` with named
dimensions, over an initialised process group) the state lives sharded:
parameters and AdamW moments are DTensors placed by the parameters'
logical axes (``runtime/sharding.py``), each rank takes its ``act_batch``
rows of each microbatch, each layer gathers its parameters just before use
inside its remat, and each gradient comes back to its parameter's
placement, summed over the batch's mesh axes and averaged as the
global-batch loss is. Ranks along ``model`` compute the same rows: the
``model`` axis shards storage only; tensor-parallel compute on it, and
sequence sharding, are ROADMAP queue 1's next distribution items.
"""
from __future__ import annotations

from typing import Optional

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
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got "
                         f"{compress!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None:
        return _sharded_train_step(model, opt, grad_accum, compress, mesh)

    def grads_of(live, batch):
        loss = model.loss(live, batch)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))

    def train_step(params, opt_state, batch, gen=None):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, grads = _accumulate(grads_of, live, batch, grad_accum)
        grads = tree_unflatten(params, grads)
        if compress == "int8":
            grads = compression.int8_roundtrip(grads, gen)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return train_step


def _accumulate(grads_of, live, batch, grad_accum: int):
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


def _sharded_train_step(model, opt, grad_accum, compress, mesh):
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_train_step(mesh=...) needs an initialised process group "
            "(torch.distributed.init_process_group) whose ranks make up "
            "the mesh; without one, call it with mesh=None")
    names = list(mesh.mesh_dim_names or ())
    if not names:
        raise ValueError("the mesh needs named dimensions (data, model, "
                         "and pod across pods)")

    def local_rows(mb):
        """This rank's rows of a microbatch, and the layout they make."""
        kinds = dict(tokens="act_seq", labels="act_seq", frames="act_seq",
                     patches="act_img")
        n = next(iter(mb.values())).shape[0]
        axes = sharding.batch_axes(n, mesh)
        layout = sharding.Layout(mesh, n, axes)
        out = {}
        for k, v in mb.items():
            logical = ("act_batch", kinds[k], "act_embed")[:v.dim()]
            spec = sharding.spec_for(logical, v.shape, mesh)
            sharding.refuse_sequence_sharding(f"input {k}", v.shape, spec)
            out[k] = v[sharding.local_slices(
                spec, v.shape, sharding.mesh_sizes(mesh),
                sharding.coordinates(mesh))]
        return out, layout

    def grads_of(live, mb):
        rows, layout = local_rows(mb)
        locals_ = [leaf.local for leaf in tree_leaves(live)]
        with sharding.activation_layout(layout):
            loss = model.loss(live, rows)
            grads = torch.autograd.grad(loss, locals_)
        loss = loss.detach()
        if layout.batch_ways > 1:
            for name in layout.batch_axes:
                dist.all_reduce(loss, group=mesh.get_group(
                    names.index(name)))
            loss = loss / layout.batch_ways
        return loss, grads

    def train_step(params, opt_state, batch, gen=None):
        from torch.distributed.tensor import DTensor
        if not all(isinstance(p, DTensor) for p in tree_leaves(params)):
            raise TypeError("with a mesh the parameters must be DTensors "
                            "(shard_train_state)")
        live = tree_map(lambda p: sharding.ShardedLeaf(
            p.to_local().detach().requires_grad_(True), p.placements,
            p.device_mesh), params)
        loss, grads = _accumulate(grads_of, live, batch, grad_accum)
        grads = tree_unflatten(params, grads)
        if compress == "int8":
            grads = compression.int8_roundtrip(grads, gen)
        grads = tree_map(as_placed, grads, params)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens, pos):
        logits, cache = model.decode(params, cache, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1)[:, None]
        return next_tok, logits, cache
    return decode_step
