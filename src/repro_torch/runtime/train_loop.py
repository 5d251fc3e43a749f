"""Step builders of the LM path — the counterpart of
``repro/runtime/train_loop.py``: ``make_train_step`` (loss, gradients
through each layer's remat, optional microbatch accumulation and int8
gradient compression, then the AdamW update), ``make_prefill_step`` and
``make_decode_step``.

Parameters are a plain tree (``Model.init``'s nested dicts and lists of
tensors) on one device; gradients come from ``torch.autograd.grad``.
Sharding the state across cards is ROADMAP queue 1 item 3.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim import compression
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def make_train_step(model, opt, *, grad_accum: int = 1,
                    compress: Optional[str] = None):
    """Returns ``train_step(params, opt_state, batch, gen) -> (params,
    opt_state, dict(loss, grad_norm))``. ``batch`` holds tensors with the
    global batch on the leading axis; with ``grad_accum > 1`` it is split
    into that many microbatches there, whose float32 gradients and losses
    are summed and divided by ``grad_accum``, as the reference's scan
    does. ``compress="int8"`` round-trips the gradients through int8
    stochastic rounding (noise from ``gen``, a generator on the
    parameters' device; unused otherwise) before ``opt.update``."""
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got "
                         f"{compress!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def grads_of(live, batch):
        loss = model.loss(live, batch)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))

    def train_step(params, opt_state, batch, gen=None):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"global batch {n} is not a multiple of "
                                 f"grad_accum {grad_accum}")
            micro = n // grad_accum
            loss, acc = 0.0, None
            for i in range(grad_accum):
                mb = {k: v[i * micro:(i + 1) * micro]
                      for k, v in batch.items()}
                mb_loss, g = grads_of(live, mb)
                loss = loss + mb_loss
                if acc is None:
                    acc = [x.to(torch.float32) for x in g]
                else:
                    for a, x in zip(acc, g):
                        a.add_(x)
                del g
            loss = loss / grad_accum
            grads = [a / grad_accum for a in acc]
            del acc
        else:
            loss, grads = grads_of(live, batch)
        grads = tree_unflatten(params, grads)
        if compress == "int8":
            grads = compression.int8_roundtrip(grads, gen)
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
