"""AdamW with cosine schedule and global-norm clipping — the formula of
``repro/optim/adamw.py``, on parameter trees (nested dicts of tensors).

Not ``torch.optim.AdamW``: the reference evaluates the learning rate at the
incremented step (so warmup starts at 2/warmup), uses beta2 = 0.95, clips
the gradients' global norm before the moments, and decays every leaf
inside the update. The scalar schedule is computed in float32, as the
reference's traced schedule is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (all trees of one shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s shape holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return float(_f32(peak_lr) * _f32(step + 1) / max(warmup, 1))
        frac = torch.clamp(_f32(step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return float(peak_lr * (floor + cos))
    return lr


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


@dataclasses.dataclass(frozen=True)
class adamw:
    lr: Callable = cosine_schedule(3e-4, 100, 10000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=0, mu=tree_map(z, params),
                          nu=tree_map(z, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                      * torch.square(g.to(torch.float32)), state.nu, grads)
        c1 = float(1 - _f32(b1) ** _f32(step))
        c2 = float(1 - _f32(b2) ** _f32(step))
        lr = self.lr(step)

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu), gnorm
