"""AdamW with cosine schedule and global-norm clipping — the formula of
``repro/optim/adamw.py``, on parameter trees (nested dicts, lists and
tuples of tensors: the forecaster's float32 tree, an LM's bf16 one).

Not ``torch.optim.AdamW``: the reference evaluates the learning rate at the
incremented step (so warmup starts at 2/warmup), uses beta2 = 0.95, clips
the gradients' global norm before the moments, and decays every leaf
inside the update. The scalar schedule is computed in float32, as the
reference's traced schedule is.

Trees of DTensors (the sharded train step's parameters, gradients and
moments, ``runtime/train_loop.py``) work too: the moments mirror the
parameters' placements, the update runs on each rank's local blocks, and
the global norm sums each leaf's squares over the mesh axes the leaf is
sharded on, so every shard counts once. The step counter is a Python
integer, the same on every rank (replicated).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.runtime.sharding import is_dtensor


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (all trees
    of one shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (dict keys sorted, sequences in
    index order, depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s shape holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
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


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def as_placed(local, ref):
    """``local`` (a block) as a DTensor laid out as ``ref`` where ``ref``
    is a DTensor, else ``local`` as it is."""
    if not is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def _global_sum_of_squares(leaves) -> torch.Tensor:
    """sum(g ** 2) over every leaf in float32; a DTensor leaf's local
    squares summed over the mesh dimensions it is sharded on (one
    all-reduce per such set of dimensions), its replicas counted once."""
    groups, order = {}, []
    for g in leaves:
        key = ()
        if is_dtensor(g):
            key = tuple(i for i, p in enumerate(g.placements)
                        if p.is_shard())
            mesh = g.device_mesh
        part = torch.sum(torch.square(_local(g).to(torch.float32)))
        if key not in groups:
            order.append(key)
            groups[key] = [part, mesh if key else None]
        else:
            groups[key][0] = groups[key][0] + part
    total = 0
    for key in order:
        part, mesh = groups[key]
        if key:
            import torch.distributed as dist
            for i in key:
                dist.all_reduce(part, group=mesh.get_group(i))
        total = total + part
    return total


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    gn = torch.sqrt(_global_sum_of_squares(leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: as_placed((_local(g) * scale).to(g.dtype), g),
                    grads), gn


@dataclasses.dataclass(frozen=True)
class adamw:
    lr: Callable = cosine_schedule(3e-4, 100, 10000)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def z(p):
            return as_placed(
                torch.zeros_like(_local(p), dtype=torch.float32), p)
        return AdamWState(step=0, mu=tree_map(z, params),
                          nu=tree_map(z, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: as_placed(
            b1 * _local(m) + (1 - b1) * _local(g).to(torch.float32), m),
            state.mu, grads)
        nu = tree_map(lambda v, g: as_placed(
            b2 * _local(v) + (1 - b2)
            * torch.square(_local(g).to(torch.float32)), v),
            state.nu, grads)
        c1 = float(1 - _f32(b1) ** _f32(step))
        c2 = float(1 - _f32(b2) ** _f32(step))
        lr = self.lr(step)

        def upd(p_, m, v):
            p, m, v = _local(p_), _local(m), _local(v)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = u + self.weight_decay * p.to(torch.float32)
            return as_placed((p.to(torch.float32) - lr * u).to(p.dtype), p_)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu), gnorm
