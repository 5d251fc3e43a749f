"""Logical axes → mesh specs → DTensor placements — the counterpart of
``repro/runtime/sharding.py``.

Every parameter, cache and input leaf carries a tuple of *logical* axis
names (``models/common.P``). Rules map logical names to (ordered)
mesh-axis candidates. Resolution is left-to-right per tensor with the
reference's two safeguards:

  * divisibility — a mesh assignment is dropped (progressively, from the
    left of the candidate tuple) until the dimension divides evenly;
  * no-reuse — a mesh axis already consumed by an earlier dimension of the
    same tensor is skipped.

``DEFAULT_RULES``, ``active_rules``, ``rule_overrides``, ``resolve_axis``,
``spec_for`` and ``tree_specs`` are the reference's, 1:1. A spec is a
tuple with one entry per tensor dimension — None, a mesh axis name, or a
tuple of names — equal to ``tuple(PartitionSpec(...))``. They read only
``mesh.shape`` as a mapping of axis sizes (a ``MeshShape``, or any object
with such a ``.shape``), or a ``DeviceMesh``'s names and sizes, so they
need no process group.

The rest is PyTorch's idiom:

  * ``placements(spec, mesh)`` — per mesh dimension, ``Shard(d)`` where
    tensor dimension ``d`` uses that mesh axis, else ``Replicate()``. A
    tuple such as ``("pod", "data")`` on one tensor dimension nests in
    JAX's major-to-minor order, which is DTensor's order when the names
    follow the mesh's order.
  * ``local_shape`` / ``local_slices(spec, shape, mesh_shape, coords)`` —
    the block of a tensor a mesh coordinate holds (pure arithmetic: the
    dry run and the tests use it without ranks).
  * ``shard_tree(tree, specs, mesh)`` — each leaf placed on the mesh by
    its spec (``distribute_tensor``); ``gather_tree`` the inverse.
  * ``constraint(x, axes, mesh)`` — the local block of a full tensor.
  * ``ShardedLeaf`` / ``materialize`` and ``activation_layout`` — the
    sharded steps' gather of a layer's parameters just before use, whose
    backward (training) sums the gradient over the batch's mesh axes and
    averages it as the global-batch loss is (``runtime/train_loop.py``).
  * ``CacheBlock`` / ``write_back`` / ``place_cache`` and ``Segment`` —
    the sharded serving steps' caches. A leaf split over ``model`` (by
    ``kv_heads``, ``heads``, ``mlp`` or ``conv_channels``) is gathered
    before its layer uses it, and the layer writes back only the rank's
    own block (storage only, like the parameters). A leaf split by
    ``cache_seq`` is never gathered: each rank keeps its segment of
    positions, only the owner of the decoded position writes it, and
    decode attention combines the segments (``models/attention.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

# Ordered logical rules. Values are mesh-axis candidate tuples (sharded over
# the product of the surviving axes).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # parameters
    "layers": (),
    "embed": ("data",),              # FSDP: params over data, TP over model
    "embed_nosplit": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "mlp_in": (),
    "vocab": ("model",),
    "experts": ("model",),
    "mla_latent": (),
    "rope_dim": (),
    "conv": (),
    "conv_channels": ("model",),
    "ssm_state": (),
    "heads_nosplit": (),
    "scalar": (),
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": ("data",),
    "act_embed": (),
    "act_img": (),
    "act_vocab": ("model",),
    # caches (ordering + no-reuse ⇒ batch-sharded OR sequence-sharded)
    "cache_batch": ("pod", "data"),
    "cache_seq": ("data",),
    "cache_img": (),
}

_ACTIVE_RULES: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)


def active_rules() -> Dict[str, Tuple[str, ...]]:
    return _ACTIVE_RULES


@contextlib.contextmanager
def rule_overrides(overrides: Optional[Dict] = None):
    """Temporarily replace the process-wide rule set (the dry run's
    variants plumb their sharding changes into ``constrain`` here)."""
    global _ACTIVE_RULES
    prev = _ACTIVE_RULES
    _ACTIVE_RULES = dict(DEFAULT_RULES, **(overrides or {}))
    try:
        yield _ACTIVE_RULES
    finally:
        _ACTIVE_RULES = prev


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or ranks."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def is_dtensor(t) -> bool:
    """A DTensor (checked without importing ``torch.distributed`` for a
    plain tensor)."""
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (whose ``.shape`` is a tuple),
    a ``MeshShape``, or any object whose ``.shape`` is such a mapping."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a mesh for logical axes needs named dimensions")
    return dict(zip(names, tuple(shape)))


def resolve_axis(name: str, dim: int, mesh, used: set,
                 rules: Dict[str, Tuple[str, ...]]):
    """Mesh assignment for one tensor dimension (None / str / tuple)."""
    sizes = mesh_sizes(mesh)
    cand = [a for a in rules.get(name, ()) if a in sizes and a not in used]
    while cand:
        total = math.prod(sizes[a] for a in cand)
        if dim % total == 0 and total > 1:
            used.update(cand)
            return tuple(cand) if len(cand) > 1 else cand[0]
        cand = cand[1:]          # drop the leading (largest-scope) axis
    return None


def spec_for(axes: Sequence[str], shape: Sequence[int], mesh,
             rules: Optional[Dict] = None) -> tuple:
    rules = rules or active_rules()
    used: set = set()
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} for shape {tuple(shape)}")
    return tuple(resolve_axis(a, int(d), mesh, used, rules)
                 for a, d in zip(axes, shape))


def is_axes(x) -> bool:
    """A logical-axes (or spec) leaf: a tuple of names / None / tuples."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def map_axes(fn, axes_tree, shape_tree):
    """``fn(axes, leaf)`` over an axes (or spec) tree and a tensor tree of
    one structure; axes tuples are leaves; None stays None."""
    if axes_tree is None:
        return None
    if is_axes(axes_tree) and not isinstance(shape_tree, (list, tuple)):
        return fn(axes_tree, shape_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], shape_tree[k])
                for k in axes_tree}
    return type(axes_tree)(map_axes(fn, a, s)
                           for a, s in zip(axes_tree, shape_tree))


def tree_specs(axes_tree, shape_tree, mesh, rules: Optional[Dict] = None):
    """Spec tree from (logical-axes tree, tensor or meta-tensor tree) —
    the reference's ``tree_shardings`` without the ``NamedSharding``."""
    return map_axes(lambda axes, t: spec_for(axes, t.shape, mesh, rules),
                 axes_tree, shape_tree)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_order(spec, names: Sequence[str]) -> None:
    for entry in spec:
        idx = [names.index(n) for n in _names(entry)]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec {spec}: mesh axes {_names(entry)} on one dimension "
                f"out of the mesh's order {tuple(names)}")


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh
    dimension)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    _check_order(spec, names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for n in _names(entry):
            out[names.index(n)] = Shard(d)
    return out


def _blocks(spec, mesh_shape: Dict[str, int], coords: Dict[str, int]):
    """Per tensor dimension: (number of blocks, this coordinate's block)
    — nested major-to-minor over the dimension's mesh axes."""
    out = []
    for entry in spec:
        n, idx = 1, 0
        for name in _names(entry):
            n, idx = n * mesh_shape[name], idx * mesh_shape[name] + \
                coords[name]
        out.append((n, idx))
    return out


def local_shape(spec, shape, mesh_shape: Dict[str, int]) -> tuple:
    """The block shape each mesh coordinate holds (specs divide evenly)."""
    return tuple(d // math.prod(mesh_shape[n] for n in _names(e))
                 for e, d in zip(spec, shape))


def local_slices(spec, shape, mesh_shape: Dict[str, int],
                 coords: Dict[str, int]) -> tuple:
    """The slices of a ``shape`` tensor that mesh coordinate ``coords``
    ({axis: index}) holds under ``spec``."""
    out = []
    for (n, idx), d in zip(_blocks(spec, mesh_shape, coords), shape):
        size = d // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def coordinates(mesh) -> Dict[str, int]:
    """{axis name: this rank's index} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def spec_of(placements_, mesh) -> tuple:
    """The spec of a DTensor's ``placements`` (the inverse of
    ``placements``)."""
    from torch.distributed.tensor import Shard
    names = list(mesh.mesh_dim_names)
    ndim = max([p.dim for p in placements_ if isinstance(p, Shard)],
               default=-1) + 1
    by_dim = [[] for _ in range(ndim)]
    for name, p in zip(names, placements_):
        if isinstance(p, Shard):
            by_dim[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} is neither Shard nor "
                             f"Replicate")
    return tuple(None if not n else (n[0] if len(n) == 1 else tuple(n))
                 for n in by_dim)


def _pad(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def constraint(x: torch.Tensor, axes: Sequence[str], mesh,
               rules=None) -> torch.Tensor:
    """The block of the full tensor ``x`` that this rank holds when ``x``
    is laid out by its logical ``axes`` on ``mesh`` (the reference's
    ``with_sharding_constraint`` by logical axes, for a tensor every rank
    has whole)."""
    spec = spec_for(axes, x.shape, mesh, rules)
    return x[local_slices(spec, x.shape, mesh_sizes(mesh),
                          coordinates(mesh))]


def _from_local(local, mesh, placements_, shape):
    from torch.distributed.tensor import DTensor
    full = torch.empty(shape, dtype=local.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=full.shape, stride=full.stride())


def shard_leaf(t: torch.Tensor, spec, mesh):
    """``t`` (the full tensor, the same on every rank) as a DTensor placed
    by ``spec``: each rank keeps its own block, with no communication
    (``distribute_tensor``'s result, which would scatter from rank 0)."""
    if not t.is_contiguous():
        t = t.contiguous()
    local = t[local_slices(spec, t.shape, mesh_sizes(mesh),
                           coordinates(mesh))].contiguous()
    return _from_local(local, mesh, placements(spec, mesh), t.shape)


def shard_tree(tree, specs, mesh):
    """Each tensor leaf of ``tree`` placed on ``mesh`` by its spec
    (``specs`` from ``tree_specs``): a tree of DTensors."""
    return map_axes(lambda spec, t: shard_leaf(t, spec, mesh), specs, tree)


def gather_tree(tree):
    """Every DTensor leaf as its full tensor (a collective: every rank
    calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    def full(t):
        return _gather(t.to_local(), t.placements, t.device_mesh) \
            if isinstance(t, DTensor) else t
    return _tree_map(full, tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _gather(local: torch.Tensor, placements_, mesh) -> torch.Tensor:
    """The full tensor of a block laid out by ``placements_``: all-gathers
    along each sharded mesh dimension, innermost first, so nested shards
    come back in their major-to-minor order."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    out = local.contiguous()
    for i in reversed(range(len(placements_))):
        p = placements_[i]
        if not isinstance(p, Shard):
            continue
        group = mesh.get_group(i)
        parts = [torch.empty_like(out) for _ in range(mesh.size(i))]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, dim=p.dim)
    return out


# ---------------------------------------------------------------------------
# The sharded step's parameter gather and activation layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Layout:
    """How a sharded step lays activations out: the mesh, the global rows
    of one microbatch (or serving batch) and the mesh axes its rows are
    split over (``act_batch``'s resolution); in decode, the mesh axes the
    caches' ``cache_seq`` is split over and its global length (empty and
    0 when the caches hold every position)."""
    mesh: object
    global_batch: int
    batch_axes: Tuple[str, ...]
    seq_axes: Tuple[str, ...] = ()
    seq_len: int = 0

    @property
    def batch_ways(self) -> int:
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)


_LAYOUT: Optional[Layout] = None


def current_layout() -> Optional[Layout]:
    return _LAYOUT


@contextlib.contextmanager
def activation_layout(layout: Layout):
    global _LAYOUT
    prev, _LAYOUT = _LAYOUT, layout
    try:
        yield layout
    finally:
        _LAYOUT = prev


def batch_axes(global_batch: int, mesh, rules=None) -> Tuple[str, ...]:
    """The mesh axes ``act_batch`` resolves to for ``global_batch`` rows."""
    return _names(spec_for(("act_batch",), (global_batch,), mesh,
                           rules)[0])


# Activation axes a sharded step may leave whole where the rules would
# split them: the logits' vocabulary is computed whole on every rank
# (vocab-parallel logits are tensor-parallel compute, ROADMAP queue 1).
_WHOLE_OK = ("act_vocab",)


def refuse_sequence_sharding(what: str, axes, shape, spec) -> None:
    """Raise where an activation's layout would split anything but its
    batch rows: its sequence (the reference's fall-through to ``act_seq``
    when the batch does not divide, or the ``seqpar`` variants) or its
    embedding (``act2d``). The sharded steps compute whole rows, and never
    replicate such a layout quietly. A cache's ``cache_seq`` is not an
    activation: the serving steps split it (``Segment``)."""
    split = [a for a, e in zip(axes[1:], spec[1:])
             if e is not None and a not in _WHOLE_OK]
    if split:
        raise NotImplementedError(
            f"{what} {tuple(shape)} resolves to {spec}: beyond its batch "
            f"rows it would be sharded ({', '.join(split)}), which waits "
            f"for sequence sharding of activations and tensor-parallel "
            f"compute (ROADMAP queue 1, the distribution items)")


def check_rows(x, axes, layout: Layout):
    """``x``, an activation of this rank's rows of the batch, checked
    against ``layout``: its logical ``axes`` on the global shape must
    split the batch rows over the layout's axes and nothing else
    (``refuse_sequence_sharding``; the logits' vocabulary stays whole on
    every rank in this slice, whatever the rules say of it)."""
    shape = (layout.global_batch,) + tuple(x.shape[1:])
    spec = spec_for(axes, shape, layout.mesh)
    refuse_sequence_sharding(f"activation {tuple(axes)}", axes, shape, spec)
    want = layout.global_batch // layout.batch_ways
    if _names(spec[0]) != layout.batch_axes or x.shape[0] != want:
        raise ValueError(f"activation rows {x.shape[0]} over "
                         f"{_names(spec[0])}, the layout's {want} over "
                         f"{layout.batch_axes}")
    return x


class ShardedLeaf:
    """A parameter's local block (a leaf tensor requiring grad) and its
    placement: what the sharded step hands the model instead of the
    parameter. ``materialize`` gathers it just before use."""
    __slots__ = ("local", "placements", "mesh")

    def __init__(self, local, placements_, mesh):
        self.local, self.placements, self.mesh = (local, tuple(placements_),
                                                  mesh)


class _GatherParam(torch.autograd.Function):
    """Forward: the full parameter from its block. Backward: the full
    gradient, which covers only this rank's rows of the batch, summed over
    the batch's mesh axes and divided by their size (the loss is the mean
    over the global batch), then this rank's block of it. Ranks along
    other axes (``model``) computed the same rows, so their gradients are
    not summed."""

    @staticmethod
    def forward(ctx, local, leaf: ShardedLeaf, layout: Layout):
        ctx.leaf, ctx.layout = leaf, layout
        if not any(p.is_shard() for p in leaf.placements):
            return local.view_as(local)
        return _gather(local, leaf.placements, leaf.mesh)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        leaf, layout = ctx.leaf, ctx.layout
        names = list(leaf.mesh.mesh_dim_names)
        if layout.batch_ways > 1:
            grad = grad.clone(memory_format=torch.contiguous_format)
            for name in layout.batch_axes:
                dist.all_reduce(grad, group=leaf.mesh.get_group(
                    names.index(name)))
            grad = grad / layout.batch_ways
        spec = _pad(spec_of(leaf.placements, leaf.mesh), grad.dim())
        if any(e is not None for e in spec):
            grad = grad[local_slices(spec, grad.shape,
                                     mesh_sizes(leaf.mesh),
                                     coordinates(leaf.mesh))]
        return grad, None, None


class CacheBlock:
    """A cache leaf's local block as a serving step hands it to the model:
    this rank's rows, of a dimension split over ``model`` its block, of a
    ``cache_seq`` split its segment; with its logical ``axes`` and
    placements. ``materialize`` gathers the ``model`` splits just before
    the layer uses it; ``write_back`` stores the rank's block of what the
    layer leaves."""
    __slots__ = ("local", "axes", "placements", "mesh")

    def __init__(self, local, axes, placements_, mesh):
        self.local, self.axes, self.placements, self.mesh = (
            local, tuple(axes), tuple(placements_), mesh)

    def gathered(self) -> list:
        """Per mesh dimension, the placement ``materialize`` gathers: the
        splits of dimensions past the rows other than ``cache_seq``."""
        return [p if p.is_shard() and p.dim > 0
                and self.axes[p.dim] != "cache_seq" else None
                for p in self.placements]


def _gather_block(b: CacheBlock) -> torch.Tensor:
    from torch.distributed.tensor import Replicate
    parts = b.gathered()
    if not any(parts):
        return b.local
    return _gather(b.local, [p or Replicate() for p in parts], b.mesh)


def _blocks_in(tree) -> bool:
    if isinstance(tree, CacheBlock):
        return True
    if isinstance(tree, dict):
        return any(_blocks_in(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_blocks_in(v) for v in tree)
    return False


def write_back(args, out) -> None:
    """After a layer (or a group of layers) has run in decode on the
    gathered caches ``materialize`` made of the ``CacheBlock`` leaves of
    ``args``: the rank's block of each new cache leaf in ``out[1]`` (the
    layer's (x, cache) result) stored in place into its block, where the
    layer did not write the block itself."""
    caches = [a for a in args if _blocks_in(a)]
    if not caches:
        return
    if len(caches) > 1:
        raise ValueError("a layer takes one cache tree")

    def put(b, new):
        if isinstance(b, CacheBlock):
            if new is b.local:
                return
            spec = [None] * new.dim()
            for name, p in zip(b.mesh.mesh_dim_names, b.gathered()):
                if p is not None:
                    spec[p.dim] = _names(spec[p.dim]) + (name,)
            b.local.copy_(new[local_slices(spec, new.shape,
                                           mesh_sizes(b.mesh),
                                           coordinates(b.mesh))])
        elif isinstance(b, dict):
            for k in b:
                put(b[k], new[k])
        elif isinstance(b, (list, tuple)):
            for x, y in zip(b, new):
                put(x, y)
    put(caches[0], out[1])


def cache_blocks(cache, axes, layout: Layout):
    """(the ``CacheBlock`` tree of a DTensor cache tree laid out by its
    logical ``axes``, ``layout`` with the caches' ``cache_seq`` split).
    Each leaf's placements must be its axes' on the mesh, and its rows the
    layout's."""
    seq = set()

    def block(ax, t):
        if not is_dtensor(t):
            raise TypeError("with a mesh the decode cache must be DTensors "
                            "(train_loop.shard_serve_state)")
        spec = _pad(spec_of(t.placements, t.device_mesh), t.dim())
        want = spec_for(ax, t.shape, layout.mesh)
        if spec != want:
            raise ValueError(f"a cache leaf {tuple(t.shape)} {ax} is placed "
                             f"{spec}; its axes resolve to {want}")
        if _names(spec[0]) != layout.batch_axes:
            raise ValueError(f"cache rows over {_names(spec[0])}, the "
                             f"tokens' over {layout.batch_axes}")
        if "cache_seq" in ax:
            d = ax.index("cache_seq")
            seq.add((_names(spec[d]), t.shape[d]))
        return CacheBlock(t.to_local(), ax, t.placements, t.device_mesh)
    blocks = map_axes(block, axes, cache)
    if len(seq) > 1:
        raise ValueError(f"caches split by sequence in more than one way: "
                         f"{sorted(seq)}")
    if seq:
        names, length = seq.pop()
        if names:
            layout = dataclasses.replace(layout, seq_axes=names,
                                         seq_len=length)
    return blocks, layout


def place_cache(cache, axes, layout: Layout):
    """The cache a prefill built for this rank's rows as DTensors placed by
    its logical ``axes`` at the global batch: each rank keeps its block of
    the dimensions past the rows (of a ``cache_seq`` split, its segment)."""
    sizes, coords = mesh_sizes(layout.mesh), coordinates(layout.mesh)

    def leaf(ax, t):
        shape = (layout.global_batch,) + tuple(t.shape[1:])
        spec = spec_for(ax, shape, layout.mesh)
        if _names(spec[0]) != layout.batch_axes:
            raise ValueError(f"cache rows over {_names(spec[0])}, the "
                             f"batch's over {layout.batch_axes}")
        idx = (slice(None),) + local_slices(spec, shape, sizes, coords)[1:]
        return _from_local(t[idx].contiguous(), layout.mesh,
                           placements(spec, layout.mesh), shape)
    return map_axes(leaf, axes, cache)


@dataclasses.dataclass(frozen=True)
class Segment:
    """This rank's segment of a cache split by ``cache_seq``: positions
    ``[start, start + length)`` of the sequence, split over mesh ``axes``
    (nested major-to-minor)."""
    start: int
    length: int
    axes: Tuple[str, ...]
    mesh: object

    def owns(self, pos: int) -> bool:
        return self.start <= pos < self.start + self.length

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced in place by ``op`` ("max" or "sum") over the ranks
        holding the other segments."""
        import torch.distributed as dist
        names = list(self.mesh.mesh_dim_names)
        red = dict(max=dist.ReduceOp.MAX, sum=dist.ReduceOp.SUM)[op]
        for name in self.axes:
            dist.all_reduce(t, op=red, group=self.mesh.get_group(
                names.index(name)))
        return t


def cache_segment(length: int) -> Optional[Segment]:
    """The segment a self-attention cache of ``length`` local positions
    holds under the current decode layout, or None where the caches hold
    every position (no layout, or ``cache_seq`` not split)."""
    layout = _LAYOUT
    if layout is None or not layout.seq_axes:
        return None
    sizes, coords = mesh_sizes(layout.mesh), coordinates(layout.mesh)
    n, idx = _blocks((layout.seq_axes,), sizes, coords)[0]
    if length * n != layout.seq_len:
        raise ValueError(f"a cache segment of {length} positions; the "
                         f"layout splits {layout.seq_len} {n} ways")
    return Segment(idx * length, length, layout.seq_axes, layout.mesh)


def materialize(tree):
    """``tree`` with each ``ShardedLeaf`` gathered to its full parameter
    (under grad differentiably, through ``_GatherParam``; a leaf no mesh
    dimension splits comes back as its block) and each ``CacheBlock`` to
    its tensor with the ``model`` splits gathered (its rows and
    ``cache_seq`` segment as they are); other leaves as they are. Without
    an ``activation_layout`` the tree comes back untouched."""
    layout = _LAYOUT
    if layout is None:
        return tree

    def leaf(x):
        if isinstance(x, ShardedLeaf):
            if torch.is_grad_enabled():
                return _GatherParam.apply(x.local, x, layout)
            return _gather(x.local, x.placements, x.mesh)
        if isinstance(x, CacheBlock):
            return _gather_block(x)
        return x
    return _tree_map(leaf, tree)
