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
  * ``local_params`` and ``TensorParallel`` — tensor-parallel compute on
    ``model`` (Megatron's): the sub-layers that take it (the token
    embedding and logits head, dense attention, dense MLPs) gather their
    leaves over the other axes only and keep the rank's ``model`` block
    (its heads, MLP columns or vocabulary rows); ``copy`` (identity, its
    backward an all-reduce over ``model``) stands before a column-parallel
    product and ``reduce`` (an all-reduce, its backward the identity)
    after a row-parallel one. Every sub-layer with parameters split over
    ``model`` takes them so: the token embedding and logits head, dense
    attention, dense MLPs, MLA (by heads), MoE (by experts, or by each
    expert's columns where ``model`` does not divide the experts), the
    Mamba-2 mixer (by heads) and the RG-LRU block (by channels); only
    norms, gates and MoE's router, for which every rank computes the
    same whole gradient, are gathered whole (``materialize``). A leaf of
    a tensor-parallel sub-layer that the rank needs whole though its
    rules split it, and uses for its own part (Mamba-2's packed
    ``in_proj`` and conv), comes through ``TensorParallel.whole``, whose
    backward sums the gradient over ``model`` and keeps the rank's
    block; ``TensorParallel.sum`` (an all-reduce both ways) and
    ``scatter_sum`` (a reduce-scatter, its backward an all-gather) serve
    the gated norm's statistics and the RG-LRU gates' partial products.
  * The residual stream split over ``model`` (``Layout.split``): where
    the rules resolve ``act_seq`` to ``model`` (the ``seqpar`` variants,
    Megatron's sequence parallelism) the stream [B, S, d] between
    sub-layers is the rank's S/m positions; where they resolve
    ``act_embed`` to ``model`` (``act2d``) it is the rank's d/m
    channels. Every sub-layer enters through ``sublayer_in`` (an
    all-gather along the split dimension, its backward a reduce-scatter;
    ``copy`` without a split) and leaves through ``sublayer_out`` (a
    reduce-scatter, its backward an all-gather; ``reduce`` without a
    split); one that computes whole (heads that ``model`` does not
    divide) gathers its input the same way and keeps the rank's block of
    its output. The norms, gates and residual adds run on the rank's
    block (under ``act2d`` the norms' statistics summed over ``model``),
    so each leaf gathered whole is summed over ``model`` in the backward
    (``_GatherParam``).
  * Context parallelism (``Layout.segment_axes``, ``ContextParallel``):
    where the batch does not divide ``data`` the reference's rules fall
    through to ``act_seq`` → ``data`` (and ``seqpar``'s to ``data`` and
    ``model``), and each rank holds a contiguous segment of the sequence:
    segment ``r`` of ``n`` is positions ``[r S/n, (r+1) S/n)``, the block
    ``NamedSharding`` gives it (under ``seqpar`` the ``model`` ranks split
    the segment further, as ``Layout.split`` does a whole sequence). The
    sub-layers that mix positions exchange what crosses a segment's edge
    over the segment axes: attention all-gathers K and V (its backward a
    reduce-scatter), the Mamba-2 and RG-LRU layers gather each segment's
    final state and decay and the causal conv's tail (the halo). The
    loss and the gradients are averaged over the segments as over the
    rows. An embedding split over ``data`` or ``pod``, which no rule set
    of the reference makes, raises (``refuse_sequence_sharding``).
  * ``CacheBlock`` / ``write_back`` / ``place_cache`` and ``Segment`` —
    the sharded serving steps' caches. A cache leaf split over ``model``
    by ``kv_heads`` (attention), ``heads`` (the Mamba-2 state) or ``mlp``
    (the RG-LRU's conv tail and state) is the rank's block, read and
    written in place by its tensor-parallel layer. Another leaf split
    over ``model`` (Mamba-2's packed conv tail, by ``conv_channels``) is
    gathered before its layer uses it, and the layer writes back only
    the rank's own block. A leaf split by ``cache_seq`` is never
    gathered: each rank keeps its segment of positions, only the owner of
    the decoded position writes it, and decode attention combines the
    segments (``models/attention.py``).
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
    0 when the caches hold every position); ``split``, the dimension of
    the residual stream [B, S, d] split over ``model`` (``SEQ`` under
    ``seqpar``, ``EMBED`` under ``act2d``), None where each rank holds
    its rows whole; ``segment_axes``, the mesh axes other than ``model``
    that split the residual stream's sequence into contiguous segments
    (context parallelism: ``act_seq`` where the batch does not divide),
    empty where each rank holds every position of its rows."""
    mesh: object
    global_batch: int
    batch_axes: Tuple[str, ...]
    seq_axes: Tuple[str, ...] = ()
    seq_len: int = 0
    split: Optional[int] = None
    segment_axes: Tuple[str, ...] = ()

    @property
    def batch_ways(self) -> int:
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)

    @property
    def segment_ways(self) -> int:
        """How many segments the sequence is split into."""
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.segment_axes)

    @property
    def mean_axes(self) -> Tuple[str, ...]:
        """The mesh axes over which each rank's loss covers its share of
        the tokens, equal shares: its rows' and its segments'. The loss
        and the gradients are averaged over them."""
        return self.batch_axes + self.segment_axes

    @property
    def mean_ways(self) -> int:
        return self.batch_ways * self.segment_ways

    def context(self) -> Optional["ContextParallel"]:
        """This rank's segment as a ``ContextParallel`` (a ``DeviceMesh``
        layout), or None where the sequence is not split."""
        if not self.segment_axes:
            return None
        n, idx = _blocks((self.segment_axes,), mesh_sizes(self.mesh),
                         coordinates(self.mesh))[0]
        return ContextParallel(idx, n, self.segment_axes, self.mesh)

    @property
    def split_ways(self) -> int:
        """How many blocks ``split`` cuts the residual stream into."""
        return 1 if self.split is None else mesh_sizes(self.mesh)[MODEL]

    def model_axis(self) -> "TensorParallel":
        """The ``model`` axis as a ``TensorParallel`` (a ``DeviceMesh``
        layout)."""
        i = list(self.mesh.mesh_dim_names).index(MODEL)
        return TensorParallel(coordinates(self.mesh)[MODEL],
                              self.mesh.size(i), self.mesh.get_group(i))


# The residual stream's logical axes, and the dimensions ``Layout.split``
# names.
RESIDUAL = ("act_batch", "act_seq", "act_embed")
SEQ, EMBED = 1, 2


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


def _segment_names(entry, mesh) -> Tuple[str, ...]:
    """The mesh axes of a spec entry other than ``model``, less those of
    size 1 (which split nothing)."""
    sizes = {} if mesh is None else mesh_sizes(mesh)
    return tuple(n for n in _names(entry)
                 if n != MODEL and sizes.get(n) != 1)


def refuse_sequence_sharding(what: str, axes, shape, spec,
                             mesh=None) -> None:
    """Raise where an activation's layout would split a dimension past its
    batch rows, other than a sequence (``act_seq``), over a mesh axis
    other than ``model``: an embedding over ``data`` or ``pod``, which no
    rule set of the reference makes, and which no step computes. A
    sequence over ``data`` or ``pod`` is context parallelism
    (``Layout.segment_axes``); a split over ``model`` alone (``seqpar``'s
    sequence, ``act2d``'s embedding, the logits' vocabulary) is the
    sharded steps' ``Layout.split``. A cache's ``cache_seq`` is not an
    activation: the serving steps split it (``Segment``). With ``mesh``,
    an axis of size 1 splits nothing."""
    split = [f"{a} over {'+'.join(_segment_names(e, mesh))}"
             for a, e in zip(axes[1:], spec[1:])
             if a != "act_seq" and _segment_names(e, mesh)]
    if split:
        raise NotImplementedError(
            f"{what} {tuple(shape)} resolves to {spec}: beyond its batch "
            f"rows it would be sharded ({', '.join(split)}) over a mesh "
            f"axis other than model, which only a sequence is (context "
            f"parallelism); no rule set of the reference splits another "
            f"dimension so")


def _model_dims(axes, spec) -> list:
    """The dimensions past the rows that ``spec`` splits over ``model``,
    a vocabulary's aside."""
    return [d for d, (a, e) in enumerate(zip(axes, spec))
            if d and a != "act_vocab" and MODEL in _names(e)]


def step_layout(mesh, rows: int, seq: int, d_model: int) -> Layout:
    """The layout of a sharded step whose global residual stream is
    ``[rows, seq, d_model]``: the rows over ``act_batch``'s axes,
    ``split`` the dimension that the rules give ``model``, if any, and
    ``segment_axes`` the other axes the rules split the sequence over
    (context parallelism: a batch that ``data`` does not divide). An
    embedding split over another axis raises
    (``refuse_sequence_sharding``)."""
    shape = (rows, seq, d_model)
    spec = spec_for(RESIDUAL, shape, mesh)
    refuse_sequence_sharding("the residual stream", RESIDUAL, shape, spec,
                             mesh)
    dims = _model_dims(RESIDUAL, spec)
    return Layout(mesh, rows, _names(spec[0]),
                  split=dims[0] if dims else None,
                  segment_axes=_segment_names(spec[1], mesh))


def check_rows(x, axes, layout: Layout):
    """``x``, this rank's block of an activation, checked against
    ``layout``: its logical ``axes`` on the global shape (the layout's
    rows, ``x``'s other dimensions, ``split``'s times the ``model`` ways,
    the sequence's times the segments) must split the batch rows over
    the layout's axes, the sequence into the layout's segments, a
    vocabulary as the rules say, the dimension the layout names over
    ``model`` and nothing else (``refuse_sequence_sharding``); ``x`` must
    be that block's shape."""
    shape = [layout.global_batch] + list(x.shape[1:])
    if layout.split is not None and layout.split < x.dim():
        shape[layout.split] *= layout.split_ways
    seq = list(axes).index("act_seq") if "act_seq" in axes else None
    if seq is not None:
        shape[seq] *= layout.segment_ways
    spec = spec_for(axes, shape, layout.mesh)
    refuse_sequence_sharding(f"activation {tuple(axes)}", axes, shape, spec,
                             layout.mesh)
    want = local_shape(spec, shape, mesh_sizes(layout.mesh))
    dims = _model_dims(axes, spec)
    segments = () if seq is None else _segment_names(spec[seq], layout.mesh)
    if _names(spec[0]) != layout.batch_axes or tuple(x.shape) != want or \
            (dims[0] if dims else None) != layout.split or \
            segments != layout.segment_axes:
        raise ValueError(f"activation rows {tuple(x.shape)} over "
                         f"{_names(spec[0])} split over model at {dims}, "
                         f"its sequence over {segments}; the layout's "
                         f"{want} over {layout.batch_axes} split at "
                         f"{layout.split}, segments over "
                         f"{layout.segment_axes}")
    return x


def check_logits(x, axes, layout: Layout, vocab: int):
    """The logits head's output ``x``, this rank's block, checked against
    ``layout``: its rows over the layout's axes, every position of the
    rank's segment (the head's entry gathered a sequence split over
    ``model``: ``sublayer_in``) and the
    vocabulary of ``vocab`` entries split as ``axes[-1]`` resolves."""
    spec = spec_for((axes[0], axes[-1]), (layout.global_batch, vocab),
                    layout.mesh)
    rows, cols = local_shape(spec, (layout.global_batch, vocab),
                             mesh_sizes(layout.mesh))
    want = (rows,) + tuple(x.shape[1:-1]) + (cols,)
    if _names(spec[0]) != layout.batch_axes or tuple(x.shape) != want:
        raise ValueError(f"logits {tuple(x.shape)} over {_names(spec[0])}, "
                         f"the layout's {want} over {layout.batch_axes}")
    return x


MODEL = "model"


class ShardedLeaf:
    """A parameter's local block (a leaf tensor requiring grad) and its
    placement: what the sharded step hands the model instead of the
    parameter. ``tp``: the leaf belongs to a sub-layer that computes
    tensor-parallel (``local_params`` takes it; ``materialize`` leaves it
    as it is). ``materialize`` gathers the others just before use."""
    __slots__ = ("local", "placements", "mesh", "tp", "split_by")

    def __init__(self, local, placements_, mesh, tp: bool = False):
        self.local, self.placements, self.mesh, self.tp = (
            local, tuple(placements_), mesh, tp)
        self.split_by = frozenset(n for n, p in zip(mesh.mesh_dim_names,
                                                   self.placements)
                                  if p.is_shard())

    def splits_model(self) -> bool:
        return MODEL in self.split_by


def _without_model(placements_, mesh) -> tuple:
    """``placements_`` with the ``model`` dimension's split dropped."""
    from torch.distributed.tensor import Replicate
    names = list(mesh.mesh_dim_names)
    return tuple(Replicate() if n == MODEL else p
                 for n, p in zip(names, placements_))


class _GatherParam(torch.autograd.Function):
    """Forward: the parameter from its block, gathered over every mesh
    dimension that splits it, or with ``keep_model`` over all but
    ``model`` (the rank's block of a tensor-parallel sub-layer). Backward:
    that gradient, which covers only this rank's rows of the batch, summed
    over the batch's mesh axes and divided by their size (the loss is the
    mean over the global batch), then this rank's block of it. Ranks
    along ``model`` computed the same rows: a leaf they computed whole, or
    split into their blocks, gets no sum over ``model``; a leaf of a
    tensor-parallel sub-layer that the rules replicate over ``model``
    (``wk`` / ``wv`` where the kv heads do not divide it) was used in part
    by each rank (the kv heads of its q heads), so its gradient is summed
    over ``model`` too. So is a leaf gathered whole where the layout
    splits the residual stream over ``model`` (``Layout.split``): each
    rank applied it to its own positions or channels (a norm's scale, a
    gate, the router) or kept its block of the output it computed whole
    (``sublayer_out``). Ranks on other segments of a split sequence
    computed other tokens' losses, as ranks on other rows did: the sum
    and the mean run over the segment axes too (``Layout.mean_axes``;
    each rank's gradient already holds the other segments' losses'
    parts that reached its leaves through the exchanges' backwards)."""

    @staticmethod
    def forward(ctx, local, leaf: ShardedLeaf, layout: Layout,
                keep_model: bool):
        placed = (_without_model(leaf.placements, leaf.mesh) if keep_model
                  else leaf.placements)
        ctx.leaf, ctx.layout, ctx.placed = leaf, layout, placed
        ctx.partial = (not leaf.splits_model() if keep_model
                       else layout.split is not None)
        if not any(p.is_shard() for p in placed):
            return local.view_as(local)
        return _gather(local, placed, leaf.mesh)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        leaf, layout = ctx.leaf, ctx.layout
        names = list(leaf.mesh.mesh_dim_names)
        if layout.mean_ways > 1 or ctx.partial:
            grad = grad.clone(memory_format=torch.contiguous_format)
        if layout.mean_ways > 1:
            for name in layout.mean_axes:
                dist.all_reduce(grad, group=leaf.mesh.get_group(
                    names.index(name)))
            grad = grad / layout.mean_ways
        if ctx.partial:
            dist.all_reduce(grad, group=leaf.mesh.get_group(
                names.index(MODEL)))
        spec = _pad(spec_of(ctx.placed, leaf.mesh), grad.dim())
        if any(e is not None for e in spec):
            grad = grad[local_slices(spec, grad.shape,
                                     mesh_sizes(leaf.mesh),
                                     coordinates(leaf.mesh))]
        return grad, None, None, None


def _param(x: ShardedLeaf, layout: Layout, keep_model: bool):
    if torch.is_grad_enabled():
        return _GatherParam.apply(x.local, x, layout, keep_model)
    if not x.split_by - ({MODEL} if keep_model else set()):
        return x.local
    return _gather(x.local, _without_model(x.placements, x.mesh)
                   if keep_model else x.placements, x.mesh)


class _Copy(torch.autograd.Function):
    """Identity forward; backward the gradient all-reduced over the group
    (the input of a column-parallel product: each rank's columns gave a
    part of its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) over the group forward, identity backward (the
    output of a row-parallel product: each rank's rows gave a part of it,
    and every rank goes on with the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _model_gather(x, dim: int, tp) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``model`` concatenated along
    ``dim`` in rank order (an all-gather)."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=dim)


def _model_scatter_sum(x, dim: int, tp) -> torch.Tensor:
    """The sum of ``x`` over ``model``, this rank's block of it along
    ``dim`` (a reduce-scatter)."""
    import torch.distributed as dist
    n = x.shape[dim] // tp.size
    parts = [t.contiguous() for t in torch.split(x, n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=tp.group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather over ``model`` along ``dim`` forward; backward the
    rank's block of the gradient (every rank went on with the same whole,
    so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, x.shape[dim]
        return _model_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


class _Whole(torch.autograd.Function):
    """All-gather over ``model`` along ``dim`` forward; backward the
    gradient summed over ``model``, the rank's block of it (a
    reduce-scatter): a parameter every rank uses whole, each for its own
    part of the output, gets a part of its gradient from every rank."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _model_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        return _model_scatter_sum(grad, ctx.dim, ctx.tp), None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter over ``model`` along ``dim`` forward (each rank's
    partial sums, every rank keeps its block of the total); backward the
    all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _model_scatter_sum(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        return _model_gather(grad, ctx.dim, ctx.tp), None, None


class _Sum(torch.autograd.Function):
    """All-reduce (sum) over the group forward and backward: a statistic
    every rank needs whole (a norm's sum of squares over channels split
    over ``model``), each rank's downstream its own channels."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``model`` axis as a tensor-parallel sub-layer sees it: this
    rank's index on it, its size and its process group, and Megatron's
    collectives over it."""
    rank: int
    size: int
    group: object

    def copy(self, x):
        """Before a column-parallel product: identity; the backward sums
        the input's gradient over ``model``."""
        return _Copy.apply(x, self.group)

    def reduce(self, x):
        """After a row-parallel product: the sum over ``model``; the
        backward passes the gradient on as it is."""
        return _Reduce.apply(x, self.group)

    def max(self, x):
        """The elementwise maximum over ``model`` (no gradient)."""
        import torch.distributed as dist
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def gather(self, x, dim: int):
        """The ranks' blocks of ``x`` concatenated along ``dim`` in rank
        order; the backward is the rank's block of the gradient (every
        rank goes on with the whole)."""
        return _Gather.apply(x, dim, self)

    def whole(self, x, dim: int, size: int):
        """A parameter of ``size`` along ``dim`` whole, from the rank's
        block of it (as it is where the rules replicate it, and
        ``_GatherParam`` sums its gradient over ``model``); the backward
        sums the gradient over ``model`` and keeps the rank's block."""
        if x.shape[dim] == size:
            return x
        return _Whole.apply(x, dim, self)

    def scatter_sum(self, x, dim: int):
        """The sum over ``model`` of each rank's partial ``x``, this
        rank's block of it along ``dim``; the backward all-gathers."""
        return _ScatterSum.apply(x, dim, self)

    def sum(self, x):
        """The sum over ``model``, all-reduced in the backward too."""
        return _Sum.apply(x, self.group)

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` entries split over ``model``."""
        size = n // self.size
        return slice(self.rank * size, (self.rank + 1) * size)

    def enter(self, x, dim: Optional[int] = None):
        """A tensor-parallel sub-layer's input: ``copy`` where ``x`` is
        whole on every rank (``dim`` None); else ``x`` holds the rank's
        block along ``dim`` and comes back whole (an all-gather), its
        backward the sum over ``model`` of the gradient's parts, the
        rank's block of it (a reduce-scatter)."""
        return self.copy(x) if dim is None else _Whole.apply(x, dim, self)

    def exit(self, x, dim: Optional[int] = None):
        """A row-parallel sub-layer's output: ``reduce`` (dim None), or
        the sum over ``model``'s rank's block along ``dim`` (a
        reduce-scatter), its backward an all-gather."""
        return self.reduce(x) if dim is None else self.scatter_sum(x, dim)


def _segment_gather(x, dim: int, cp) -> torch.Tensor:
    """The segments' blocks of ``x`` concatenated along ``dim`` in segment
    order: all-gathers over each segment axis, innermost first (nested
    major-to-minor, as ``_gather``)."""
    import torch.distributed as dist
    names = list(cp.mesh.mesh_dim_names)
    out = x.contiguous()
    for name in reversed(cp.axes):
        i = names.index(name)
        parts = [torch.empty_like(out) for _ in range(cp.mesh.size(i))]
        dist.all_gather(parts, out, group=cp.mesh.get_group(i))
        out = torch.cat(parts, dim=dim)
    return out


def _segment_scatter_sum(x, dim: int, cp) -> torch.Tensor:
    """The sum over the segments' ranks of ``x``, this segment's block of
    it along ``dim``: reduce-scatters over each segment axis, outermost
    first (the inverse order of ``_segment_gather``)."""
    import torch.distributed as dist
    names = list(cp.mesh.mesh_dim_names)
    out = x
    for name in cp.axes:
        i = names.index(name)
        parts = [t.contiguous() for t in torch.chunk(out, cp.mesh.size(i),
                                                     dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=cp.mesh.get_group(i))
    return out


class _SegmentGather(torch.autograd.Function):
    """All-gather over the segment axes along ``dim`` forward; backward the
    gradient summed over the segments' ranks, this segment's block of it
    (a reduce-scatter): every segment used every segment's block (the K
    and V of a prefix, the states and tails before it), each for its own
    tokens' losses."""

    @staticmethod
    def forward(ctx, x, dim, cp):
        ctx.dim, ctx.cp = dim, cp
        return _segment_gather(x, dim, cp)

    @staticmethod
    def backward(ctx, grad):
        return _segment_scatter_sum(grad, ctx.dim, ctx.cp), None, None


@dataclasses.dataclass(frozen=True)
class ContextParallel:
    """This rank's segment of a sequence split over mesh ``axes`` (nested
    major-to-minor): segment ``index`` of ``size``, which holds positions
    ``[index n, (index + 1) n)`` of a sequence of ``size n``; and the
    exchanges between segments."""
    index: int
    size: int
    axes: Tuple[str, ...]
    mesh: object

    def start(self, n: int) -> int:
        """The first position of this segment, of ``n`` positions."""
        return self.index * n

    def gather(self, x, dim: int):
        """Every segment's ``x`` concatenated along ``dim`` in segment
        order (the whole sequence's K and V from each segment's); the
        backward sums each block's gradient over the segments and keeps
        this segment's."""
        return _SegmentGather.apply(x, dim, self)

    def stack(self, x):
        """[size, *x.shape]: every segment's ``x`` (a final state, a
        decay, a conv tail), differentiable as ``gather``."""
        return self.gather(x.unsqueeze(0), 0)


def context_parallel() -> Optional[ContextParallel]:
    """This rank's segment under the current layout, or None outside a
    sharded step or where the sequence is not split."""
    return None if _LAYOUT is None else _LAYOUT.context()


def segment_carry(final, decay, cp: ContextParallel):
    """(the state entering this segment, the state after the last segment)
    of a linear recurrence h_t = a_t h_{t-1} + b_t that each segment ran
    from zero: ``final`` this segment's last state, ``decay`` the product
    of its a_t (broadcast against ``final``). One all-gather of both
    (differentiable: each segment's incoming state depends on the earlier
    segments' finals and decays); then h_in[0] = 0 and h_in[r + 1] =
    decay[r] h_in[r] + final[r], in the states' dtype. Every segment's
    result depends on the gathered tensor, so every rank's backward runs
    its reduce-scatter."""
    B = final.shape[0]
    nf = final[0].numel()
    both = cp.stack(torch.cat([final.reshape(B, -1),
                               decay.reshape(B, -1).to(final.dtype)], 1))
    finals = both[..., :nf].reshape(cp.size, *final.shape)
    decays = both[..., nf:].reshape(cp.size, *decay.shape)
    h = finals[0] * 0
    into = h
    for r in range(cp.size):
        if r == cp.index:
            into = h
        h = decays[r] * h + finals[r]
    return into, h


def segment_carry_cotangent(local, decay, glast, cp: ContextParallel):
    """The adjoint of ``segment_carry`` for a recurrence whose segments
    rerun from the state entering them: the total cotangent on the state
    leaving this segment. ``local`` is the cotangent a segment's outputs
    put on the state entering it, ``decay`` [B, H] its decay and
    ``glast`` the cotangent on the state after the last segment (summed
    over the ranks that return it). One all-gather of the three; then
    T[n] = sum glast, T[s] = local[s] + decay[s] T[s + 1], and this
    segment's T[index + 1]."""
    B, nf = local.shape[0], local[0].numel()
    both = _segment_gather(torch.cat(
        [local.reshape(B, -1), glast.reshape(B, -1),
         decay.reshape(B, -1)], 1)[None], 0, cp)
    locals_ = both[..., :nf].reshape(cp.size, *local.shape)
    t = both[..., nf:2 * nf].sum(0).reshape(local.shape)
    decays = both[..., 2 * nf:].reshape(cp.size, *decay.shape)
    for s in range(cp.size - 1, cp.index, -1):
        t = locals_[s] + decays[s][..., None, None] * t
    return t


def halo(tail, cp: ContextParallel) -> tuple:
    """(the inputs just before this segment of a causal conv, the inputs
    the sequence ends with), both as ``tail`` [B, w, C], this segment's own
    last w inputs, gathered over the segments (the gradient of the
    previous segment's reaches its inputs): the previous segment's tail,
    zeros on the first; and the last segment's tail (a prefill's conv
    cache)."""
    tails = cp.stack(tail)
    return (tails[cp.index - 1] if cp.index else tails[0] * 0), tails[-1]


# ``sublayer_in``'s default: the dimension the layout splits the residual
# stream by.
AS_RESIDUAL = -1


def residual_split() -> Optional[int]:
    """The dimension the current layout splits the residual stream by over
    ``model`` (``Layout.split``), None outside a sharded step or where it
    splits only the rows."""
    return None if _LAYOUT is None else _LAYOUT.split


def embed_split() -> Optional[TensorParallel]:
    """The ``model`` axis where the current layout splits the residual
    stream's embedding over it (``act2d``): a norm then sums its
    statistics over it and applies its block of the scale. Else None."""
    if _LAYOUT is None or _LAYOUT.split != EMBED:
        return None
    return _LAYOUT.model_axis()


def sublayer_in(x, tp: Optional[TensorParallel], dim=AS_RESIDUAL):
    """A sub-layer's input ``x``, this rank's block along ``dim`` (by
    default the residual stream's ``Layout.split``; None: whole on every
    rank): ``tp.enter`` where the sub-layer computes tensor-parallel; for
    one that computes whole under a split, the all-gather with the same
    reduce-scatter backward (each rank's output block depends on every
    position); else ``x``."""
    if dim == AS_RESIDUAL:
        dim = residual_split()
    if tp is not None:
        return tp.enter(x, dim)
    if dim is None:
        return x
    return _Whole.apply(x, dim, _LAYOUT.model_axis())


def sublayer_out(y, tp: Optional[TensorParallel]):
    """A sub-layer's output back on the residual stream's layout:
    ``tp.exit`` along ``Layout.split`` where it computes tensor-parallel;
    for one that computed whole under a split, the rank's block of ``y``
    (its backward zero past the block: ``_GatherParam`` sums the leaves'
    gradients over ``model``); else ``y``."""
    dim = residual_split()
    if tp is not None:
        return tp.exit(y, dim)
    if dim is None:
        return y
    return y[(slice(None),) * dim + (_LAYOUT.model_axis().block(
        y.shape[dim]),)]


def model_split(tree) -> Optional[TensorParallel]:
    """The ``model`` axis's ``TensorParallel`` where a tensor-parallel
    leaf (``ShardedLeaf.tp``) of ``tree`` is split over it, else None
    (outside a sharded step, on a mesh whose ``model`` is 1, or where the
    rules leave the sub-layer whole: heads, MLP columns or a vocabulary
    that ``model`` does not divide)."""
    for x in _leaves_of(tree):
        if isinstance(x, ShardedLeaf) and x.tp and x.splits_model():
            i = list(x.mesh.mesh_dim_names).index(MODEL)
            return TensorParallel(coordinates(x.mesh)[MODEL],
                                  x.mesh.size(i), x.mesh.get_group(i))
    return None


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_of(v)]
    return [tree]


def local_params(tree, divides: Sequence[int] = ()):
    """(a tensor-parallel sub-layer's parameters as this rank computes
    them, the ``model`` axis's ``TensorParallel`` or None). Each
    ``ShardedLeaf`` is gathered over the mesh axes other than ``model``
    and keeps the rank's ``model`` block (a leaf the rules replicate over
    ``model`` comes whole; its user takes its part, and its gradient is
    summed over ``model``: ``_GatherParam``). Where no leaf is split over ``model``, or ``model`` does
    not divide one of ``divides`` (the counts the sub-layer splits its
    work by: the Mamba-2 mixer's heads), every leaf is gathered whole, as
    ``materialize`` does, and the handle is None; so is it for plain
    tensors (the unsharded steps)."""
    layout = _LAYOUT
    if layout is None:
        return tree, None
    tp = model_split(tree)
    if tp is not None and any(n % tp.size for n in divides):
        tp = None

    def leaf(x):
        if isinstance(x, ShardedLeaf):
            return _param(x, layout, tp is not None)
        return x
    return _tree_map(leaf, tree), tp


# A cache leaf's dimensions that its layer reads and writes as the rank's
# block, never gathered: a ``cache_seq`` segment, and the splits over
# ``model`` of the layers that compute tensor-parallel whenever their
# cache is so split (attention's kv heads, the Mamba-2 state's heads, the
# RG-LRU's channels).
IN_PLACE = ("cache_seq", "kv_heads", "heads", "mlp")


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
        splits of dimensions past the rows other than ``IN_PLACE``'s (an
        attention cache's heads are split over ``model`` only where the q
        heads are, a Mamba-2 state's heads and an RG-LRU cache's channels
        only where the layer computes tensor-parallel, and each such
        layer reads and writes the rank's block in place)."""
        return [p if p.is_shard() and p.dim > 0
                and self.axes[p.dim] not in IN_PLACE
                else None for p in self.placements]


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


def _shard_on(mesh, dim: int) -> list:
    """Placements splitting tensor dimension ``dim`` over ``model``
    alone."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dim) if n == MODEL else Replicate()
            for n in mesh.mesh_dim_names]


def place_cache(cache, axes, layout: Layout, full=None):
    """The cache a prefill built for this rank's rows as DTensors placed by
    its logical ``axes`` at the global batch: each rank keeps its block of
    the dimensions past the rows (of a ``cache_seq`` split, its segment).
    Under context parallelism (``Layout.segment_axes``) a ``cache_seq``
    dimension holds the rank's segment of the sequence: its global length
    is the segments' sum, and the rank keeps the part of its segment that
    its block under the rules covers (all of it where ``cache_seq``
    splits over the segment axes, as the default rules do).
    ``full``, the cache's meta tree at any lengths (``Model.cache_axes``),
    gives each leaf's whole size of its dimensions past the rows other
    than lengths: a dimension the prefill built as the rank's block
    already (an attention's kv heads, computed tensor-parallel) is taken
    as it is, or gathered over ``model`` where the layout keeps it
    whole."""
    sizes, coords = mesh_sizes(layout.mesh), coordinates(layout.mesh)
    whole = iter([x for x in _leaves_of(full) if x is not None]
                 if full is not None else ())
    cp = layout.context()

    def leaf(ax, t):
        shape = [layout.global_batch] + list(t.shape[1:])
        seg = ax.index("cache_seq") if cp is not None and \
            "cache_seq" in ax else None
        if seg is not None:
            shape[seg] *= cp.size
        if full is not None:
            m = next(whole)
            for d, a in enumerate(ax):
                if d and a not in ("cache_seq", "cache_img"):
                    shape[d] = m.shape[d]
        spec = spec_for(ax, shape, layout.mesh)
        if _names(spec[0]) != layout.batch_axes:
            raise ValueError(f"cache rows over {_names(spec[0])}, the "
                             f"batch's over {layout.batch_axes}")
        for d in range(1, t.dim()):
            if d != seg and t.shape[d] != shape[d] and \
                    MODEL not in _names(spec[d]):
                # built as the rank's block, kept whole by the layout (kv
                # heads where a sequence split takes model): gathered
                t = _gather(t, _shard_on(layout.mesh, d), layout.mesh)
        sl = list(local_slices(spec, shape, sizes, coords))
        if seg is not None:
            # the block in the segment's own positions
            at = cp.start(t.shape[seg])
            sl[seg] = slice(sl[seg].start - at, sl[seg].stop - at)
            if sl[seg].start < 0 or sl[seg].stop > t.shape[seg]:
                raise ValueError(
                    f"a cache leaf {ax}: the rules place positions "
                    f"[{sl[seg].start + at}, {sl[seg].stop + at}) on this "
                    f"rank, outside its segment [{at}, "
                    f"{at + t.shape[seg]})")
        block = t[(slice(None),) + tuple(
            sl[d] if t.shape[d] == shape[d] or d == seg else slice(None)
            for d in range(1, t.dim()))]
        want = local_shape(spec, shape, sizes)
        if tuple(block.shape[1:]) != want[1:]:
            raise ValueError(f"a cache leaf {tuple(t.shape)} {ax}: its "
                             f"block {tuple(block.shape)} is not {want}")
        return _from_local(block.contiguous(), layout.mesh,
                           placements(spec, layout.mesh), tuple(shape))
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
    dimension splits comes back as its block), except the tensor-parallel
    ones (``ShardedLeaf.tp``), which their sub-layer takes through
    ``local_params``; each ``CacheBlock`` to its tensor with the ``model``
    splits gathered but its heads' (its rows and ``cache_seq`` segment as
    they are); other leaves as they are. Without an
    ``activation_layout`` the tree comes back untouched."""
    layout = _LAYOUT
    if layout is None:
        return tree

    def leaf(x):
        if isinstance(x, ShardedLeaf):
            return x if x.tp else _param(x, layout, False)
        if isinstance(x, CacheBlock):
            return _gather_block(x)
        return x
    return _tree_map(leaf, tree)
