"""The multi-pod dry run: what one device holds, computes, moves and sends
in every (arch × shape × mesh) cell — the counterpart of
``repro/launch/dryrun.py``.

``build_cell`` builds the port's parameter, AdamW-state, input and
decode-cache trees on the meta device (nothing drawn or allocated, no
process group), resolves each leaf's logical axes on the production
mesh's shape by the rules of ``runtime/sharding.py`` (the cell's variant
applied), and counts the bytes one device holds (``memory``).

``run_cell`` then runs the cell's step once, as the cards would run it,
on rank 0 of a fake process group of the mesh's size (``FakeStore`` and
the ``"fake"`` backend: collectives return at once) with every tensor a
fake one (``FakeTensorMode``: shapes and dtypes, no storage), and counts
what that rank does:

  * ``flops_per_device``: ``FlopCounterMode``'s total — the matmuls and
    attention products of the port's CPU path (the kernels' plain
    versions, which compute every masked block) on the rank's heads, MLP
    columns and vocabulary rows where the sub-layer computes
    tensor-parallel over ``model``; elementwise work is not counted
    (XLA's ``cost_analysis``, the reference's figure, counts it, and
    counts a ``lax.scan`` body once: ROADMAP queue 3).
  * ``bytes_per_device``: the operand and result bytes of every aten op
    (views and allocations excluded), unfused: an upper bound on device
    memory traffic (``bytes_model`` says so).
  * ``collectives``: the result bytes of every ``c10d`` op under the
    reference's ring model (all-reduce 2× its bytes, the others 1×), in
    the reference's five kinds plus ``total``: the parameters' gathers
    (over ``data`` and ``pod``, and over ``model`` for the sub-layers
    that gather whole), the gradients' sums over the batch axes, and the
    tensor-parallel sub-layers' sums over ``model`` — each row-parallel
    output's all-reduce, each column-parallel input's in the backward,
    and the vocab-parallel loss's — with the gathers of the serving
    steps' last logits.
  * ``roofline``: ``t_compute``, ``t_memory`` and ``t_collective`` and
    the ``dominant`` one, at the rates written into the cell as ``hw``.

  * ``memory.temp_bytes`` / ``peak_bytes``: the most bytes alive at once
    of the tensors the step makes (``LiveBytes``: activations, the
    tensors autograd and remat save, gathered parameters, gradients and
    collectives' buffers, unfused: no buffer is reused), and that plus
    the state's bytes; ``fits_device`` reads the peak.

A train cell runs one microbatch (``counted_microbatches`` 1) and
multiplies its counts by ``grad_accum``; the accumulation, the gradient
averaging and the AdamW update are counted once. The steps are
``make_train_step(mesh=)``'s parts and ``make_prefill_step`` /
``make_decode_step(mesh=)``; a decode cell decodes position ``seq_len -
1``. Every variant runs: ``seqpar`` and ``seqpar_seqshard`` split the
residual stream's sequence over ``model`` and ``act2d`` /
``act2d_seqshard`` its embedding (``sharding.Layout.split``). A cell
whose microbatch (or prefill batch) ``data`` does not divide splits the
sequence over ``data`` (context parallelism: ``Layout.segment_axes``,
e.g. ``train_4k`` with a ``grad_accum`` override that leaves fewer rows
than ``data``): it counts the rank of the last segment, whose causal
attention covers the longest prefix (``counted_rank``, ``counted_segment``),
with its K/V all-gathers, the recurrent layers' state and conv-tail
all-gathers and their backwards' reduce-scatters among the collectives.
``overrides["rank"]`` counts another rank of the mesh. A cell that fails
(an embedding split over ``data``) is printed as a FAIL line; no cost is
written as zero.

One process holds one default process group: ``run_cell`` refuses to
start where one is live, and tears down only its own.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k \
      --override cfg_n_layers=2        # run_cell's overrides, JSON values
  python -m repro_torch.launch.dryrun --all --both-meshes --memory-only
"""
import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import Model, tree_tensors
from repro_torch.runtime import sharding

# An H100 SXM's device memory, for the fit beside each cell's bytes.
DEVICE_BYTES = 80e9
# The roofline's rates, per device: an H100 SXM's dense bf16 peak and HBM
# rate (NVIDIA's data sheet), and one 400 Gb/s NDR port per card (both
# production axes cross nodes of 8 cards).
HW = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=50e9)


def _grad_accum_for(cfg, shape, data_ways: int = 16) -> int:
    """Microbatching so per-device live activations stay device-sized
    (the reference's rule, its v5e sizing kept).

    Activations shard over the data(+pod) axes only — every model-shard
    device holds the full per-data-shard batch — so the relevant quantity is
    tokens per *data shard*, not per chip. Target ≤ 4k tokens/microbatch
    (one 4k sequence)."""
    per_shard_seqs = max(shape.global_batch // data_ways, 1)
    tokens_budget = 4096
    seqs_per_micro = max(tokens_budget // shape.seq_len, 1)
    return max(1, per_shard_seqs // seqs_per_micro)


VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    # 2-D activation sharding: embed dim of activations over "model".
    "act2d": {"rules": {"act_embed": ("model",)}},
    # 2-D cache sharding: decode caches shard over model as well as data.
    "seqshard": {"rules": {"cache_seq": ("data", "model")}},
    "act2d_seqshard": {"rules": {"act_embed": ("model",),
                                 "cache_seq": ("data", "model")}},
    # remat=dots: keep matmul outputs, recompute elementwise only.
    "remat_dots": {"cfg_remat": "dots"},
    # Sequence parallelism: token axis sharded over model too.
    "seqpar": {"rules": {"act_seq": ("data", "model")}},
    "seqpar_seqshard": {"rules": {"act_seq": ("data", "model"),
                                  "cache_seq": ("data", "model")}},
    # int8 cross-pod gradient compression (train cells).
    "int8_grads": {"compress": "int8"},
}


class SkipCell(Exception):
    pass


def _device_bytes(tree, axes, mesh, rules, dtype_bytes=None) -> int:
    """Bytes one device holds of ``tree`` (meta tensors) laid out by
    ``axes`` on ``mesh``; ``dtype_bytes`` overrides each leaf's item
    size (AdamW's float32 moments of bf16 parameters)."""
    sizes = sharding.mesh_sizes(mesh)

    def leaf(ax, t):
        spec = sharding.spec_for(ax, t.shape, mesh, rules)
        return math.prod(sharding.local_shape(spec, t.shape, sizes)) * (
            dtype_bytes or t.element_size())
    return sum(tree_tensors(sharding.map_axes(leaf, axes, tree)))


def _cell(arch: str, shape_name: str, multi_pod: bool, variant: str,
          overrides: Optional[Dict]):
    """(config, shape, mesh shape, rules, overrides) of one cell. Besides
    the reference's overrides (``grad_accum``, ``compress``, ``rules``,
    ``cfg_<field>``): ``reduced`` (the arch's reduced config), ``mesh``
    ((sizes), (names)) in place of the production mesh, ``seq_len`` and
    ``global_batch`` in place of the shape's, and
    ``count_every_microbatch`` (a train cell's every microbatch run and
    counted)."""
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; the variants: "
                       f"{', '.join(VARIANTS)}")
    ov = dict(VARIANTS[variant])
    ov.update(overrides or {})
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, **{
        k: int(ov[k]) for k in ("seq_len", "global_batch") if k in ov})
    cfg = get_config(arch, reduced=bool(ov.get("reduced")))
    cfg_over = {k[4:]: v for k, v in ov.items() if k.startswith("cfg_")}
    if cfg_over:
        cfg = cfg.replace(**cfg_over)
    rules = dict(sharding.DEFAULT_RULES)
    rules.update(ov.get("rules", {}))
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        raise SkipCell(f"{arch} is pure full-attention; long_500k skipped "
                       f"per assignment (sub-quadratic archs only)")
    if "mesh" in ov:
        sizes, names = ov["mesh"]
        mesh = sharding.MeshShape(tuple(names), tuple(sizes))
    else:
        mesh = production_mesh_shape(multi_pod=multi_pod)
    return cfg, shape, mesh, rules, ov


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline",
               overrides: Optional[Dict] = None) -> Dict:
    """Per-device bytes of one cell, from the meta device and the mesh's
    shape: parameters, AdamW state (train), inputs, decode caches, the
    grad-accum count and the parameter count. Each leaf is counted as its
    spec places it (the reference's figure): under ``seqpar`` the tokens
    and labels count the rank's S/m positions, though the sharded steps
    hold them whole over ``model`` (``train_loop._local_rows``)."""
    t0 = time.time()
    cfg, shape, mesh, rules, ov = _cell(arch, shape_name, multi_pod,
                                        variant, overrides)
    model = Model(cfg)
    pshapes, paxes = model.abstract_params()
    inputs, in_axes = model.abstract_inputs(shape)
    cache, cache_axes = inputs.pop("cache", None), in_axes.pop("cache", None)
    param_bytes = _device_bytes(pshapes, paxes, mesh, rules)
    memory = dict(param_bytes=param_bytes,
                  input_bytes=_device_bytes(inputs, in_axes, mesh, rules))
    res = dict(arch=arch, shape=shape_name, kind=shape.kind,
               multi_pod=multi_pod, variant=variant,
               params=sum(t.numel() for t in tree_tensors(pshapes)),
               mesh=str(mesh.shape), chips=mesh.size, remat=cfg.remat)
    if shape.kind == "train":
        res["grad_accum"] = int(ov.get("grad_accum",
                                       _grad_accum_for(cfg, shape)))
        res["compress"] = ov.get("compress")
        # mu and nu: float32, laid out as the parameters (the step
        # counter is a replicated Python integer).
        memory["opt_state_bytes"] = 2 * _device_bytes(
            pshapes, paxes, mesh, rules, dtype_bytes=4)
    if cache is not None:
        memory["cache_bytes"] = _device_bytes(cache, cache_axes, mesh, rules)
    memory["state_bytes"] = sum(memory.values())
    memory["fits_device"] = memory["state_bytes"] <= DEVICE_BYTES
    res.update(memory=memory, build_s=round(time.time() - t0, 3))
    return res


# ---------------------------------------------------------------------------
# Counting what a device computes, moves and sends
# ---------------------------------------------------------------------------

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
# c10d ops by the reference's collective kinds.
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute"}
# Ops that move no data besides the views: allocations (the bytes count
# the writes that fill them) and _unsafe_view (a view its schema does not
# mark as one).
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "_unsafe_view")


@dataclasses.dataclass
class Costs:
    """What one device does in a counted region: FLOPs, bytes of aten
    operands and results, and collective bytes by kind."""
    flops: int = 0
    bytes: int = 0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in KINDS})

    def __add__(self, other: "Costs") -> "Costs":
        return Costs(self.flops + other.flops, self.bytes + other.bytes,
                     {k: self.collectives[k] + other.collectives[k]
                      for k in KINDS})

    def __mul__(self, n: int) -> "Costs":
        return Costs(self.flops * n, self.bytes * n,
                     {k: v * n for k, v in self.collectives.items()})


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _traffic_mode(costs: Costs):
    """A dispatch mode adding every op's bytes into ``costs``: aten ops'
    operands and results (views and allocations excluded), and ``c10d``
    collectives' result bytes by kind (all-reduce twice: a ring sends and
    receives each byte about twice)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Traffic(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.namespace == "c10d":
                kind = _C10D.get(func._opname)
                if kind is None:
                    raise NotImplementedError(
                        f"the dry run has no collective kind for "
                        f"{func.name()}")
                costs.collectives[kind] += (2 if kind == "all-reduce"
                                            else 1) * _nbytes(args[0])
            elif not (func.is_view or func._opname in _NO_TRAFFIC):
                costs.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            return out
    return Traffic()


class LiveBytes:
    """Bytes of the tensors alive in a region, and their peak: each new
    storage a dispatched op returns (views share their base's) adds its
    bytes when it is made and takes them off when it is freed (a weak
    reference's callback). Tensors made before the region (the step's
    state) are not counted; those autograd or remat keep for the backward
    are, as long as they live. Use ``mode()`` as a dispatch mode around
    the region (inside the ``FakeTensorMode``)."""

    def __init__(self):
        from torch.utils.weak import WeakIdKeyDictionary
        self.now = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int, _ref) -> None:
        self.now -= n

    def add(self, out) -> None:
        from torch.utils._pytree import tree_leaves
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = weakref.ref(st, functools.partial(self._free,
                                                               n))
            self.now += n
            self.peak = max(self.peak, self.now)

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        live = self

        class Live(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                live.add(out)
                return out
        return Live()


def count(fn, *args):
    """(``fn(*args)``, its ``Costs``): FLOPs by ``FlopCounterMode``, bytes
    and collectives by ``_traffic_mode``."""
    from torch.utils.flop_counter import FlopCounterMode
    costs = Costs()
    with FlopCounterMode(display=False) as flops, _traffic_mode(costs):
        out = fn(*args)
    costs.flops = int(flops.get_total_flops())
    return out, costs


def fake_tree(tree):
    """A tree of meta tensors as tensors of the current ``FakeTensorMode``
    on the CPU (same shapes and dtypes, no storage)."""
    if isinstance(tree, dict):
        return {k: fake_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_tree(v) for v in tree)
    if tree is None:
        return None
    return torch.empty(tree.shape, dtype=tree.dtype)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks at ``rank``,
    torn down on exit. Refuses to start where a group is live."""
    import torch.distributed as dist
    # Importing the module registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run needs its own fake process group and a process "
            "group is already live; run it in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _step_costs(model, shape, mesh, ov, grad_accum, live: LiveBytes):
    """(Costs of the cell's step on rank 0, microbatches counted), under
    fake tensors on the live fake group's ``mesh``; the bytes of the
    tensors the step makes tracked by ``live`` (the state, made before,
    not among them)."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    pshapes, _ = model.abstract_params()
    inputs, _ = model.abstract_inputs(shape)
    params, batch = fake_tree(pshapes), fake_tree(inputs)
    if shape.kind == "train":
        opt = adamw()
        sp, so = train_loop.shard_train_state(model, params, opt, mesh)
        compress = ov.get("compress")
        gen = torch.Generator() if compress else None
        if ov.get("count_every_microbatch"):
            step = train_loop.make_train_step(
                model, opt, grad_accum=grad_accum, compress=compress,
                mesh=mesh)
            with live.mode():
                return count(step, sp, so, batch, gen)[1], grad_accum
        parts = train_loop.train_parts(model, opt, compress, mesh)
        n = shape.global_batch // grad_accum
        mb = {k: v[:n] for k, v in batch.items()}
        with live.mode():
            live_params, c_live = count(parts.live, sp)
            (loss, grads), c_mb = count(parts.grads, live_params, mb)
            (_, acc), c_acc = count(train_loop.accumulate,
                                    lambda live_, mb_: (loss, grads),
                                    live_params, batch, grad_accum)
            del grads
            _, c_fin = count(parts.finish, sp, so, acc, gen)
        return c_live + c_mb * grad_accum + c_acc + c_fin, 1
    with torch.no_grad():
        if shape.kind == "prefill":
            sp, _ = train_loop.shard_serve_state(model, params, None, mesh)
            step = train_loop.make_prefill_step(model, mesh)
            with live.mode():
                return count(step, sp, batch)[1], None
        cache = batch.pop("cache")
        sp, sc = train_loop.shard_serve_state(model, params, cache, mesh)
        step = train_loop.make_decode_step(model, mesh)
        with live.mode():
            return count(step, sp, sc, batch["tokens"],
                         shape.seq_len - 1)[1], None


def counted_rank(cfg, shape, mesh_shape, grad_accum: int) -> tuple:
    """(the rank ``run_cell`` counts, its segment and the segments) of the
    cell's step under the live rules: rank 0 where each rank holds every
    position of its rows; under context parallelism the first rank of the
    last segment (its coordinates on the segment axes the last, 0
    elsewhere: the mesh's row-major order)."""
    rows, seq = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        rows //= grad_accum
    if shape.kind == "decode":
        seq = 1
    layout = sharding.step_layout(mesh_shape, rows, seq, cfg.d_model)
    if not layout.segment_axes:
        return 0, 0, 1
    names, sizes = mesh_shape.axis_names, mesh_shape.sizes
    rank = 0
    for name, size in zip(names, sizes):
        rank = rank * size + (size - 1 if name in layout.segment_axes else 0)
    return rank, layout.segment_ways - 1, layout.segment_ways


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "baseline",
             overrides: Optional[Dict] = None) -> Dict:
    """``build_cell``'s figures, then the cell's step run once on rank 0
    of a fake process group of the mesh's size under fake tensors:
    ``flops_per_device``, ``bytes_per_device``, ``collectives``,
    ``roofline`` and ``hw`` in the reference's layout (train cells: one
    microbatch counted and multiplied by ``grad_accum``), and
    ``memory.temp_bytes`` (the peak of the bytes alive that the step made:
    ``LiveBytes``) and ``memory.peak_bytes`` (the state's and that), the
    reference's ``memory_analysis`` names; ``fits_device`` then reads the
    peak. Counted on ``counted_rank``'s rank (``overrides["rank"]``: any
    other)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    res = build_cell(arch, shape_name, multi_pod, variant, overrides)
    cfg, shape, mesh_shape, rules, ov = _cell(arch, shape_name, multi_pod,
                                              variant, overrides)
    model = Model(cfg)
    t0 = time.time()
    live = LiveBytes()
    with sharding.rule_overrides(ov.get("rules")):
        rank, segment, segments = counted_rank(cfg, shape, mesh_shape,
                                               res.get("grad_accum", 1))
    rank = int(ov.get("rank", rank))
    with fake_group(mesh_shape.size, rank), sharding.rule_overrides(
            ov.get("rules")):
        mesh = init_device_mesh("cpu", mesh_shape.sizes,
                                mesh_dim_names=mesh_shape.axis_names)
        with FakeTensorMode():
            costs, micro = _step_costs(model, shape, mesh, ov,
                                       res.get("grad_accum", 1), live)
    memory = res["memory"]
    memory.update(temp_bytes=live.peak,
                  peak_bytes=memory["state_bytes"] + live.peak)
    memory["fits_device"] = memory["peak_bytes"] <= DEVICE_BYTES
    coll = dict(costs.collectives, total=sum(costs.collectives.values()))
    t = dict(compute=costs.flops / HW["peak_flops"],
             memory=costs.bytes / HW["hbm_bw"],
             collective=coll["total"] / HW["link_bw"])
    res.update(
        flops_per_device=float(costs.flops),
        bytes_per_device=float(costs.bytes),
        bytes_model="unfused: the operand and result bytes of every aten "
                    "op (views and allocations excluded), an upper bound "
                    "on device memory traffic",
        flops_model="FlopCounterMode over the port's CPU path (the "
                    "kernels' plain versions); matmuls and attention "
                    "products only",
        collectives=coll,
        roofline=dict(t_compute=t["compute"], t_memory=t["memory"],
                      t_collective=t["collective"],
                      dominant=max(t, key=t.get)),
        hw=dict(HW, device="NVIDIA H100 SXM (data sheet), bf16 dense"),
        count_s=round(time.time() - t0, 3))
    if micro is not None:
        res["counted_microbatches"] = micro
    res["counted_rank"] = rank
    if segments > 1 and "rank" not in ov:
        # [this segment, of how many]: the last, the longest causal prefix
        res["counted_segment"] = [segment, segments]
    if shape.kind == "decode":
        res["decode_pos"] = shape.seq_len - 1
    return res


def cell_path(out_dir, arch, shape_name, multi_pod, variant):
    tag = "pod2" if multi_pod else "pod1"
    return os.path.join(out_dir, f"{arch}.{shape_name}.{tag}.{variant}.json")


def _override(text: str):
    key, _, value = text.partition("=")
    try:
        return key, json.loads(value)
    except json.JSONDecodeError:
        return key, value


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    type=_override, metavar="KEY=JSON",
                    help="run_cell's overrides, e.g. cfg_n_layers=2")
    ap.add_argument("--memory-only", action="store_true",
                    help="build_cell's per-device bytes alone (seconds "
                         "for the sweep; the costs take minutes)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    overrides = dict(args.override) or None

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if args.both_meshes else [args.multi_pod])
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    t_sweep = time.time()
    for a, s, mp in cells:
        path = cell_path(args.out, a, s, mp, args.variant)
        if os.path.exists(path) and not args.force:
            print(f"cached  {path}")
            continue
        tag = "pod2" if mp else "pod1"
        try:
            res = (build_cell if args.memory_only else run_cell)(
                a, s, mp, args.variant, overrides)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            m = res["memory"]
            print(f"OK      {a:24s} {s:12s} {tag} params "
                  f"{m['param_bytes'] / 1e9:8.3f} GB"
                  + (f" adamw {m['opt_state_bytes'] / 1e9:8.3f} GB"
                     f" accum {res['grad_accum']:3d}"
                     if "opt_state_bytes" in m else "")
                  + (f" cache {m['cache_bytes'] / 1e9:8.3f} GB"
                     if "cache_bytes" in m else "")
                  + f" inputs {m['input_bytes'] / 1e6:9.3f} MB"
                  f" state {m['state_bytes'] / 1e9:8.3f} GB of "
                  f"{DEVICE_BYTES / 1e9:.0f}", flush=True)
            if "counted_segment" in res:
                i, n = res["counted_segment"]
                print(f"        the sequence in {n} segments over data "
                      f"(context parallelism): counted on rank "
                      f"{res['counted_rank']}, segment {i + 1} of {n}, the "
                      f"last (the longest causal prefix)", flush=True)
            if "roofline" in res:
                r, c = res["roofline"], res["collectives"]
                print(f"        temporaries {m['temp_bytes'] / 1e9:8.3f} GB "
                      f"peak {m['peak_bytes'] / 1e9:8.3f} GB", flush=True)
                print(f"        flops {res['flops_per_device']:.4e} bytes "
                      f"{res['bytes_per_device']:.4e} collectives "
                      f"{c['total']:.4e} (ar {c['all-reduce']:.3e} ag "
                      f"{c['all-gather']:.3e}) Tc={r['t_compute']:.3e} "
                      f"Tm={r['t_memory']:.3e} Tx={r['t_collective']:.3e} "
                      f"dom={r['dominant']} ({res['count_s']:.1f} s)",
                      flush=True)
        except SkipCell as e:
            with open(path, "w") as f:
                json.dump(dict(arch=a, shape=s, multi_pod=mp, skipped=True,
                               reason=str(e)), f)
            print(f"SKIP    {a:24s} {s:12s} {tag}: {e}", flush=True)
        except Exception as e:
            print(f"FAIL    {a:24s} {s:12s} {tag}: {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc(limit=6)
    print(f"sweep of {len(cells)} cells: {time.time() - t_sweep:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
