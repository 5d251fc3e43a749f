"""The multi-pod dry run as accounting — the counterpart of
``repro/launch/dryrun.py``.

For each (arch × shape × mesh) cell it builds the port's parameter,
AdamW-state, input and decode-cache trees on the meta device (nothing is
drawn or allocated, and no process group is needed), resolves each leaf's
logical axes on the production mesh's shape by the rules of
``runtime/sharding.py`` (the cell's variant applied), and counts the
bytes one device holds. Results go to one JSON file per cell, in the
reference's layout.

What it does not port: the reference lowers and compiles each cell with
XLA and reads ``cost_analysis`` (FLOPs, bytes accessed),
``memory_analysis`` (temporaries, peak) and the partitioned HLO
(``collective_bytes``, ``f32_widened_stack_bytes``). Those are XLA's, so
their keys (``flops_per_device``, ``bytes_per_device``, ``collectives``,
``cost_analysis``, ``roofline``, ``memory.temp_bytes`` ...) are left out
here rather than written as zero. Collective bytes and FLOPs by
``CommDebugMode`` / ``FlopCounterMode`` over a fake process group are
queued in ROADMAP queue 1.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes
"""
import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import Model, tree_tensors
from repro_torch.runtime import sharding

# An H100 SXM's device memory, for the fit beside each cell's bytes.
DEVICE_BYTES = 80e9


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


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline",
               overrides: Optional[Dict] = None) -> Dict:
    """Per-device bytes of one cell, from the meta device and the mesh's
    shape: parameters, AdamW state (train), inputs, decode caches, the
    grad-accum count and the parameter count."""
    t0 = time.time()
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ov = dict(VARIANTS.get(variant, {}))
    ov.update(overrides or {})
    cfg_over = {k[4:]: v for k, v in ov.items() if k.startswith("cfg_")}
    if cfg_over:
        cfg = cfg.replace(**cfg_over)
    rules = dict(sharding.DEFAULT_RULES)
    rules.update(ov.get("rules", {}))

    if shape_name == "long_500k" and not cfg.sub_quadratic:
        raise SkipCell(f"{arch} is pure full-attention; long_500k skipped "
                       f"per assignment (sub-quadratic archs only)")

    mesh = production_mesh_shape(multi_pod=multi_pod)
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


def cell_path(out_dir, arch, shape_name, multi_pod, variant):
    tag = "pod2" if multi_pod else "pod1"
    return os.path.join(out_dir, f"{arch}.{shape_name}.{tag}.{variant}.json")


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
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if args.both_meshes else [args.multi_pod])
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    for a, s, mp in cells:
        path = cell_path(args.out, a, s, mp, args.variant)
        if os.path.exists(path) and not args.force:
            print(f"cached  {path}")
            continue
        tag = "pod2" if mp else "pod1"
        try:
            res = build_cell(a, s, mp, args.variant)
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
        except SkipCell as e:
            with open(path, "w") as f:
                json.dump(dict(arch=a, shape=s, multi_pod=mp, skipped=True,
                               reason=str(e)), f)
            print(f"SKIP    {a:24s} {s:12s} {tag}: {e}", flush=True)
        except Exception as e:
            print(f"FAIL    {a:24s} {s:12s} {tag}: {type(e).__name__}: {e}",
                  flush=True)
            traceback.print_exc(limit=6)


if __name__ == "__main__":
    main()
