"""The sharded path on four gloo ranks on the CPU, against the port's
unsharded step and the reference.

Each test writes its inputs under ``tmp_path``, then runs this file as a
script (``python tests/test_torch_distributed.py CASE DIR``) under its own
time limit: the script spawns four ranks that meet by ``file://``
rendezvous in ``DIR`` (no TCP port), run the case and leave their results
in ``DIR`` for the test to compare. The ranks import neither jax nor the
JAX package; the reference side (its train step, its device blocks, its
checkpoint restore) runs in this test process, or for the device blocks
in a JAX subprocess with four host devices.

- ``train``: one float32 sharded step of reduced qwen2-72B and reduced
  DBRX (experts over ``model``) on meshes (2, 2) ("data", "model") and
  (2, 2, 1) ("pod", "data", "model"), at grad_accum 1 and 2, against the
  unsharded step on the same rank and the reference's jitted step; the
  same in float64; and int8 compression against its quantisation bound.
  Attention, MLPs, the embedding, the logits and the loss compute
  tensor-parallel over ``model``. On (1, 4): reduced qwen2-72B, whose 2
  kv heads are replicated over ``model`` and sliced by each rank, and a
  straddling head layout (12 q heads over 3 kv heads: a rank's q heads
  read two kv heads, by index).
- ``state``: each rank's blocks against the reference's
  ``devices_indices_map``; a checkpoint saved on (2, 2) restored onto
  (4, 1), (1, 4) and no mesh, and through the reference's restore;
  ``run_elastic`` with injected failures against a clean run; the kernel
  wrappers refusing DTensors; the layouts that must raise.
- ``serve``: the sharded prefill and decode steps of reduced qwen2-1.5B,
  mamba2-2.7B, gemma3-4B and recurrentgemma-2B (float32) on (2, 2)
  (tensor-parallel, within SHARD_RTOL) and (4, 1) (bitwise) against the
  unsharded steps, and against the reference's steps; the same on (1, 4)
  for reduced qwen2-72B and the straddling layout and on (2, 2) for
  reduced SeamlessM4T (encoder, self- and cross-attention) and
  llama-3.2-vision (cross-attention); a batch-1 decode whose cache is
  split by sequence over four ``data`` ranks (gemma3's local and global
  layers, recurrentgemma's local attention), and batch-2 decodes split by
  sequence over ``model`` (``seqshard``: minicpm3's MLA latents, gemma3's
  tensor-parallel attention), against the unsharded decode; the
  parameter gathers over ``model`` of a prefill on (1, 4) (none but the
  leaves a rank needs whole: MoE's router, gathered as a gate is, and
  Mamba-2's packed ``in_proj`` and conv) and its sums over ``model``; a
  sequence split over ``data`` (batch 1 on (2, 2)), which must raise in
  the train step and prefill.
"""
import datetime
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4
# Per spawned run: rank start-up (~8 s for four), the work (~40 s alone),
# and a margin for the other test workers sharing the cores.
RUN_TIMEOUT_S = 240
ARCHS = ("qwen2_72b", "dbrx_132b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
# Sharded against unsharded (float32): loss, grad_norm, and each leaf of
# the first moments and of the second moments' square roots (both linear
# in the gradient) within 1e-6 of the leaf's largest entry (the sums over
# ranks add in another order); the parameters through their updates, by
# test_torch_train's UPDATE_* limits (a first AdamW step divides each
# gradient by its own magnitude, so an entry whose gradient is rounding
# noise near eps, e.g. the key bias's, steps by a different fraction of
# lr; logged as a near-tie in ROADMAP queue 3). In float64 that noise is
# 1e-9 times smaller and the parameters themselves are held to 1e-6.
SHARD_RTOL = 1e-6
# Tensor-parallel train cases on (1, 4) ("data", "model"): (arch, config
# overrides). Reduced qwen2-72B's 2 kv heads do not divide model 4: they
# are replicated, each rank projects the one its q head reads, and two
# ranks share each; 12 q heads over 3 kv heads put a rank's three q heads
# across two kv heads (ranks 1 and 2).
TP_MESH = (1, 4)
TP_TRAIN = {"qwen2_72b": ("qwen2_72b", {}),
            "straddle": ("qwen2_72b", dict(n_heads=12, n_kv=3))}


# ---------------------------------------------------------------------------
# The ranks (no jax here)
# ---------------------------------------------------------------------------

def _init(rank: int, run_dir: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(run_dir, 'rendezvous')}",
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=RUN_TIMEOUT_S))


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _np_tree(tree):
    from repro_torch.optim.adamw import tree_leaves
    return [t.detach().double().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in tree_leaves(tree)]


def _train_record(model, p, batch, mesh, opt, ga, ref):
    """One sharded step of ``p`` on ``mesh`` beside the unsharded step's
    result ``ref``: loss, grad_norm, parameters and moments gathered."""
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import (make_train_step,
                                                shard_train_state)
    sp, so = shard_train_state(model, p, opt, mesh)
    new, st, met = make_train_step(model, opt, grad_accum=ga, mesh=mesh)(
        sp, so, batch)
    return dict(
        loss=met["loss"].item(), grad_norm=met["grad_norm"].item(),
        ref_loss=ref[2]["loss"].item(),
        ref_grad_norm=ref[2]["grad_norm"].item(),
        params=_np_tree(sharding.gather_tree(new)),
        mu=_np_tree(sharding.gather_tree(st.mu)),
        nu=_np_tree(sharding.gather_tree(st.nu)),
        ref_params=_np_tree(ref[0]), ref_mu=_np_tree(ref[1].mu),
        ref_nu=_np_tree(ref[1].nu),
        sharded=sum(any(q.is_shard() for q in t.placements)
                    for t in _leaves(sp)),
        leaves=len(_leaves(sp))), (sp, so)


def _rank_train(rank: int, run_dir: str):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import make_train_step
    _init(rank, run_dir)
    inputs = torch.load(os.path.join(run_dir, "inputs.pt"))
    out = {}
    cases = [(arch, arch, {}, MESHES, (1, 2)) for arch in ARCHS] + [
        (name, arch, over, {"1x4": (TP_MESH, ("data", "model"))}, (1,))
        for name, (arch, over) in TP_TRAIN.items()]
    for name, arch, over, meshes, accums in cases:
        params, batch = inputs[name]["params"], inputs[name]["batch"]
        for dtype in ("float32", "float64"):
            cfg = get_config(arch, reduced=True).replace(
                dtype=dtype, param_dtype=dtype, block_kv=8, **over)
            model = Model(cfg)
            p = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
            opt = adamw(lr=lambda s: inputs["lr"])
            refs = {ga: make_train_step(model, opt, grad_accum=ga)(
                p, opt.init(p), batch) for ga in accums}
            for mname, (shape, names) in meshes.items():
                mesh = _mesh(shape, names)
                for ga, ref in refs.items():
                    key = f"{name}/{dtype}/{mname}/{ga}"
                    out[key], (sp, so) = _train_record(model, p, batch,
                                                       mesh, opt, ga, ref)
                    if dtype == "float32" and ga == 1 and name in ARCHS:
                        gen = torch.Generator().manual_seed(100 + rank)
                        new, st, met = make_train_step(
                            model, opt, mesh=mesh, compress="int8")(
                            sp, so, batch, gen)
                        out[key + "/int8"] = dict(
                            grad_norm=met["grad_norm"].item(),
                            mu=_np_tree(sharding.gather_tree(st.mu)))
    if rank == 0:
        np.save(os.path.join(run_dir, "train.npy"), out, allow_pickle=True)


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def _rank_state(rank: int, run_dir: str):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.sinkhorn import ops as kops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWState, tree_map
    from repro_torch.runtime import sharding
    from repro_torch.runtime.elastic import FailureInjector, run_elastic
    from repro_torch.runtime.train_loop import (make_train_step,
                                                shard_train_state)
    _init(rank, run_dir)
    inputs = torch.load(os.path.join(run_dir, "inputs.pt"))
    out = dict(blocks={}, raised={})

    # Blocks of each case's arange tensor on this rank.
    for i, (shape, names, tshape, spec) in enumerate(inputs["block_cases"]):
        mesh = _mesh(tuple(shape), tuple(names))
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        full = torch.arange(int(np.prod(tshape)),
                            dtype=torch.float32).reshape(tshape)
        dt = sharding.shard_leaf(full, spec, mesh)
        coords = sharding.coordinates(mesh)
        out["blocks"][i] = dict(coords=coords, local=dt.to_local().numpy(),
                                placements=[str(p) for p in dt.placements],
                                full_back=bool(torch.equal(
                                    sharding.gather_tree(dt), full)))
        # distribute_tensor (scatter from rank 0) gives the same block
        ref = distribute_tensor(full, mesh, sharding.placements(spec, mesh))
        out["blocks"][i]["distribute_equal"] = bool(torch.equal(
            ref.to_local(), dt.to_local()))

    cfg = get_config("qwen2_72b", reduced=True).replace(
        dtype="float32", param_dtype="float32", block_kv=8)
    model = Model(cfg)
    params, batch = inputs["params"], inputs["batch"]
    opt = adamw(lr=lambda s: 1e-2)
    mesh22 = make_host_mesh(model=2)
    # constraint: a whole tensor's block by logical axes
    rows = batch["tokens"]
    spec = sharding.spec_for(("act_batch", "act_seq"), rows.shape, mesh22)
    out["constraint"] = dict(spec=spec, equal=torch.equal(
        sharding.constraint(rows, ("act_batch", "act_seq"), mesh22),
        sharding.shard_leaf(rows, spec, mesh22).to_local()))
    sp, so = shard_train_state(model, params, opt, mesh22)
    step = make_train_step(model, opt, mesh=mesh22)
    sp, so, _ = step(sp, so, batch)
    state = dict(params=sp, mu=so.mu, nu=so.nu)
    ckpt = os.path.join(run_dir, "ckpt")
    save_checkpoint(ckpt, 1, state)
    full_state = sharding.gather_tree(state)
    if rank == 0:
        torch.save(full_state, os.path.join(run_dir, "saved_state.pt"))
    _, axes = model.abstract_params()
    restored = {}
    for name, shape in (("4x1", (4, 1)), ("1x4", (1, 4))):
        mesh = _mesh(shape, ("data", "model"))
        specs = sharding.tree_specs(axes, params, mesh)
        target = dict(params=specs, mu=specs, nu=specs)
        shardings = sharding.map_axes(
            lambda spec, t: (mesh, sharding.placements(spec, mesh)),
            target, dict(params=params, mu=params, nu=params))
        by_placement = restore_checkpoint(ckpt, 1, state, shardings)
        by_spec = restore_checkpoint(ckpt, 1, state, target, mesh=mesh)
        restored[name] = all(
            torch.equal(a, b) for tree in (by_placement, by_spec)
            for a, b in zip(_leaves(sharding.gather_tree(tree)),
                            _leaves(full_state)))
        restored[name + "_placed"] = [
            str(t.placements) for t in _leaves(by_placement)][:3]
    plain = restore_checkpoint(ckpt, 1, full_state)
    restored["none"] = all(np.array_equal(a, b.numpy()) for a, b in zip(
        _leaves(plain), _leaves(full_state)))
    out["restored"] = restored

    # run_elastic: failures after steps 3 and 5, checkpoints every 2.
    def step_fn(st, b, i):
        p, o, _ = step(st["params"], AdamWState(int(st["step"]), st["mu"],
                                                st["nu"]), b)
        return dict(params=p, mu=o.mu, nu=o.nu,
                    step=torch.tensor(o.step))

    def batch_fn(i):
        g = torch.Generator().manual_seed(1000 + i)
        toks = torch.randint(0, cfg.vocab, (4, 21), generator=g)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    sp, so = shard_train_state(model, params, opt, mesh22)
    start = dict(params=sp, mu=so.mu, nu=so.nu, step=torch.tensor(0))
    specs = sharding.tree_specs(axes, params, mesh22)
    place = sharding.map_axes(
        lambda spec, t: (mesh22, sharding.placements(spec, mesh22)),
        specs, params)
    shardings = dict(params=place, mu=place, nu=place, step=None)
    clean = run_elastic(start, step_fn, batch_fn, num_steps=5,
                        ckpt_dir=os.path.join(run_dir, "clean"),
                        ckpt_every=2, shardings=shardings)
    faulty = run_elastic(start, step_fn, batch_fn, num_steps=5,
                         ckpt_dir=os.path.join(run_dir, "faulty"),
                         ckpt_every=2, shardings=shardings,
                         injector=FailureInjector(fail_after_steps=(3, 5)))
    a, b = (sharding.gather_tree(r["state"]) for r in (clean, faulty))
    out["elastic"] = dict(
        restarts=faulty["restarts"], steps_run=faulty["steps_run"],
        clean_steps=clean["steps_run"],
        equal=all(torch.equal(x, y) for x, y in zip(_leaves(a),
                                                     _leaves(b))),
        dtensor=all(sharding.is_dtensor(t) for t in _leaves(
            faulty["state"]["params"])))

    # Kernel wrappers refuse DTensors (before any CPU fallback).
    q = distribute_tensor(torch.zeros(2, 8, 2, 1, 16), mesh22,
                          [Replicate(), Replicate()])
    kv = distribute_tensor(torch.zeros(2, 8, 2, 16), mesh22,
                           [Shard(0), Replicate()])
    bh = distribute_tensor(torch.zeros(4, 8, 16), mesh22,
                           [Shard(0), Replicate()])
    w = distribute_tensor(torch.zeros(2, 8, 4), mesh22,
                          [Replicate(), Replicate()])
    calls = dict(
        flash_attention=lambda: fops.flash_attention(q, kv, kv),
        flash_attention_bh=lambda: fops.flash_attention_bh(bh, bh, bh),
        ssd_scan=lambda: sops.ssd_scan(kv, w, w, kv, kv),
        rglru_layer=lambda: rops.rglru_layer(w, w, w, w),
        rglru_scan=lambda: rops.rglru_scan(w, w),
        sinkhorn_solve=lambda: kops.sinkhorn_solve(w, w, w, [1.0], 1))
    for name, call in calls.items():
        try:
            call()
            out["raised"][name] = "no error"
        except TypeError as e:
            out["raised"][name] = "DTensor" if "DTensor" in str(e) else \
                str(e)
    # No quiet fallbacks: too few ranks for the production mesh; a batch
    # of 2 on four data ranks shards the sequence (context parallelism:
    # the step against the unsharded one), and an embedding split over
    # data, which no rule set of the reference makes, raises.
    try:
        make_production_mesh()
        out["raised"]["production_mesh"] = "no error"
    except RuntimeError as e:
        out["raised"]["production_mesh"] = str(e)
    mesh41 = _mesh((4, 1), ("data", "model"))
    two = {k: v[:2] for k, v in batch.items()}
    with sharding.rule_overrides({"act_seq": (), "act_embed": ("data",)}):
        sp41, so41 = shard_train_state(model, params, opt, mesh41)
        try:
            make_train_step(model, opt, mesh=mesh41)(sp41, so41, two)
            out["raised"]["embedding"] = "no error"
        except NotImplementedError as e:
            out["raised"]["embedding"] = str(e)
    sp41, so41 = shard_train_state(model, params, opt, mesh41)
    _, _, got = make_train_step(model, opt, mesh=mesh41)(sp41, so41, two)
    _, _, want = make_train_step(model, opt)(params, opt.init(params), two)
    out["sequence"] = dict(
        segments=sharding.step_layout(mesh41, 2, two["tokens"].shape[1],
                                      cfg.d_model).segment_axes,
        **{k: float(got[k]) for k in ("loss", "grad_norm")},
        **{f"want_{k}": float(want[k]) for k in ("loss", "grad_norm")})
    out["world"] = dist.get_world_size()
    if rank == 0:
        np.save(os.path.join(run_dir, "state_meta.npy"),
                {k: v for k, v in out.items() if k != "blocks"},
                allow_pickle=True)
    np.save(os.path.join(run_dir, f"blocks-{rank}.npy"), out["blocks"],
            allow_pickle=True)


SERVE_ARCHS = ("qwen2_1_5b", "mamba2_2_7b", "gemma3_4b",
               "recurrentgemma_2b")
SERVE_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
# Batched serving: B rows, a prompt of S, the prefill's token and N decode
# steps. The sequence-split decode: a prompt of SEQ_S, SEQ_N steps, the
# cache's SEQ_S + SEQ_N positions in segments. Batch 1 on four data ranks
# (gemma3's local and global layers, recurrentgemma's local attention):
# four segments of 7, the decode positions 20-27 in the third and fourth;
# the local window of 8 leaves the first segment with no valid position,
# and the last holds only positions past 20 at first. Batch 2 on (2, 2)
# under the ``seqshard`` variant: the rows over data, two segments of 14
# over model — minicpm3's MLA latents, and gemma3's attention, whose q
# heads are split over the same model axis (q gathered over it, every
# head attended over the rank's segment, the rank's heads kept). Case:
# (arch, mesh, batch, variant).
SERVE_B, SERVE_S, SERVE_N = 4, 12, 8
SEQ_CASES = dict(gemma3_4b=("gemma3_4b", (4, 1), 1, "baseline"),
                 recurrentgemma_2b=("recurrentgemma_2b", (4, 1), 1,
                                    "baseline"),
                 minicpm3_4b=("minicpm3_4b", (2, 2), 2, "seqshard"),
                 gemma3_4b_seqshard=("gemma3_4b", (2, 2), 2, "seqshard"))
SEQ_S, SEQ_N = 20, 8
# The rule sets under which a batch of 1 on (2, 2) splits the sequence
# over data (context parallelism: two segments, under seqpar each split
# over model).
CONTEXT_VARIANTS = ("baseline", "seqpar")
# The sequence-split decode against the unsharded one (float32): its
# softmax is combined across segments in another order.
SEQ_ATOL = 1e-5
# Tensor-parallel serving beyond SERVE_ARCHS: (arch, mesh, config
# overrides); reduced qwen2-72B's kv heads replicated over model 4 (every
# rank writes the whole decode cache and reads its q head's kv head), the
# straddling layout of TP_TRAIN, and the cross-attention families on
# (2, 2) (SeamlessM4T's encoder, self- and cross-attention,
# llama-3.2-vision's gated cross layers; the kv heads split over model).
TP_SERVE = {"qwen2_72b/1x4": ("qwen2_72b", TP_MESH, {}),
            "straddle/1x4": ("qwen2_72b", TP_MESH,
                             dict(n_heads=12, n_kv=3)),
            "seamless_m4t_large_v2/2x2": ("seamless_m4t_large_v2", (2, 2),
                                          {}),
            "llama_3_2_vision_11b/2x2": ("llama_3_2_vision_11b", (2, 2),
                                         {})}
# The parameter gathers of a prefill on (1, 4): every sub-layer computes
# tensor-parallel, so no leaf is gathered over model but those a rank
# needs whole, once a layer each: MoE's router (unmarked, gathered by
# materialize as a gate is) and Mamba-2's packed in_proj and conv
# (TensorParallel.whole). The forward's sums over model by
# kind: row-parallel outputs (TensorParallel.reduce: the embedding, and
# each attention or MLA, dense MLP, MoE and its shared expert, Mamba-2
# and RG-LRU mixer), the Mamba-2 norm's sums of squares (sum) and the
# RG-LRU gates' reduce-scatters (scatter_sum, two a block) — by hand from
# the reduced configs: qwen2-72B 2 layers; DBRX 2 of attention + MoE;
# minicpm3 2 of MLA + MLP; mamba2 2 mixers; recurrentgemma 4 RG-LRU + 1
# attention layer, each with its MLP; DeepSeek-V2 a dense layer (MLA +
# MLP) and 2 of MLA + MoE + shared expert.
GATHER_ARCHS = ("qwen2_72b", "dbrx_132b", "minicpm3_4b", "mamba2_2_7b",
                "recurrentgemma_2b", "deepseek_v2_236b")
WHOLE_GATHERS = dict(dbrx_132b={"router": 2},
                     mamba2_2_7b={"in_proj": 2, "conv_w": 2, "conv_b": 2},
                     deepseek_v2_236b={"router": 2})
MODEL_SUMS = dict(qwen2_72b=(5, 0, 0), dbrx_132b=(5, 0, 0),
                  minicpm3_4b=(5, 0, 0), mamba2_2_7b=(3, 2, 0),
                  recurrentgemma_2b=(11, 0, 8), deepseek_v2_236b=(9, 0, 0))


def _gather_rows(t, mesh, rows: int):
    """The global [rows, ...] tensor of this rank's rows (an all-gather
    over the batch's mesh axes, innermost first)."""
    import torch.distributed as dist
    from repro_torch.runtime import sharding
    names = list(mesh.mesh_dim_names)
    for a in reversed(sharding.batch_axes(rows, mesh)):
        i = names.index(a)
        parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(i))
        t = torch.cat(parts, 0)
    return t


def _serve_unsharded(model, params, batch, length, steps):
    """(prefill logits, [decode logits], tokens [B, steps + 1]) of the
    unsharded steps on a prefill ``batch`` from a cache of ``length``
    positions."""
    from repro_torch.runtime.serve_loop import _splice
    from repro_torch.runtime.train_loop import (make_decode_step,
                                                make_prefill_step)
    B, S = batch["tokens"].shape
    logits, built = make_prefill_step(model)(params, batch)
    cache = _splice(model.init_cache(B, length, "cpu",
                                     **model.cache_lengths(batch)), built)
    tok, out, steps_logits = logits.argmax(-1)[:, None], [], []
    out.append(tok)
    decode = make_decode_step(model)
    for i in range(steps):
        tok, lg, cache = decode(params, cache, tok, S + i)
        out.append(tok)
        steps_logits.append(lg)
    return logits, steps_logits, torch.cat(out, 1)


def _rel_t(a, b) -> float:
    """max |a - b| over the largest |b| (0 where b is 0)."""
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / scale if scale > 0 else 0.0


def _rows(mesh, B: int) -> slice:
    """This rank's rows of a batch of ``B``."""
    from repro_torch.runtime import sharding
    return sharding.local_slices(
        sharding.spec_for(("act_batch",), (B,), mesh), (B,),
        sharding.mesh_sizes(mesh), sharding.coordinates(mesh))[0]


def _serve_sharded(model, params, batch, mesh, length, steps, whole,
                   mine=None):
    """The sharded prefill and ``steps`` decode steps of the global
    ``batch`` on ``mesh``, beside the unsharded steps' ``whole`` run:
    each rank's logits against this rank's rows of ``whole`` and, given
    ``mine`` (the unsharded run on the rank's rows alone), bitwise and
    relative against it; the gathered logits and greedy tokens."""
    from repro_torch.runtime.serve_loop import _splice
    from repro_torch.runtime.train_loop import (make_decode_step,
                                                make_prefill_step,
                                                shard_serve_state)
    B, S = batch["tokens"].shape
    sp, sc = shard_serve_state(model, params, model.init_cache(
        B, length, "cpu", **model.cache_lengths(batch)), mesh)
    logits, built = make_prefill_step(model, mesh)(sp, batch)
    _splice([t.to_local() for t in _tensors(sc)],
            [t.to_local() for t in _tensors(built)])
    rows = _rows(mesh, B)
    pairs = [(logits, whole[0][rows], None if mine is None else mine[0])]
    tok = _gather_rows(logits.argmax(-1)[:, None], mesh, B)
    toks_out, step_logits = [tok], []
    decode = make_decode_step(model, mesh)
    for i in range(steps):
        nxt, lg, sc = decode(sp, sc, tok, S + i)
        pairs.append((lg, whole[1][i][rows],
                      None if mine is None else mine[1][i]))
        tok = _gather_rows(nxt, mesh, B)
        toks_out.append(tok)
        step_logits.append(_gather_rows(lg, mesh, B).numpy())
    out = dict(whole_rel=max(_rel_t(a, b) for a, b, _ in pairs),
               whole_max_abs=max((a - b).abs().max().item()
                                 for a, b, _ in pairs),
               tokens_equal=torch.equal(torch.cat(toks_out, 1), whole[2]),
               split_cache=sum(any(p.is_shard() and p.dim > 0
                                   for p in t.placements)
                               for t in _tensors(sc)),
               prefill=_gather_rows(logits, mesh, B).numpy(),
               decode=np.stack(step_logits),
               tokens=torch.cat(toks_out, 1).numpy())
    if mine is not None:
        out.update(bitwise=all(torch.equal(a, c) for a, _, c in pairs),
                   steps=len(pairs),
                   rows_rel=max(_rel_t(a, c) for a, _, c in pairs))
    return out


def _prefill_gathers(model, params, toks, mesh) -> dict:
    """One sharded prefill, with the parameter gathers along ``model`` of
    a tensor-parallel leaf (``local_params``'s: the results' bytes), the
    gathers of a leaf a rank needs whole (``materialize``'s of an
    unmarked leaf and ``TensorParallel.whole``'s: count and bytes by leaf
    name), the bytes of every tensor-parallel leaf split over ``model``
    and the names of the unmarked ones, and the forward's collectives
    over ``model`` by kind (``reduce``, ``sum``, ``scatter_sum``)."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train_loop import (make_prefill_step,
                                                shard_serve_state)
    sp, _ = shard_serve_state(model, params, None, mesh)

    def names(tree, key=""):
        """``tree`` with each leaf its dict key."""
        if isinstance(tree, dict):
            return {k: names(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [names(v, key) for v in tree]
        return key
    leaves = tree_leaves(sp)
    tp_of = {t.to_local().data_ptr(): bool(tp) for t, tp in zip(
        leaves, tree_leaves(model.tensor_parallel_mask(sp)))}
    name_of = {t.to_local().data_ptr(): (n, t.numel() * t.element_size())
               for t, n in zip(leaves, tree_leaves(names(sp)))}
    split = dict(tp=0, whole=set())
    for t in leaves:
        if t.placements[-1].is_shard():
            if tp_of[t.to_local().data_ptr()]:
                split["tp"] += t.numel() * t.element_size()
            else:
                split["whole"].add(name_of[t.to_local().data_ptr()][0])
    gathered, whole, counts = dict(tp=0), {}, [0, 0, 0]
    inner = (sharding._gather, sharding._model_gather,
             sharding._Reduce.forward, sharding._Sum.forward,
             sharding._ScatterSum.forward)

    def named(x, out):
        n, full = name_of[x.data_ptr()]
        c, b = whole.get(n, (0, 0))
        whole[n] = (c + 1, b + out.numel() * out.element_size())
        assert out.numel() * out.element_size() == full, n

    def gather(local, placements_, mesh_):
        out = inner[0](local, placements_, mesh_)
        if placements_[-1].is_shard():      # model, the last mesh axis
            if tp_of[local.data_ptr()]:
                gathered["tp"] += out.numel() * out.element_size()
            else:
                named(local, out)
        return out

    def model_gather(x, dim, tp):
        out = inner[1](x, dim, tp)
        if x.data_ptr() in name_of:          # a parameter, not activations
            named(x, out)
        return out

    def counted(i):
        def fwd(ctx, *args):
            counts[i] += 1
            return inner[2 + i](ctx, *args)
        return staticmethod(fwd)
    sharding._gather, sharding._model_gather = gather, model_gather
    sharding._Reduce.forward, sharding._Sum.forward = counted(0), counted(1)
    sharding._ScatterSum.forward = counted(2)
    try:
        make_prefill_step(model, mesh)(sp, dict(tokens=toks))
    finally:
        sharding._gather, sharding._model_gather = inner[:2]
        sharding._Reduce.forward = staticmethod(inner[2])
        sharding._Sum.forward = staticmethod(inner[3])
        sharding._ScatterSum.forward = staticmethod(inner[4])
    return dict(gathered=gathered, split=split, whole=whole,
                sums=tuple(counts))


def _rank_serve(rank: int, run_dir: str):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime import sharding
    from repro_torch.runtime.serve_loop import _splice
    from repro_torch.runtime.train_loop import (make_decode_step,
                                                make_prefill_step,
                                                shard_serve_state)
    from repro_torch.launch.dryrun import VARIANTS
    _init(rank, run_dir)
    inputs = torch.load(os.path.join(run_dir, "inputs.pt"))
    out = dict(batched={}, seq={}, context={}, tp={}, gathers={})
    torch.set_grad_enabled(False)
    length = SERVE_S + SERVE_N + 1
    for arch in SERVE_ARCHS:
        cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                     param_dtype="float32")
        model = Model(cfg)
        params, toks = inputs[arch]["params"], inputs[arch]["tokens"]
        batch = dict(tokens=toks)
        whole = _serve_unsharded(model, params, batch, length, SERVE_N)
        for mname, shape in SERVE_MESHES.items():
            mesh = _mesh(shape, ("data", "model"))
            mine = _serve_unsharded(model, params, dict(
                tokens=toks[_rows(mesh, SERVE_B)]), length, SERVE_N)
            out["batched"][f"{arch}/{mname}"] = _serve_sharded(
                model, params, batch, mesh, length, SERVE_N, whole, mine)
    for name, (arch, shape, over) in TP_SERVE.items():
        cfg = get_config(arch, reduced=True).replace(
            dtype="float32", param_dtype="float32", **over)
        model = Model(cfg)
        params, batch = inputs[name]["params"], inputs[name]["batch"]
        whole = _serve_unsharded(model, params, batch, length, SERVE_N)
        out["tp"][name] = _serve_sharded(
            model, params, batch, _mesh(shape, ("data", "model")), length,
            SERVE_N, whole)
    for name, (arch, shape, batch, variant) in SEQ_CASES.items():
        cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                     param_dtype="float32")
        model = Model(cfg)
        params, one = inputs[arch]["params"], inputs[name]["tokens1"]
        length = SEQ_S + SEQ_N
        logits, built = make_prefill_step(model)(params, dict(tokens=one))
        full = _splice(model.init_cache(batch, length, "cpu"), built)
        ref_steps, ref_toks = [], [logits.argmax(-1)[:, None]]
        cache = _clone(full)
        decode = make_decode_step(model)
        for i in range(SEQ_N):
            t, lg, cache = decode(params, cache, ref_toks[-1], SEQ_S + i)
            ref_steps.append(lg)
            ref_toks.append(t)
        mesh = _mesh(shape, ("data", "model"))
        with sharding.rule_overrides(VARIANTS[variant].get("rules")):
            sp, sc = shard_serve_state(model, params, _clone(full), mesh)
            decode = make_decode_step(model, mesh)
            tok, toks_out, err, finite = ref_toks[0], [ref_toks[0]], 0.0, True
            for i in range(SEQ_N):
                nxt, lg, sc = decode(sp, sc, tok, SEQ_S + i)
                tok = _gather_rows(nxt, mesh, batch)
                lg = _gather_rows(lg, mesh, batch)
                toks_out.append(tok)
                err = max(err, (lg - ref_steps[i]).abs().max().item())
                finite = finite and bool(torch.isfinite(lg).all())
        out["seq"][name] = dict(
            max_abs=err, finite=finite,
            tokens_equal=torch.equal(torch.cat(toks_out, 1),
                                     torch.cat(ref_toks, 1)),
            placements=sorted({str(t.placements) for t in _tensors(sc)
                               if t.dim() > 2}),
            tokens=torch.cat(toks_out, 1).numpy())
    mesh = _mesh(TP_MESH, ("data", "model"))
    for arch in GATHER_ARCHS:
        model = Model(get_config(arch, reduced=True).replace(
            dtype="float32", param_dtype="float32"))
        out["gathers"][arch] = _prefill_gathers(
            model, model.init(torch.Generator().manual_seed(0)),
            inputs["qwen2_1_5b"]["tokens"], mesh)
    # A sequence split over data (batch 1 on (2, 2): the reference's
    # fall-through, and seqpar's sequence over data and model) is context
    # parallelism: the steps against the unsharded ones.
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import (make_train_step,
                                                shard_train_state)
    cfg = get_config("qwen2_1_5b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    model = Model(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    params, one = inputs["qwen2_1_5b"]["params"], \
        inputs["qwen2_1_5b"]["tokens"][:1]
    want_logits, _ = make_prefill_step(model)(params, dict(tokens=one))
    opt = adamw()
    with torch.enable_grad():
        _, _, want = make_train_step(model, opt)(
            params, opt.init(params), dict(tokens=one, labels=one))
    for variant in CONTEXT_VARIANTS:
        with sharding.rule_overrides(VARIANTS[variant].get("rules")):
            segments = sharding.step_layout(mesh, 1, one.shape[1],
                                            cfg.d_model).segment_axes
            sp, _ = shard_serve_state(model, params, None, mesh)
            logits, _ = make_prefill_step(model, mesh)(sp, dict(tokens=one))
            out["context"][f"prefill/{variant}"] = dict(
                segments=segments,
                max_abs=(logits - want_logits).abs().max().item())
            sp, so = shard_train_state(model, params, opt, mesh)
            with torch.enable_grad():
                _, _, got = make_train_step(model, opt, mesh=mesh)(
                    sp, so, dict(tokens=one, labels=one))
            out["context"][f"train/{variant}"] = dict(
                segments=segments, loss_rel=abs(
                    float(got["loss"]) / float(want["loss"]) - 1),
                grad_norm_rel=abs(float(got["grad_norm"])
                                  / float(want["grad_norm"]) - 1))
    if rank == 0:
        np.save(os.path.join(run_dir, "serve.npy"), out, allow_pickle=True)


def _tensors(tree):
    return [t for t in _leaves(tree) if t is not None]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return None if tree is None else tree.clone()


CASES = dict(train=_rank_train, state=_rank_state, serve=_rank_serve)


def _entry(rank, case, run_dir):
    CASES[case](rank, run_dir)
    import torch.distributed as dist
    dist.destroy_process_group()


def main(argv):
    import torch.multiprocessing as mp
    case, run_dir = argv
    mp.spawn(_entry, args=(case, run_dir), nprocs=WORLD, join=True)


# ---------------------------------------------------------------------------
# The tests (this process has jax)
# ---------------------------------------------------------------------------

def _spawn(case: str, run_dir) -> None:
    """Runs ``case`` on four ranks under RUN_TIMEOUT_S; the whole process
    group is killed if it overruns."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             case, str(run_dir)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"{case}: four gloo ranks did not finish in "
                    f"{RUN_TIMEOUT_S} s:\n{log.decode()[-4000:]}")
    assert proc.returncode == 0, log.decode()[-6000:]


def _moments_close(r) -> None:
    for a, b in zip(r["mu"], r["ref_mu"]):
        assert _rel(a, b) <= SHARD_RTOL, ("mu", a.shape)
    for a, b in zip(r["nu"], r["ref_nu"]):
        assert _rel(np.sqrt(a), np.sqrt(b)) <= SHARD_RTOL, ("nu", a.shape)


def _rel(a, b) -> float:
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 else float(
        np.abs(a).max())


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """The ``train`` case on four ranks, and the inputs it took: the
    reference's reduced-config init (train_pair) and a B 4 batch, for each
    arch and each TP_TRAIN case."""
    from test_torch_train import STEP_LR, train_batch, train_pair
    run_dir = tmp_path_factory.mktemp("train")
    inputs = dict(lr=STEP_LR)
    pairs = {}
    cases = {a: (a, {}) for a in ARCHS}
    cases.update(TP_TRAIN)
    for name, (arch, over) in cases.items():
        jm, jp, m, pp = train_pair(arch, block_kv=8, **over)
        jb, pb = train_batch(m.cfg, B=4)
        inputs[name] = dict(params=pp, batch=pb)
        pairs[name] = (jm, jp, m, pp, jb, pb)
    torch.save(inputs, os.path.join(run_dir, "inputs.pt"))
    _spawn("train", run_dir)
    out = np.load(os.path.join(run_dir, "train.npy"),
                  allow_pickle=True).item()
    return out, pairs


_REFERENCE_STEPS = {}


def _reference_step(name, ga, jm, jp, jb):
    """(params, metrics) of the reference's jitted step at STEP_LR, once
    per (case, grad_accum)."""
    if (name, ga) not in _REFERENCE_STEPS:
        import jax
        from repro.optim import adamw as jadamw
        from repro.runtime import train_loop as jtrain_loop
        from test_torch_train import STEP_LR
        jopt = jadamw(lr=lambda s: STEP_LR)
        jnew, _, jmet = jax.jit(jtrain_loop.make_train_step(
            jm, jopt, grad_accum=ga))(jp, jopt.init(jp), jb,
                                      jax.random.PRNGKey(0))
        _REFERENCE_STEPS[name, ga] = (jnew, jmet)
    return _REFERENCE_STEPS[name, ga]


def _against_reference(r, name, ga, pairs) -> None:
    """The sharded step's loss and grad_norm within LOSS_RTOL of the
    reference's jitted step, its updates within test_torch_train's
    limits."""
    import jax
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.optim.adamw import tree_unflatten
    from test_torch_train import LOSS_RTOL, assert_same_update
    jm, jp, m, pp, jb, pb = pairs[name]
    jnew, jmet = _reference_step(name, ga, jm, jp, jb)
    np.testing.assert_allclose(r["loss"], float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["grad_norm"], float(jmet["grad_norm"]),
                               rtol=LOSS_RTOL)
    ported = tree_unflatten(pp, [torch.from_numpy(a) for a in r["params"]])
    assert_same_update(jax.tree.leaves(jp), jax.tree.leaves(
        lm_params_to_reference(ported, m.cfg)), jax.tree.leaves(jnew))


def _against_unsharded(r, moments: bool = True) -> None:
    """Loss and grad_norm within SHARD_RTOL of the unsharded step's and,
    with ``moments``, every moment leaf within SHARD_RTOL of its largest
    entry; most leaves sharded (a wrong reduction on replicated leaves
    alone would pass)."""
    assert r["sharded"] >= r["leaves"] // 2, (r["sharded"], r["leaves"])
    assert abs(r["loss"] - r["ref_loss"]) <= SHARD_RTOL * r["ref_loss"]
    assert abs(r["grad_norm"] - r["ref_grad_norm"]) <= \
        SHARD_RTOL * r["ref_grad_norm"]
    if moments:
        _moments_close(r)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded_and_reference(train_run, arch,
                                                      mesh):
    """At grad_accum 1 and 2, tensor-parallel over ``model``: loss and
    grad_norm within SHARD_RTOL of the unsharded step, the updates within
    test_torch_train's limits; the sharded parameters' updates within the
    same limits of the reference's jitted step; in float64 every moment
    leaf and the parameters themselves within SHARD_RTOL of the leaf's
    largest entry, and so the float32 moments where ``model`` is 1 (on
    (2, 2) the float32 attention and MLP outputs and their gradients are
    sums over ``model`` rounded in another order: 1.0-1.3e-6 of some
    leaves' largest moment). Most leaves are sharded (the test would not
    see a wrong reduction on replicated leaves alone)."""
    from repro_torch.optim.adamw import tree_leaves
    from test_torch_train import assert_same_update
    out, pairs = train_run
    pp = pairs[arch][3]
    old = [t.double().numpy() for t in tree_leaves(pp)]
    model_ways = MESHES[mesh][0][MESHES[mesh][1].index("model")]
    for ga in (1, 2):
        r = out[f"{arch}/float32/{mesh}/{ga}"]
        _against_unsharded(r, moments=model_ways == 1)
        assert_same_update(old, r["params"], r["ref_params"])
        _against_reference(r, arch, ga, pairs)
        r64 = out[f"{arch}/float64/{mesh}/{ga}"]
        # (the loss and the norms compute in float32 whatever the dtype)
        _against_unsharded(r64)
        for a, b in zip(r64["params"], r64["ref_params"]):
            assert _rel(a, b) <= SHARD_RTOL, a.shape


@pytest.mark.parametrize("case", list(TP_TRAIN))
def test_tensor_parallel_step_with_shared_kv_heads(train_run, case):
    """On (1, 4), where the kv heads do not divide ``model`` (replicated;
    each rank projects the kv heads its q heads read, by index where
    they straddle two) and their gradients are summed over ``model``:
    loss and grad_norm within SHARD_RTOL of the unsharded step, the
    updates within test_torch_train's limits of the unsharded and the
    reference's steps; in float64 every moment leaf within SHARD_RTOL of
    its largest entry. Two ranks share a kv head here, and each rank's
    float32 attention backward (the blocked twin computes in float32
    whatever the dtype, as the reference's does) sums its own q heads'
    part of that head's gradient, so a float64 parameter whose gradient
    is float32 rounding noise near Adam's eps (the key bias's) moves by
    another fraction of lr: the float64 parameters are held by the same
    update limits as the float32 ones."""
    from repro_torch.optim.adamw import tree_leaves
    from test_torch_train import assert_same_update
    out, pairs = train_run
    old = [t.double().numpy() for t in tree_leaves(pairs[case][3])]
    for dtype in ("float32", "float64"):
        r = out[f"{case}/{dtype}/1x4/1"]
        _against_unsharded(r, moments=dtype == "float64")
        assert_same_update(old, r["params"], r["ref_params"])
    _against_reference(out[f"{case}/float32/1x4/1"], case, 1, pairs)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_int8_compression_within_quantisation_bound(train_run, arch,
                                                            mesh):
    """int8 rounding draws differ per shard, so the compressed step is
    held to the bound: each first moment (0.1 × the clipped gradient)
    within one quantum of its leaf (1/127 of the leaf's largest entry,
    which bounds every shard's scale) plus the change of the clip factor,
    of the exact step's."""
    out, _ = train_run
    exact = out[f"{arch}/float32/{mesh}/1"]
    q = out[f"{arch}/float32/{mesh}/1/int8"]
    c = min(1.0, 1.0 / exact["ref_grad_norm"])
    cq = min(1.0, 1.0 / q["grad_norm"])
    moved = 0
    for a, b in zip(q["mu"], exact["ref_mu"]):
        top = np.abs(b).max()
        bound = top * (cq / c) / 127 * 1.001 + np.abs(b) * abs(cq / c - 1)
        assert np.all(np.abs(a - b) <= bound + 1e-12), a.shape
        moved += int(np.any(a != b))
    assert moved > 0


@pytest.fixture(scope="module")
def state_run(tmp_path_factory):
    from test_torch_train import train_batch, train_pair
    run_dir = tmp_path_factory.mktemp("state")
    _, _, m, pp = train_pair("qwen2_72b", block_kv=8)
    _, pb = train_batch(m.cfg, B=4)
    inputs = dict(params=pp, batch=pb, block_cases=BLOCK_CASES)
    torch.save(inputs, os.path.join(run_dir, "inputs.pt"))
    _spawn("state", run_dir)
    meta = np.load(os.path.join(run_dir, "state_meta.npy"),
                   allow_pickle=True).item()
    blocks = [np.load(os.path.join(run_dir, f"blocks-{r}.npy"),
                      allow_pickle=True).item() for r in range(WORLD)]
    return run_dir, meta, blocks, m, pp


# (mesh shape, names, tensor shape, spec): reduced qwen2-72B's leaves on
# (2, 2), and the nested ("pod", "data") batch split on (2, 2, 1).
BLOCK_CASES = [
    ((2, 2), ("data", "model"), (64, 4, 16), ("data", "model", None)),
    ((2, 2), ("data", "model"), (2048, 64), ("model", "data")),
    ((2, 2), ("data", "model"), (4, 16, 64), ("model", None, "data")),
    ((2, 2), ("data", "model"), (64,), (None,)),
    ((2, 2, 1), ("pod", "data", "model"), (8, 6), (("pod", "data"), None)),
    ((2, 2, 1), ("pod", "data", "model"), (4, 20), (("pod", "data"), None)),
    ((2, 2, 1), ("pod", "data", "model"), (6, 8), (None, ("pod", "data"))),
]

_JAX_BLOCKS = """
import json, sys
from repro.launch.devices import set_host_platform_device_count
set_host_platform_device_count(4)
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
out = []
for shape, names, tshape, spec in json.loads(sys.argv[1]):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    devs = np.array(jax.devices()).reshape(shape)
    mesh = Mesh(devs, tuple(names))
    idx = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(
        tuple(tshape))
    case = []
    for d, slices in idx.items():
        coords = [int(c) for c in np.argwhere(devs == d)[0]]
        case.append([coords, [[s.start or 0, tshape[i] if s.stop is None
                               else s.stop] for i, s in enumerate(slices)]])
    out.append(case)
print(json.dumps(out))
"""


def test_shards_equal_the_reference_device_blocks(state_run):
    """Each rank's local block equals the block the reference's
    ``NamedSharding.devices_indices_map`` gives the device at the same
    mesh coordinates (JAX with four host devices, in a subprocess), for
    parameter layouts on (2, 2) and the nested ("pod", "data") split on
    (2, 2, 1); ``distribute_tensor`` gives the same blocks, and the
    gather gives the tensor back; ``constraint`` cuts a whole batch's
    block by its logical axes."""
    _, meta, blocks, _, _ = state_run
    assert meta["constraint"] == dict(spec=("data", None), equal=True)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _JAX_BLOCKS,
                          json.dumps(BLOCK_CASES)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    for i, (shape, names, tshape, _) in enumerate(BLOCK_CASES):
        full = np.arange(int(np.prod(tshape)),
                         dtype=np.float32).reshape(tshape)
        by_coords = {tuple(c): tuple(slice(a, b) for a, b in sl)
                     for c, sl in ref[i]}
        assert len(by_coords) == WORLD
        for r in range(WORLD):
            b = blocks[r][i]
            coords = tuple(b["coords"][n] for n in names)
            np.testing.assert_array_equal(b["local"],
                                          full[by_coords[coords]])
            assert b["full_back"] and b["distribute_equal"]


def test_checkpoint_restores_bitwise_onto_other_meshes(state_run):
    """Saved from (2, 2) in the reference's format (one writer, full
    arrays): restored onto (4, 1) and (1, 4), by placements and by specs,
    and with no mesh, bit for bit; its float32 leaves through the
    reference's ``restore_checkpoint`` too."""
    import jax
    from repro.checkpoint import restore_checkpoint as jrestore
    run_dir, meta, _, _, _ = state_run
    assert meta["restored"]["4x1"] and meta["restored"]["1x4"]
    assert meta["restored"]["none"]
    assert "Shard" in "".join(meta["restored"]["4x1_placed"])
    saved = torch.load(os.path.join(run_dir, "saved_state.pt"))
    target = jax.tree.map(lambda t: np.zeros(tuple(t.shape), np.float32),
                          saved, is_leaf=lambda t: isinstance(
                              t, torch.Tensor))
    got = jrestore(os.path.join(run_dir, "ckpt"), 1, target)
    from repro_torch.optim.adamw import tree_leaves
    want = [t.numpy() for t in tree_leaves(saved)]
    assert [np.asarray(a) for a in jax.tree.leaves(got)] and all(
        np.array_equal(np.asarray(a), b)
        for a, b in zip(jax.tree.leaves(got), want))


def test_elastic_restart_on_the_mesh_equals_a_clean_run(state_run):
    """``run_elastic`` with failures after steps 3 and 5 (checkpoints every
    2, restored onto the mesh through ``shardings``: steps 3 and 5 run
    twice) ends bitwise equal to a clean run, its state still
    DTensors."""
    _, meta, _, _, _ = state_run
    e = meta["elastic"]
    assert e["restarts"] == 2 and e["clean_steps"] == 5
    assert e["steps_run"] == 5 + 2       # steps 3 and 5 rerun
    assert e["equal"] and e["dtensor"]


def test_no_quiet_fallbacks_across_ranks(state_run):
    """Every kernel wrapper refuses a DTensor; the production mesh on four
    ranks raises; a batch of 2 on four data ranks, whose rules shard the
    sequence, takes the context-parallel step (four segments over
    ``data``), its loss and grad norm within SHARD_RTOL of the unsharded
    step's, never a replicated sequence; an embedding split over
    ``data``, which no rule set of the reference makes, raises naming
    it."""
    _, meta, _, _, _ = state_run
    assert meta["world"] == WORLD
    assert set(meta["raised"]) >= {"flash_attention", "flash_attention_bh",
                                   "ssd_scan", "rglru_layer", "rglru_scan",
                                   "sinkhorn_solve"}
    for name in ("flash_attention", "flash_attention_bh", "ssd_scan",
                 "rglru_layer", "rglru_scan", "sinkhorn_solve"):
        assert meta["raised"][name] == "DTensor", (name,
                                                   meta["raised"][name])
    assert "256 ranks" in meta["raised"]["production_mesh"]
    s = meta["sequence"]
    assert s["segments"] == ("data",), s
    for k in ("loss", "grad_norm"):
        assert abs(s[k] - s[f"want_{k}"]) <= SHARD_RTOL * s[f"want_{k}"], s
    assert "act_embed over data" in meta["raised"]["embedding"]


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """The ``serve`` case on four ranks, and the reference's side: each
    arch's reduced float32 pair (live recurrences) and its prompts; each
    TP_SERVE case's pair (train_pair: live gates) and its prompts with
    frames or patches."""
    from test_torch_lm import _pair
    from test_torch_lm_mla_moe import inputs as prompts
    from test_torch_train import train_pair
    run_dir = tmp_path_factory.mktemp("serve")
    inputs, pairs = {}, {}
    for i, arch in enumerate(SERVE_ARCHS + ("minicpm3_4b",)):
        _, jm, jp, cfg, m, pp = _pair(arch, "float32")
        rng = np.random.default_rng(40 + i)
        toks = rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S))
        one = rng.integers(0, cfg.vocab, (SEQ_CASES.get(
            arch, (None, None, 1))[2], SEQ_S))
        inputs[arch] = dict(params=pp, tokens=torch.from_numpy(toks),
                            tokens1=torch.from_numpy(one))
        pairs[arch] = (jm, jp, toks, one)
    for i, (name, (arch, _, batch, _)) in enumerate(SEQ_CASES.items()):
        if name not in inputs:
            one = np.random.default_rng(60 + i).integers(
                0, pairs[arch][0].cfg.vocab, (batch, SEQ_S))
            inputs[name] = dict(tokens1=torch.from_numpy(one))
            pairs[name] = pairs[arch][:3] + (one,)
    for i, (name, (arch, _, over)) in enumerate(TP_SERVE.items()):
        jm, jp, m, pp = train_pair(arch, **over)
        _, extra, jb, pb = prompts(m.cfg, B=SERVE_B, S=SERVE_S, seed=80 + i)
        inputs[name] = dict(params=pp, batch=pb)
        pairs[name] = (jm, jp, m.cfg, jb, extra)
    torch.save(inputs, os.path.join(run_dir, "inputs.pt"))
    _spawn("serve", run_dir)
    out = np.load(os.path.join(run_dir, "serve.npy"),
                  allow_pickle=True).item()
    return out, pairs


def _reference_serve(jm, jp, toks, length, steps):
    """(prefill logits, [decode logits], greedy tokens) of the reference's
    ``make_prefill_step`` / ``make_decode_step``."""
    import jax
    import jax.numpy as jnp
    from repro.models.common import split_tree
    from repro.runtime import train_loop as jtrain_loop
    from repro.runtime.serve_loop import _splice as jax_splice
    B, S = toks.shape
    logits, built = jax.jit(jtrain_loop.make_prefill_step(jm))(
        jp, dict(tokens=jnp.asarray(toks, jnp.int32)))
    cache = jax_splice(split_tree(jm.init_cache(B, length))[0], built, S)
    decode = jax.jit(jtrain_loop.make_decode_step(jm))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out, steps_logits = [np.asarray(tok)], []
    for i in range(steps):
        tok, lg, cache = decode(jp, cache, tok, S + i)
        out.append(np.asarray(tok))
        steps_logits.append(np.asarray(lg))
    return np.asarray(logits), steps_logits, np.concatenate(out, 1)


@pytest.mark.parametrize("mesh", list(SERVE_MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_is_bitwise_and_matches_reference(serve_run, arch,
                                                          mesh):
    """Each rank's prefill logits and every decode step's logits against
    the unsharded steps' on its rows: bitwise where ``model`` is 1, within
    SHARD_RTOL of the largest entry on (2, 2), where attention, MLPs, the
    embedding and the logits are tensor-parallel (the sums over ``model``
    add in another order); against the unsharded steps on the whole batch
    within SEQ_ATOL (the CPU's matmuls block by the number of rows, so a
    row's last bit can move with the rows around it: mamba2's one-row
    prefill on (4, 1) does) and the greedy tokens equal; on (2, 2) cache
    leaves are split over ``model`` (an attention cache's heads read and
    written in place, the others gathered by each layer and written back
    by block); the gathered logits and tokens within test_torch_lm's
    float32 limits of the reference's steps."""
    from test_torch_lm import F32_TOL
    out, pairs = serve_run
    r = out["batched"][f"{arch}/{mesh}"]
    assert r["steps"] == SERVE_N + 1
    if SERVE_MESHES[mesh][1] == 1:
        assert r["bitwise"]
    else:
        assert r["rows_rel"] <= SHARD_RTOL, r["rows_rel"]
    assert r["tokens_equal"] and r["whole_max_abs"] <= SEQ_ATOL
    assert (r["split_cache"] > 0) == (mesh == "2x2"), r["split_cache"]
    jm, jp, toks, _ = pairs[arch]
    logits, steps, tokens = _reference_serve(
        jm, jp, toks, SERVE_S + SERVE_N + 1, SERVE_N)
    np.testing.assert_allclose(r["prefill"], logits, **F32_TOL)
    np.testing.assert_array_equal(r["tokens"], tokens)
    for port, ref in zip(r["decode"], steps):
        np.testing.assert_allclose(port, ref, **F32_TOL)


@pytest.mark.parametrize("case", list(TP_SERVE))
def test_tensor_parallel_serving_matches_unsharded_and_reference(serve_run,
                                                                 case):
    """Tensor-parallel prefill and decode where the kv heads are
    replicated over ``model`` (reduced qwen2-72B on (1, 4): the whole
    decode cache written by every rank, its q head's kv head read), where
    q heads straddle kv groups (by index), and for the encoder, self- and
    cross-attention (SeamlessM4T) and the gated cross layers
    (llama-3.2-vision) on (2, 2): every step's logits within SHARD_RTOL of
    the unsharded steps' largest entry, the greedy tokens equal; the
    gathered logits within test_torch_lm's float32 limits of the
    reference's serving run and its greedy tokens equal."""
    from test_torch_lm import F32_TOL
    from test_torch_lm_mla_moe import reference_run
    out, pairs = serve_run
    r = out["tp"][case]
    assert r["whole_rel"] <= SHARD_RTOL, r["whole_rel"]
    assert r["tokens_equal"]
    jm, jp, cfg, jb, extra = pairs[case]
    tokens, logits, _, steps, _ = reference_run(jm, jp, cfg, jb, extra,
                                                SERVE_N + 1)
    np.testing.assert_array_equal(r["tokens"], np.asarray(tokens))
    np.testing.assert_allclose(r["prefill"], np.asarray(logits), **F32_TOL)
    for port, ref in zip(r["decode"], steps):
        np.testing.assert_allclose(port, np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("arch", GATHER_ARCHS)
def test_tensor_parallel_prefill_gathers_no_tp_leaf_over_model(serve_run,
                                                               arch):
    """A prefill on (1, 4) gathers no leaf over ``model`` — every leaf it
    splits belongs to a tensor-parallel sub-layer (the embedding and
    logits head, attention, MLA, dense MLPs, MoE's experts, the Mamba-2
    and RG-LRU mixers), and each rank keeps its block — but those a rank
    needs whole, by name, each once a layer at its full size: MoE's
    router (DBRX, DeepSeek-V2: the one unmarked leaf split over
    ``model``) and Mamba-2's packed ``in_proj``, ``conv_w`` and
    ``conv_b``. The forward's sums over ``model`` are MODEL_SUMS's hand
    counts: one a row-parallel sub-layer and the embedding, one a Mamba-2
    norm, two reduce-scatters an RG-LRU block."""
    out, _ = serve_run
    g = out["gathers"][arch]
    want = WHOLE_GATHERS.get(arch, {})
    assert g["split"]["tp"] > 0, g
    assert g["split"]["whole"] == set(want) - {"in_proj", "conv_w",
                                               "conv_b"}, g
    assert g["gathered"] == dict(tp=0), g
    assert {n: c for n, (c, _) in g["whole"].items()} == want, g["whole"]
    assert g["sums"] == MODEL_SUMS[arch], g["sums"]


# Placements of the caches' leaves past two dimensions, by case: KV
# [B, S, Kh, D] split by sequence over data (batch 1), the RG-LRU conv
# tails [1, 3, W] whole; MLA's latents [B, S, L] and gemma3's KV by rows
# over data and by sequence over model (``seqshard``).
SEQ_PLACEMENTS = dict(
    gemma3_4b=["(Shard(dim=1), Replicate())"],
    recurrentgemma_2b=["(Replicate(), Replicate())",
                       "(Shard(dim=1), Replicate())"],
    minicpm3_4b=["(Shard(dim=0), Shard(dim=1))"],
    gemma3_4b_seqshard=["(Shard(dim=0), Shard(dim=1))"])


@pytest.mark.parametrize("arch", list(SEQ_CASES))
def test_sequence_split_decode_matches_unsharded(serve_run, arch):
    """Caches split by sequence (each rank a segment of positions, never
    gathered): batch 1 on four ``data`` ranks, and batch 2 over ``model``
    under ``seqshard`` — minicpm3's MLA latents, and gemma3's KV beside
    its tensor-parallel q heads (q gathered over ``model``, every head
    attended over the segment, the rank's heads kept). The decode's
    softmax is combined across segments — segments holding no valid
    position (outside the local window, past the position) included —
    within SEQ_ATOL of the unsharded decode, finite, with the same greedy
    tokens, which are the reference's."""
    out, pairs = serve_run
    r = out["seq"][arch]
    assert r["placements"] == SEQ_PLACEMENTS[arch], r["placements"]
    assert r["finite"] and r["max_abs"] <= SEQ_ATOL, r["max_abs"]
    assert r["tokens_equal"]
    jm, jp, _, one = pairs[arch]
    _, _, tokens = _reference_serve(jm, jp, one, SEQ_S + SEQ_N, SEQ_N)
    np.testing.assert_array_equal(r["tokens"], tokens)


@pytest.mark.parametrize("variant", CONTEXT_VARIANTS)
@pytest.mark.parametrize("step", ["train", "prefill"])
def test_a_sequence_split_over_data_raises_naming_context_parallelism(
        serve_run, step, variant):
    """A batch of 1 on (2, 2) splits the sequence over ``data`` (the
    baseline rules' fall-through to ``act_seq``; under ``seqpar`` over
    ``data`` and ``model``): context parallelism, no longer refused. The
    sharded prefill's last logits within SEQ_ATOL of the unsharded
    prefill's, the sharded train step's loss and grad norm within
    SHARD_RTOL of the unsharded step's (float32). The float64 cases of
    every family: ``test_torch_context_parallel.py``."""
    out, _ = serve_run
    r = out["context"][f"{step}/{variant}"]
    assert r["segments"] == ("data",), r
    if step == "prefill":
        assert r["max_abs"] <= SEQ_ATOL, r
    else:
        assert r["loss_rel"] <= SHARD_RTOL, r
        assert r["grad_norm_rel"] <= SHARD_RTOL, r


if __name__ == "__main__":
    main(sys.argv[1:])
