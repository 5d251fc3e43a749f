"""The dry run's costs (``repro_torch.launch.dryrun.run_cell``): what a
device computes, moves and sends in a cell, counted on rank 0 of a fake
process group under fake tensors.

- Every reduced cell of the ten archs (train, prefill, decode, and
  long_500k for the three sub-quadratic ones) on (2, 2) and (2, 2, 2)
  meshes: every cost key present and positive.
- The counters against hand counts: one linear layer and one collective
  of each kind; the all-gathers and all-reduces of a one-layer
  tensor-parallel prefill from its parameters' specs and its
  activations; reduced qwen2-72B's train step on a (1, 4) mesh (its kv
  heads replicated and sliced) against the products of one rank's heads,
  MLP columns and vocabulary rows; reduced DeepSeek-V2's (MLA's heads,
  the routed experts over ``model``) the same way.
- A train cell's one counted microbatch times ``grad_accum`` (plus the
  accumulation and the update once) equals the count of every microbatch
  run, exactly.
- Parity with the reference's ``cost_analysis()["flops"]`` at one layer
  per stack and grad_accum 1, and the finding that XLA counts a scanned
  layer body once (the reference's count stays put at depth 2, the
  port's grows); and with the reference's partitioned count on a (1, 4)
  mesh of four host devices (its per-device figure) for the
  tensor-parallel train step.

A process holds one default process group, so the fake-group cases run
this file as a script (``python tests/test_torch_dryrun.py CASE MESH
OUT``) in a subprocess of their own, which imports neither jax nor the
JAX package.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RUN_TIMEOUT_S = 240
MESHES = {"2x2": [[2, 2], ["data", "model"]],
          "2x2x2": [[2, 2, 2], ["pod", "data", "model"]]}
# Reduced shapes: (seq_len, global_batch); train at grad_accum 2.
REDUCED_SHAPES = {"train_4k": (32, 8), "prefill_32k": (32, 4),
                  "decode_32k": (32, 8), "long_500k": (64, 1)}
COST_KEYS = ("flops_per_device", "bytes_per_device")
# The port counts matmuls and attention products (FlopCounterMode); XLA's
# cost_analysis counts elementwise work too, about 1 % of these steps
# (-1.26 % for the qwen2 train step, -0.09 % to -1.43 % for the others,
# as measured when the test was written). A difference past 2 % is a
# FLOP the port does not do or does twice.
FLOP_RTOL = 0.02


# ---------------------------------------------------------------------------
# The fake-group cases (no jax here)
# ---------------------------------------------------------------------------

def _cells(mesh: str) -> dict:
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import dryrun
    out = {}
    for arch in list_archs():
        for shape, (seq, batch) in REDUCED_SHAPES.items():
            if shape == "long_500k" and not get_config(arch).sub_quadratic:
                continue
            over = dict(reduced=True, mesh=MESHES[mesh], seq_len=seq,
                        global_batch=batch)
            if shape == "train_4k":
                over["grad_accum"] = 2
            out[f"{arch}/{shape}"] = dryrun.run_cell(arch, shape, False,
                                                     overrides=over)
    return out


def _hand(_mesh: str) -> dict:
    """One linear layer and one collective of each kind under the
    counters (sizes in the test below), and a one-layer qwen2 prefill's
    all-gathers against its parameters' specs."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model, tree_tensors
    from repro_torch.runtime import sharding
    out = {}
    with dryrun.fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        model_g, data_g = mesh.get_group(1), mesh.get_group(0)
        with FakeTensorMode():
            x, w = torch.empty(8, 16), torch.empty(16, 32)

            def layer():
                y = x @ w
                dist.all_reduce(y, group=data_g)
                parts = [torch.empty(16, 32) for _ in range(2)]
                dist.all_gather(parts, w, group=model_g)
                dist.reduce_scatter_tensor(torch.empty(4, 32), y,
                                           group=model_g)
                dist.all_to_all_single(torch.empty(8, 32), y, group=data_g)
                return y
            _, c = dryrun.count(layer)
        out["layer"] = dict(flops=c.flops, bytes=c.bytes,
                            collectives=c.collectives)
    cell = dryrun.run_cell("qwen2_1_5b", "prefill_32k", False, overrides=dict(
        reduced=True, cfg_n_layers=1, mesh=MESHES["2x2"], seq_len=16,
        global_batch=4))
    cfg = get_config("qwen2_1_5b", reduced=True).replace(n_layers=1)
    model = Model(cfg)
    shapes, axes = model.abstract_params()
    # (tree_tensors: map_axes's order)
    tp = iter(tree_tensors(model.tensor_parallel_mask(shapes)))
    mesh_shape = sharding.MeshShape(("data", "model"), (2, 2))

    def gathered(ax, t):
        spec = sharding.spec_for(ax, t.shape, mesh_shape)
        names = {n for e in spec if e is not None
                 for n in ((e,) if isinstance(e, str) else e)}
        if next(tp):                 # the rank keeps its model block
            names.discard("model")
        n = torch.Size(sharding.local_shape(spec, t.shape, mesh_shape.shape)
                       ).numel() * t.element_size()
        total = 0
        for name in ("model", "data"):   # _gather: innermost mesh dim first
            if name in names:
                n *= 2
                total += n
        return total
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    rows = 4 // 2                        # the batch over data
    out["prefill"] = dict(
        collectives=cell["collectives"],
        want=sum(tree_tensors(sharding.map_axes(gathered, axes, shapes))),
        # the last position's logits gathered over model
        logits=rows * cfg.padded_vocab * item,
        # the embedding's and each layer's attention and MLP sums over
        # model, of [rows, 16, d] each, twice their bytes (ring)
        reduces=2 * (1 + 2 * cfg.n_layers) * rows * 16 * cfg.d_model * item)
    return out


def _micro(_mesh: str) -> dict:
    """One counted microbatch against every microbatch counted, at
    grad_accum 4 (reduced qwen2-72B, and DBRX with int8 compression)."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, extra in (("qwen2_72b", {}), ("dbrx_132b",
                                            {"compress": "int8"})):
        over = dict(reduced=True, mesh=MESHES["2x2"], seq_len=16,
                    global_batch=16, grad_accum=4, **extra)
        one = dryrun.run_cell(arch, "train_4k", False, overrides=over)
        every = dryrun.run_cell(arch, "train_4k", False, overrides=dict(
            over, count_every_microbatch=True))
        out[arch] = dict(one=one, every=every)
    return out


# Reduced qwen2-72B's train step on (1, 4): B 8 x 32 at grad_accum 1.
TP_MESH = [[1, 4], ["data", "model"]]
TP_SHAPE = (32, 8)


def _tp_train(_mesh: str) -> dict:
    """Reduced qwen2-72B's train cell on the (1, 4) fake mesh."""
    from repro_torch.launch import dryrun
    seq, batch = TP_SHAPE
    return dryrun.run_cell("qwen2_72b", "train_4k", False, overrides=dict(
        reduced=True, mesh=TP_MESH, seq_len=seq, global_batch=batch,
        grad_accum=1))


def _tp_parity(_mesh: str) -> dict:
    """The port's dry-run FLOPs of the PARITY_OVER qwen2-72B train step at
    one layer on the (1, 4) fake mesh."""
    from repro_torch.launch import dryrun
    B, S = PARITY_BATCH
    over = {f"cfg_{k}": v for k, v in PARITY_OVER["qwen2_72b"].items()}
    return dryrun.run_cell("qwen2_72b", "train_4k", False, overrides=dict(
        over, cfg_n_layers=1, mesh=TP_MESH, seq_len=S, global_batch=B,
        grad_accum=1))


def _tp_train_mla_moe(_mesh: str) -> dict:
    """Reduced DeepSeek-V2's train cell on the (1, 4) fake mesh."""
    from repro_torch.launch import dryrun
    seq, batch = TP_SHAPE
    return dryrun.run_cell("deepseek_v2_236b", "train_4k", False,
                           overrides=dict(reduced=True, mesh=TP_MESH,
                                          seq_len=seq, global_batch=batch,
                                          grad_accum=1))


CASES = dict(cells=_cells, hand=_hand, micro=_micro, tp_train=_tp_train,
             tp_parity=_tp_parity, tp_train_mla_moe=_tp_train_mla_moe)


def _run(case: str, mesh: str, tmp_path) -> dict:
    path = os.path.join(str(tmp_path), f"{case}.json")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), case,
                          mesh, path], env=env, capture_output=True,
                         text=True, timeout=RUN_TIMEOUT_S)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-6000:])
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_reduced_cell_counts_every_cost(mesh, tmp_path):
    """Each reduced cell of the ten archs: flops, bytes, the five
    collective kinds and their total, the roofline's three times, the
    dominant one and ``hw``; everything positive where the cell must do
    it (every cell gathers parameters; a train cell also all-reduces
    gradients, a long_500k decode combines its cache segments)."""
    from repro_torch.configs import get_config, list_archs
    cells = _run("cells", mesh, tmp_path)
    want = {f"{a}/{s}" for a in list_archs() for s in REDUCED_SHAPES
            if s != "long_500k" or get_config(a).sub_quadratic}
    assert set(cells) == want and len(want) == 33
    for name, c in cells.items():
        for k in COST_KEYS:
            assert c[k] > 0, (name, k)
        coll = c["collectives"]
        assert set(coll) == {"all-reduce", "all-gather", "reduce-scatter",
                             "all-to-all", "collective-permute", "total"}
        assert coll["total"] == sum(v for k, v in coll.items()
                                    if k != "total")
        assert coll["all-gather"] > 0, name
        r = c["roofline"]
        assert min(r["t_compute"], r["t_memory"], r["t_collective"]) > 0
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r[f"t_{r['dominant']}"] == max(
            r["t_compute"], r["t_memory"], r["t_collective"])
        assert c["hw"]["peak_flops"] == 989e12
        assert r["t_compute"] == c["flops_per_device"] / 989e12
        if c["kind"] == "train":
            assert coll["all-reduce"] > 0 and c["counted_microbatches"] == 1
        if c["shape"] == "long_500k":
            # batch 1: the cache split by sequence over data, the
            # segments combined by all-reduces in every attention layer;
            # mamba2 has none and only sums over model its vocab-parallel
            # embedding [1, 1, d] and each tensor-parallel mixer's output
            # [1, 1, d] and float32 norm statistic [1, 1, 1] (no MLP)
            cfg = get_config(c["arch"], reduced=True)
            embed = 2 * cfg.d_model * torch.empty(
                (), dtype=cfg.compute_dtype).element_size()
            if cfg.family == "decoder":
                assert coll["all-reduce"] == embed + cfg.n_layers * (
                    embed + 2 * 4), name
            else:
                assert coll["all-reduce"] > embed, name
        assert "memory" in c and c["memory"]["param_bytes"] > 0


def test_counters_match_hand_counts(tmp_path):
    """x [8, 16] @ w [16, 32] is 2·8·16·32 FLOPs and moves its operands
    and result once; an all-reduce of the [8, 32] float32 result counts
    twice its bytes, an all-gather of w over two ranks its [2 × 16, 32]
    result, a reduce-scatter its [4, 32] block, an all-to-all its [8, 32]
    result. A one-layer tensor-parallel prefill on (2, 2) all-gathers each
    sharded parameter once, innermost mesh axis first, over ``data`` only
    (each rank keeps its heads, MLP columns and vocabulary rows), and the
    last logits over ``model``; it all-reduces over ``model`` the
    embedding and each layer's attention and MLP outputs."""
    out = _run("hand", "2x2", tmp_path)
    layer = out["layer"]
    assert layer["flops"] == 2 * 8 * 16 * 32
    f32 = 4
    assert layer["collectives"] == {
        "all-reduce": 2 * 8 * 32 * f32, "all-gather": 2 * 16 * 32 * f32,
        "reduce-scatter": 4 * 32 * f32, "all-to-all": 8 * 32 * f32,
        "collective-permute": 0}
    # the matmul's operands and result; the collectives are not memory
    assert layer["bytes"] == (8 * 16 + 16 * 32 + 8 * 32) * f32
    pre = out["prefill"]
    assert pre["want"] > 0
    assert pre["collectives"]["all-gather"] == pre["want"] + pre["logits"]
    assert pre["collectives"]["all-reduce"] == pre["reduces"]
    assert pre["collectives"]["total"] == (pre["want"] + pre["logits"]
                                           + pre["reduces"])


def test_one_microbatch_times_grad_accum_is_exact(tmp_path):
    """At grad_accum 4: the one-microbatch count, multiplied, with the
    accumulation and the update once, equals every microbatch run and
    counted — FLOPs, bytes and each collective kind, exactly."""
    out = _run("micro", "2x2", tmp_path)
    for arch, r in out.items():
        one, every = r["one"], r["every"]
        assert one["counted_microbatches"] == 1
        assert every["counted_microbatches"] == 4
        for k in COST_KEYS:
            assert one[k] == every[k], (arch, k)
        assert one["collectives"] == every["collectives"], arch
        assert one["roofline"] == every["roofline"], arch


PARITY_OVER = dict(
    qwen2_1_5b=dict(d_model=512, n_heads=4, n_kv=2, head_dim=128,
                    d_ff=1024, vocab=4096, remat="none"),
    qwen2_72b=dict(d_model=512, n_heads=4, n_kv=2, head_dim=128,
                   d_ff=1024, vocab=4096, remat="none"),
    mamba2_2_7b=dict(d_model=512, d_inner=1024, ssm_state=64,
                     ssm_head_dim=64, vocab=4096, ssd_chunk=64,
                     remat="none"))
PARITY_BATCH = (4, 256)


def _flops(arch: str, kind: str, depth: int):
    """(the reference's ``cost_analysis()["flops"]`` of its jitted step,
    the port's ``FlopCounterMode`` count of the same step under fake
    tensors) at ``depth`` layers, one device, grad_accum 1."""
    import jax
    import jax.numpy as jnp
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import get_config as jax_get_config
    from repro.models import Model as JaxModel
    from repro.optim import adamw as jadamw
    from repro.runtime import train_loop as jtrain_loop
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    over = dict(PARITY_OVER[arch], n_layers=depth)
    B, S = PARITY_BATCH
    jm = JaxModel(jax_get_config(arch).replace(**over))
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))[0])
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        jopt = jadamw()
        lowered = jax.jit(jtrain_loop.make_train_step(jm, jopt)).lower(
            jp, jax.eval_shape(jopt.init, jp), dict(tokens=tok, labels=tok),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
    else:
        lowered = jax.jit(jtrain_loop.make_prefill_step(jm)).lower(
            jp, dict(tokens=tok))
    ref = float(lowered.compile().cost_analysis()["flops"])
    model = Model(get_config(arch).replace(**over))
    with FakeTensorMode():
        params = dryrun.fake_tree(model.abstract_params()[0])
        tokens = torch.empty(B, S, dtype=torch.int64)
        if kind == "train":
            opt = adamw()
            _, c = dryrun.count(train_loop.make_train_step(model, opt),
                                params, opt.init(params),
                                dict(tokens=tokens, labels=tokens))
        else:
            with torch.no_grad():
                _, c = dryrun.count(train_loop.make_prefill_step(model),
                                    params, dict(tokens=tokens))
    return ref, c.flops


def test_tensor_parallel_train_flops_match_hand_count(tmp_path):
    """Reduced qwen2-72B (d 64, 4 q heads over 2 kv heads of 16, d_ff 160,
    vocabulary 2048 padded, untied head, 2 layers, remat none) on (1, 4),
    B 8 x 32: one rank's products are its 1 q head and the 1 kv head it
    reads (the replicated kv weights sliced before the product), 40 MLP
    columns and 512 vocabulary rows. Each projection x [T, n] @ W [n, m]
    is 2·T·n·m forward and twice that backward (the input's and the
    weight's gradients); the blocked attention's scores and values
    products are 2·B·S·S·D each per head, forward, again in the
    checkpointed block's recompute, and four in its backward."""
    c = _run("tp_train", "1x4", tmp_path)
    S, B = TP_SHAPE
    T, d, D, layers = B * S, 64, 16, 2
    heads, kv, cols, vocab = 4 // 4, 1, 160 // 4, 2048 // 4

    def proj(n, m):
        return 3 * 2 * T * n * m
    per_layer = (proj(d, heads * D) + 2 * proj(d, kv * D)
                 + proj(heads * D, d) + 2 * proj(d, cols) + proj(cols, d)
                 + 7 * 2 * B * heads * S * S * D)
    assert c["flops_per_device"] == layers * per_layer + proj(d, vocab)
    assert c["counted_microbatches"] == 1


def test_tensor_parallel_mla_moe_train_flops_match_hand_count(tmp_path):
    """Reduced DeepSeek-V2 (d 64; MLA of 4 heads, q_lora 32, kv_lora 16,
    q/k 16 + 8 RoPE, v 16; a dense first layer of d_ff 128; 2 MoE layers
    of 8 experts top-2 of d_ff 48 and a shared expert of 48; vocabulary
    2048 padded, untied head; remat none) on (1, 4), B 8 x 32: one rank's
    products are the replicated latents (``wq_a``, ``wkv_a``) and router
    whole, its 1 MLA head (``wq_b``, ``wkv_b_k``, ``wkv_b_v``, ``wo``),
    its 2 experts at capacity 10 a row (three batched products of [2,
    8·10, 64] by 64 x 48), 12 shared-expert and 32 dense-MLP columns and
    512 vocabulary rows. Each product is 2·(its sizes) forward and twice
    that backward; per head the blocked attention computes its scores
    (D 24) forward, again in the checkpointed block's recompute and twice
    in the backward, and its values product (D 16) forward and twice in
    the backward."""
    c = _run("tp_train_mla_moe", "1x4", tmp_path)
    S, B = TP_SHAPE
    T, d = B * S, 64
    C = 10                                  # int(32 · 2 / 8 · 1.25)

    def proj(n, m):
        return 3 * 2 * T * n * m
    mla = (proj(d, 32) + proj(32, 24) + proj(d, 24) + 2 * proj(16, 16)
           + proj(16, d) + 4 * 2 * B * S * S * 24 + 3 * 2 * B * S * S * 16)
    moe = proj(d, 8) + 3 * 3 * 2 * 2 * B * C * d * 48
    shared = 2 * proj(d, 12) + proj(12, d)
    dense = 2 * proj(d, 32) + proj(32, d)
    assert c["flops_per_device"] == (mla + dense + 2 * (mla + moe + shared)
                                     + proj(d, 2048 // 4))
    assert c["counted_microbatches"] == 1


_JAX_PARTITIONED = r"""
import dataclasses, json, math, re, sys
from repro.launch.devices import set_host_platform_device_count
set_host_platform_device_count(4)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import SHAPES, get_config
from repro.models import Model
from repro.models.common import split_tree
from repro.optim import adamw
from repro.runtime import sharding
from repro.runtime.train_loop import make_train_step
over, B, S = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
model = Model(get_config("qwen2_72b").replace(**over, n_layers=1))
rules = dict(sharding.DEFAULT_RULES)
pshapes, pspecs = model.abstract_params()
params = sharding.abstract_with_sharding(pshapes, pspecs, mesh, rules)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S, global_batch=B)
in_shapes, in_specs = split_tree(jax.eval_shape(
    lambda: model.make_inputs(shape)))
batch = sharding.abstract_with_sharding(in_shapes, in_specs, mesh, rules)
opt = adamw()
ost = jax.eval_shape(opt.init, pshapes)
rep = NamedSharding(mesh, PartitionSpec())
ostate = type(ost)(
    step=jax.ShapeDtypeStruct((), jnp.int32, sharding=rep),
    mu=sharding.abstract_with_sharding(ost.mu, pspecs, mesh, rules),
    nu=sharding.abstract_with_sharding(ost.nu, pspecs, mesh, rules))
key = jax.ShapeDtypeStruct((2,), jnp.uint32, sharding=rep)
with jax.set_mesh(mesh):
    compiled = jax.jit(make_train_step(model, opt), donate_argnums=(0, 1)
                       ).lower(params, ostate, batch, key).compile()
# The partitioned module's products: 2 x the output's size x the
# contracted size of every dot (each computation's once, as
# cost_analysis counts them).
text = compiled.as_text()
shapes = {m.group(1): [int(x) for x in m.group(2).split(",") if x]
          for m in re.finditer(r"%([\w.-]+) = \w+\[([0-9,]*)\]", text)}
dots = 0
for m in re.finditer(r"= \w+\[([0-9,]*)\]\S* dot\(%([\w.-]+), %[\w.-]+\)"
                     r"(?:, lhs_batch_dims=\{[0-9,]*\})?"
                     r", lhs_contracting_dims=\{([0-9,]*)\}", text):
    out = [int(x) for x in m.group(1).split(",") if x]
    lhs = shapes[m.group(2)]
    dots += 2 * math.prod(out) * math.prod(
        lhs[int(c)] for c in m.group(3).split(","))
print(json.dumps([float(compiled.cost_analysis()["flops"]), dots]))
"""


def test_tensor_parallel_flops_match_reference_partitioned_count(tmp_path):
    """The PARITY_OVER qwen2-72B train step at one layer (4 q heads over
    2 kv heads of 128, d 512, d_ff 1024, vocabulary 4096; B 4 x 256,
    grad_accum 1) on a (1, 4) ("data", "model") mesh, jitted by the
    reference over four host devices in a JAX subprocess: its partitioned
    module's dots are the products of one rank's heads (the kv weights
    sliced to the rank's kv head, as the port slices them), MLP columns
    and vocabulary rows, and the port's per-device FLOPs are within
    FLOP_RTOL of their sum (+0.88 % when this was written: the port's
    checkpointed attention block recomputes its scores, which XLA keeps).
    XLA's ``cost_analysis`` adds elementwise work, much of which every
    ``model`` rank does whole (the norms, the residual stream): 2.95 %
    above the port's count here, where at one device it is 1.44 %
    (ROADMAP queue 3, findings in the reference)."""
    port = _run("tp_parity", "1x4", tmp_path)["flops_per_device"]
    B, S = PARITY_BATCH
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _JAX_PARTITIONED,
                          json.dumps([PARITY_OVER["qwen2_72b"], B, S])],
                         env=env, capture_output=True, text=True,
                         timeout=RUN_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    cost, dots = json.loads(res.stdout.strip().splitlines()[-1])
    assert abs(port / dots - 1) <= FLOP_RTOL, (port, dots)
    assert port < cost, (port, cost)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "mamba2_2_7b"])
def test_flops_match_reference_cost_analysis_at_one_layer(arch, kind):
    """At one layer per stack and grad_accum 1 (qwen2-1.5B and mamba2-2.7B
    at d 512, B 4 × 256) the port's FLOPs are within FLOP_RTOL of the
    reference's ``cost_analysis``; at two layers the port counts the
    second layer and the reference does not (XLA counts a ``lax.scan``
    body once: ROADMAP queue 3), so the dry run's figures are the whole
    step's where the reference's are one layer's."""
    ref1, port1 = _flops(arch, kind, 1)
    assert abs(port1 / ref1 - 1) <= FLOP_RTOL, (port1, ref1)
    ref2, port2 = _flops(arch, kind, 2)
    assert abs(ref2 / ref1 - 1) <= FLOP_RTOL, (ref2, ref1)
    assert port2 / port1 > 1.3, (port2, port1)


if __name__ == "__main__":
    case, mesh_name, out_path = sys.argv[1:]
    result = CASES[case](mesh_name)
    with open(out_path, "w") as f:
        json.dump(result, f)
