"""The dry run's costs (``repro_torch.launch.dryrun.run_cell``): what a
device computes, moves and sends in a cell, counted on rank 0 of a fake
process group under fake tensors.

- Every reduced cell of the ten archs (train, prefill, decode, and
  long_500k for the three sub-quadratic ones) on (2, 2) and (2, 2, 2)
  meshes: every cost key present and positive.
- The counters against hand counts: one linear layer and one collective
  of each kind; the all-gathers of a one-layer prefill from its
  parameters' specs.
- A train cell's one counted microbatch times ``grad_accum`` (plus the
  accumulation and the update once) equals the count of every microbatch
  run, exactly.
- Parity with the reference's ``cost_analysis()["flops"]`` at one layer
  per stack and grad_accum 1, and the finding that XLA counts a scanned
  layer body once (the reference's count stays put at depth 2, the
  port's grows).

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
    model = Model(get_config("qwen2_1_5b", reduced=True).replace(
        n_layers=1))
    shapes, axes = model.abstract_params()
    mesh_shape = sharding.MeshShape(("data", "model"), (2, 2))

    def gathered(ax, t):
        spec = sharding.spec_for(ax, t.shape, mesh_shape)
        names = {n for e in spec if e is not None
                 for n in ((e,) if isinstance(e, str) else e)}
        n = torch.Size(sharding.local_shape(spec, t.shape, mesh_shape.shape)
                       ).numel() * t.element_size()
        total = 0
        for name in ("model", "data"):   # _gather: innermost mesh dim first
            if name in names:
                n *= 2
                total += n
        return total
    want = sum(tree_tensors(sharding.map_axes(gathered, axes, shapes)))
    out["prefill"] = dict(collectives=cell["collectives"], want=want)
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


CASES = dict(cells=_cells, hand=_hand, micro=_micro)


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
            # segments combined by all-reduces in every attention layer
            # (mamba2 has none)
            assert (coll["all-reduce"] > 0) == (
                get_config(c["arch"]).family != "decoder"), name
        assert "memory" in c and c["memory"]["param_bytes"] > 0


def test_counters_match_hand_counts(tmp_path):
    """x [8, 16] @ w [16, 32] is 2·8·16·32 FLOPs and moves its operands
    and result once; an all-reduce of the [8, 32] float32 result counts
    twice its bytes, an all-gather of w over two ranks its [2 × 16, 32]
    result, a reduce-scatter its [4, 32] block, an all-to-all its [8, 32]
    result. A one-layer prefill all-gathers each sharded parameter once,
    innermost mesh axis first."""
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
    assert pre["collectives"]["all-gather"] == pre["want"]
    assert pre["collectives"]["all-reduce"] == 0
    assert pre["collectives"]["total"] == pre["want"]


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


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", list(PARITY_OVER))
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
