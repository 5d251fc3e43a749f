"""The port's logical axes and their resolution against the reference's
``runtime/sharding.py``, with no ranks: every parameter, cache and input
leaf of all ten architectures at full size has the reference's axes and
resolves to the reference's ``spec_for`` on the production meshes, a 2×2
and a 1×1 mesh, under the default rules and each dry-run variant's;
``Model.abstract_params`` matches the reference's ``abstract_params``
leaf for leaf on the meta device; the dry run's per-device bytes equal
the reference's ``NamedSharding.shard_shape`` sums; ``Model.init``'s
draws are bitwise what they were before the axes were added.

The port keeps per-layer lists where the reference stacks layers: a port
leaf at ``layers/3/attn/wq`` is the reference's ``layers/attn/wq`` less
its leading ``"layers"`` axis (two of them inside vision's groups).
"""
import hashlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models.common import split_tree as jax_split_tree
from repro.runtime import sharding as jshard
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import transformer
from repro_torch.models.common import META, P, split_tree
from repro_torch.models.model import Model, tree_tensors
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import sharding

ARCHS = list(list_archs())
MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (2, 2)),
          (("data", "model"), (1, 1))]
RULE_SETS = {name: dict(sharding.DEFAULT_RULES, **v.get("rules", {}))
             for name, v in dryrun.VARIANTS.items()}
# sha256 (first 16 hex digits) of each reduced config's
# ``Model.init(torch.Generator().manual_seed(0))`` leaves (shape, dtype,
# bytes in ``tree_leaves`` order), as the tree without logical axes drew
# them: the axes must not move a single draw.
INIT_DIGESTS = {
    "dbrx_132b": "2ebfe62ca98d4dd5", "deepseek_v2_236b": "1390fbf35e827560",
    "seamless_m4t_large_v2": "979472b2e6281afc",
    "qwen2_1_5b": "35ae6a1bde033ab7", "gemma3_4b": "a87f0f90c3115fde",
    "minicpm3_4b": "5ba6a5aa4a79488c", "recurrentgemma_2b": "01e36614f8e8a7f1",
    "llama_3_2_vision_11b": "5f09d253f2afb72a",
    "mamba2_2_7b": "149897deaf2cbe32"}


class FakeMesh:
    """Duck-typed mesh: .shape mapping only (what both resolvers read)."""
    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))
        self.axis_names = tuple(names)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, str) for e in x)


def port_leaves(values, axes, prefix=()):
    """[(reference path, stacked depth, value, axes)] of a port tree: list
    indices (per-layer stacks) leave the path and count as a stacking
    axis; tuple indices (the reference's own tuples) stay."""
    if axes is None:
        return []
    if _is_axes(axes) and isinstance(values, torch.Tensor):
        return [(prefix, 0, values, axes)]
    if isinstance(axes, dict):
        return [leaf for k in axes
                for leaf in port_leaves(values[k], axes[k], prefix + (k,))]
    out = []
    for i, (v, a) in enumerate(zip(values, axes)):
        if isinstance(axes, list):
            out += [(p, n + 1, t, x) for p, n, t, x in
                    port_leaves(v, a, prefix)]
        else:
            out += port_leaves(v, a, prefix + (str(i),))
    return out


def ref_leaves(values, axes):
    """{path: (ShapeDtypeStruct, axes)} of a reference (values, axes)
    pair."""
    flat, _ = jax.tree_util.tree_flatten_with_path(values)
    ax = jax.tree_util.tree_leaves(axes, is_leaf=_is_axes)
    return {tuple(str(getattr(q, "key", getattr(q, "idx", q))) for q in p):
            (v, a) for (p, v), a in zip(flat, ax)}


def _paired(port_values, port_axes, ref_values, ref_axes):
    """Each port leaf with its reference leaf (every reference leaf met):
    [(path, port value, port axes, reference value, reference axes,
    stacking depth)], the reference's leading axes checked to be
    ``"layers"`` ``depth`` times."""
    ref = ref_leaves(ref_values, ref_axes)
    out, seen = [], set()
    for path, depth, t, axes in port_leaves(port_values, port_axes):
        assert path in ref, path
        seen.add(path)
        rv, ra = ref[path]
        assert tuple(ra[:depth]) == ("layers",) * depth, (path, ra)
        out.append((path, t, axes, rv, tuple(ra), depth))
    assert seen == set(ref), set(ref) - seen
    return out


def _same_leaves(pairs, dtypes=True):
    for path, t, ax, rv, ra, depth in pairs:
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(rv.shape[depth:]), path
        assert ax == ra[depth:], path
        if dtypes:
            assert str(t.dtype).split(".")[1] == np.dtype(rv.dtype).name, \
                path


def _same_specs(pairs):
    """On every mesh under every variant's rules."""
    for names, sizes in MESHES:
        mesh = FakeMesh(names, sizes)
        for rules in RULE_SETS.values():
            for path, t, ax, rv, ra, depth in pairs:
                want = tuple(jshard.spec_for(ra, rv.shape, mesh, rules))
                assert sharding.spec_for(ax, t.shape, mesh, rules) == \
                    want[depth:], (path, names, sizes)


def _ref_abstract(arch):
    return JaxModel(jax_get_config(arch)).abstract_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_specs_match_reference(arch):
    """Keys, shapes, dtypes and axes of every parameter leaf equal the
    reference's; every leaf on the meta device; the parameter count is
    the reference's; each leaf's spec equals the reference's ``spec_for``
    (less the stacking axes) on every mesh under every variant's rules."""
    model = Model(get_config(arch))
    values, axes = model.abstract_params()
    rvalues, raxes = _ref_abstract(arch)
    pairs = _paired(values, axes, rvalues, raxes)
    _same_leaves(pairs)
    assert model.param_count() == JaxModel(
        jax_get_config(arch)).param_count()
    if arch == "qwen2_72b":
        assert model.param_count() == 72_731_369_472
    _same_specs(pairs)


def _cells(arch):
    sub_q = get_config(arch).sub_quadratic
    return [s for s in SHAPES if s != "long_500k" or sub_q]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_match_reference(arch):
    """Every input and decode-cache leaf of every ``SHAPES`` cell
    (long_500k only where the arch is sub-quadratic): shape and axes the
    reference's, on the meta device, and the reference's spec on every
    mesh under every variant's rules."""
    model, jm = Model(get_config(arch)), JaxModel(jax_get_config(arch))
    for cell in _cells(arch):
        shape = SHAPES[cell]
        values, axes = model.abstract_inputs(shape)
        rvalues, raxes = jax_split_tree(jax.eval_shape(
            lambda: jm.make_inputs(JAX_SHAPES[cell])))
        pairs = _paired(values, axes, rvalues, raxes)
        _same_leaves(pairs)
        _same_specs(pairs)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_are_unchanged_and_abstract_params_draw_nothing(arch):
    """``Model.init`` gives the same bits as before the axes (digests of
    the reduced configs); ``init_cache`` and ``make_inputs`` are the
    values of the trees ``cache_axes`` / ``abstract_inputs`` describe;
    ``abstract_params`` allocates no storage and leaves the generator and
    torch's global RNG alone."""
    cfg = get_config(arch, reduced=True)
    model = Model(cfg)
    gen = torch.Generator().manual_seed(0)
    state, global_state = gen.get_state(), torch.get_rng_state()
    shapes, axes = model.abstract_params()
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(torch.get_rng_state(), global_state)
    assert all(t.device.type == "meta" for t in tree_tensors(shapes))
    params = model.init(gen)
    if arch in INIT_DIGESTS:
        h = hashlib.sha256()
        for t in tree_leaves(params):
            h.update(str(tuple(t.shape)).encode())
            h.update(str(t.dtype).encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest()[:16] == INIT_DIGESTS[arch]
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [tuple(t.shape) for t in tree_leaves(shapes)]
    cache = model.init_cache(2, 8, "cpu", src_len=3, n_img=4)
    cshapes, _ = model.cache_axes(2, 8, src_len=3, n_img=4)
    assert [tuple(t.shape) for t in tree_tensors(cache)] == \
        [tuple(t.shape) for t in tree_tensors(cshapes)]
    with pytest.raises(ValueError, match="do not name"):
        P(torch.zeros(2, 3), ("embed",))
    tree = transformer.init(cfg, META)
    assert split_tree(tree)[1] == axes


def _ref_device_bytes(arch, names, sizes):
    """Per-device parameter bytes of the reference's abstract params by
    ``NamedSharding(AbstractMesh, spec_for(...)).shard_shape``."""
    mesh = AbstractMesh(sizes, names)
    values, axes = _ref_abstract(arch)
    total = 0
    for (v, a) in ref_leaves(values, axes).values():
        spec = jshard.spec_for(a, v.shape, mesh)
        shard = NamedSharding(mesh, spec).shard_shape(v.shape)
        total += int(np.prod(shard)) * np.dtype(v.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ["qwen2_72b", "deepseek_v2_236b",
                                  "llama_3_2_vision_11b"])
def test_dryrun_parameter_bytes_equal_reference_shard_shapes(arch):
    """The dry run's per-device parameter bytes on 16×16, 2×16×16 and
    2×2 equal the reference's shard-shape sums; for qwen2-72B the figures
    728,530,944 / 728,530,944 / 36,368,072,704 B (``kv_heads`` 8 does not
    divide ``model`` 16 and stays replicated)."""
    model = Model(get_config(arch))
    values, axes = model.abstract_params()
    got = {}
    for names, sizes in MESHES[:3]:
        mesh = sharding.MeshShape(names, sizes)
        got[sizes] = dryrun._device_bytes(values, axes, mesh,
                                          sharding.DEFAULT_RULES)
        assert got[sizes] == _ref_device_bytes(arch, names, sizes), sizes
    if arch == "qwen2_72b":
        assert got == {(16, 16): 728_530_944, (2, 16, 16): 728_530_944,
                       (2, 2): 36_368_072_704}


def test_dryrun_cells_grad_accum_and_skip_rule(tmp_path):
    """``main --all --both-meshes`` writes every cell: 66 runnable (10
    archs × 3 shapes × 2 meshes + 3 sub-quadratic × long_500k × 2) and
    14 skipped; grad_accum follows the reference's rule (qwen2-72B 16 at
    train_4k, 2 at prefill_32k, as tests/test_dryrun_tools.py has it);
    the cell for qwen2-72B train_4k holds the dry-run figures. With
    ``--memory-only`` (the per-device bytes in seconds; the costs of the
    whole sweep take minutes, and tests/test_torch_dryrun.py counts them
    on reduced cells) no cost key is written."""
    import json
    jax.devices()       # the backend is up before the reference's module
    from repro.launch import dryrun as jdryrun
    for arch in ARCHS:
        for s in SHAPES:
            assert dryrun._grad_accum_for(get_config(arch), SHAPES[s]) == \
                jdryrun._grad_accum_for(jax_get_config(arch), JAX_SHAPES[s])
    q = get_config("qwen2_72b")
    assert dryrun._grad_accum_for(q, SHAPES["train_4k"]) == 16
    assert dryrun._grad_accum_for(q, SHAPES["prefill_32k"]) == 2
    assert dryrun.VARIANTS == jdryrun.VARIANTS
    dryrun.main(["--all", "--both-meshes", "--memory-only", "--out",
                 str(tmp_path)])
    cells = [json.load(open(p)) for p in tmp_path.glob("*.json")]
    assert len(cells) == 80
    skipped = [c for c in cells if c.get("skipped")]
    assert len(skipped) == 14
    assert {c["shape"] for c in skipped} == {"long_500k"}
    assert {c["arch"] for c in skipped} == {
        a for a in ARCHS if not jax_get_config(a).sub_quadratic}
    assert dryrun.cell_path(str(tmp_path), "qwen2_72b", "train_4k", True,
                            "baseline").endswith(
        "qwen2_72b.train_4k.pod2.baseline.json")
    cell = json.load(open(dryrun.cell_path(str(tmp_path), "qwen2_72b",
                                           "train_4k", False, "baseline")))
    assert cell["memory"]["param_bytes"] == 728_530_944
    assert cell["memory"]["opt_state_bytes"] == 4 * 728_530_944
    assert cell["grad_accum"] == 16 and cell["chips"] == 256
    assert cell["params"] == 72_731_369_472
    assert "roofline" not in cell and "flops_per_device" not in cell
    with pytest.raises(dryrun.SkipCell):
        dryrun.build_cell("qwen2_72b", "long_500k", False)


# -- the resolver, placements and blocks ----------------------------------

def test_spec_rules_match_reference_tests():
    """The reference's own sharding cases (tests/test_runtime.py)."""
    mesh = FakeMesh(("data", "model"), (16, 16))
    assert sharding.spec_for(("embed", "heads", "head_dim"),
                             (1536, 12, 128), mesh) == ("data", None, None)
    assert sharding.spec_for(("embed", "mlp"), (1536, 8960), mesh) == \
        ("data", "model")
    assert sharding.spec_for(("experts", "embed", "mlp"),
                             (16, 6144, 10752), mesh) == \
        ("model", "data", None)
    cache = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    assert sharding.spec_for(cache, (128, 32768, 8, 128), mesh)[:2] == \
        ("data", None)
    assert sharding.spec_for(cache, (1, 524288, 4, 256), mesh)[:2] == \
        (None, "data")
    pod = FakeMesh(("pod", "data", "model"), (2, 16, 16))
    assert sharding.spec_for(("act_batch", "act_seq"), (256, 4096),
                             pod)[0] == ("pod", "data")
    with sharding.rule_overrides({"act_seq": ("data", "model")}) as rules:
        assert rules["act_seq"] == ("data", "model")
        assert sharding.spec_for(("act_batch", "act_seq"), (1, 4096),
                                 mesh) == (None, ("data", "model"))
    assert sharding.active_rules() == sharding.DEFAULT_RULES
    assert tuple(PartitionSpec("data", None)) == ("data", None)


def test_placements_and_blocks_nest_major_to_minor():
    """("pod", "data") on one dimension: Shard(0) on both mesh dims, and
    the block of coordinate (pod p, data d) is p * data + d."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = sharding.MeshShape(("pod", "data", "model"), (2, 2, 2))
    spec = (("pod", "data"), "model")
    assert sharding.placements(spec, mesh) == [Shard(0), Shard(0), Shard(1)]
    assert sharding.placements((None, None), mesh) == [Replicate()] * 3
    assert sharding.local_shape(spec, (8, 6), mesh.shape) == (2, 3)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                sl = sharding.local_slices(spec, (8, 6), mesh.shape,
                                           dict(pod=p, data=d, model=m))
                row = 2 * (2 * p + d)
                assert sl == (slice(row, row + 2), slice(3 * m, 3 * m + 3))
    with pytest.raises(NotImplementedError, match="order"):
        sharding.placements((("data", "pod"),), mesh)


def test_constrain_refuses_a_sequence_sharded_layout():
    """With no layout ``constrain`` is the identity; at batch 1 on four
    data ranks the rules shard the sequence (the reference's
    fall-through): under a layout with its segments over ``data`` the
    rank's segment passes, and the whole sequence under a layout without
    them raises rather than pass as replicated; an embedding split over
    ``data``, which no rule set of the reference makes, raises; rows
    that do not match the layout raise too."""
    residual = ("act_batch", "act_seq", "act_embed")
    x = torch.zeros(1, 8, 4)
    assert transformer.constrain(x, residual) is x
    mesh = sharding.MeshShape(("data", "model"), (4, 1))
    segment = x[:, :2]
    with sharding.activation_layout(sharding.Layout(
            mesh, 1, (), segment_axes=("data",))):
        assert transformer.constrain(segment, residual) is segment
    with sharding.activation_layout(sharding.Layout(mesh, 1, ())):
        with pytest.raises(ValueError, match="segments"):
            transformer.constrain(x, residual)
        with sharding.rule_overrides({"act_seq": (),
                                      "act_embed": ("data",)}):
            with pytest.raises(NotImplementedError,
                               match="act_embed over data"):
                transformer.constrain(x, residual)
    layout = sharding.Layout(mesh, 8, sharding.batch_axes(8, mesh))
    assert layout.batch_axes == ("data",) and layout.batch_ways == 4
    with sharding.activation_layout(layout):
        y = torch.zeros(2, 8, 4)
        assert transformer.constrain(y, ("act_batch", "act_seq",
                                         "act_vocab")) is y
        with pytest.raises(ValueError, match="rows"):
            transformer.constrain(x, residual)


def test_production_mesh_shapes_need_no_ranks():
    assert production_mesh_shape().shape == dict(data=16, model=16)
    assert production_mesh_shape(multi_pod=True).shape == dict(
        pod=2, data=16, model=16)
    assert production_mesh_shape(multi_pod=True).size == 512


# -- token dtype ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_72b", "mamba2_2_7b",
                                  "seamless_m4t_large_v2",
                                  "llama_3_2_vision_11b"])
def test_tokens_and_labels_are_the_references_dtype(arch):
    """``make_inputs`` and ``abstract_inputs`` (train, prefill, decode)
    and the pipeline's batches hold tokens and labels in the reference's
    dtype (int32), leaf for leaf against its ``make_inputs`` and its
    ``SyntheticTokens``."""
    import dataclasses
    from repro.data.pipeline import SyntheticTokens as JaxTokens
    from repro_torch.data import SyntheticTokens
    model = Model(get_config(arch, reduced=True))
    jm = JaxModel(jax_get_config(arch, reduced=True))
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[cell], global_batch=2,
                                    seq_len=16)
        jshape = dataclasses.replace(JAX_SHAPES[cell], global_batch=2,
                                     seq_len=16)
        rvalues, _ = jax_split_tree(jax.eval_shape(
            lambda: jm.make_inputs(jshape)))
        values = model.make_inputs(shape, "cpu")
        meta, _ = model.abstract_inputs(shape)
        for key in ("tokens", "labels"):
            if key not in rvalues:
                assert key not in values
                continue
            want = np.dtype(rvalues[key].dtype).name
            assert want == "int32"
            assert str(values[key].dtype) == f"torch.{want}", (cell, key)
            assert str(meta[key].dtype) == f"torch.{want}", (cell, key)
    ref = JaxTokens(vocab=128, seq_len=16, global_batch=2).batch(0)
    port = SyntheticTokens(128, 16, 2, device="cpu").batch(0)
    for key in ("tokens", "labels"):
        assert str(port[key].dtype) == \
            f"torch.{np.dtype(ref[key].dtype).name}" == "torch.int32"


def test_dryrun_input_bytes_equal_reference_shard_bytes():
    """Reduced qwen2-72B's train_4k cell on 16 x 16: the dry run's
    per-device input bytes equal the reference's shard-shape sum over
    its ``make_inputs`` leaves, 524,288 B (tokens and labels, [16, 4096]
    int32 each)."""
    cell = dryrun.build_cell("qwen2_72b", "train_4k", False,
                             overrides=dict(reduced=True))
    names, sizes = MESHES[0]
    mesh = AbstractMesh(sizes, names)
    jm = JaxModel(jax_get_config("qwen2_72b", reduced=True))
    values, axes = jax_split_tree(jax.eval_shape(
        lambda: jm.make_inputs(JAX_SHAPES["train_4k"])))
    want = 0
    for v, a in ref_leaves(values, axes).values():
        shard = NamedSharding(mesh, jshard.spec_for(a, v.shape, mesh)
                              ).shard_shape(v.shape)
        want += int(np.prod(shard)) * np.dtype(v.dtype).itemsize
    assert cell["memory"]["input_bytes"] == want == 524_288
