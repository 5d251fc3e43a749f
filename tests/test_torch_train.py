"""The port's LM training path against the JAX package's, on the CPU:
``make_train_step`` (one AdamW step, with and without microbatch
accumulation) against the jitted reference step; AdamW on a bf16 tree;
gradient compression; the synthetic token pipeline; the MoE auxiliary
loss; ``Model.make_inputs`` and the step shapes; and the flash and SSD
wrappers' gradients against autograd through their plain versions.

Every model here has live recurrences and gates: the reference's init
zeroes the Mamba-2 and RG-LRU convs and the vision cross layers' gates,
and a gradient through a zero conv or gate would test nothing there. The
draws are the same numbers on both sides (``train_pair``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro.models.common import split_tree
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.runtime import train_loop as jtrain_loop
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.data import SyntheticTokens, make_batch_iterator
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan import ssd_scan as sbinding
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.models import moe, ssm
from repro_torch.models.model import Model
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime.train_loop import make_train_step
from test_torch_lm import live_griffin
from test_torch_lm_mla_moe import live_gates, ref_cache_unstacked

# float32 on both sides: the loss in the same order of float32 sums up to
# reductions XLA and PyTorch order differently; a gradient leaf within
# 1e-4 of its largest entry.
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
# The steps below run at a constant learning rate that moves the
# parameters far past the tolerances: the first AdamW step moves an entry
# by lr * (g / (|g| + eps) + weight decay * p), about lr wherever its
# gradient is not zero. Updates are compared as (new - old) / lr: every
# entry within UPDATE_ATOL, and all but UPDATE_FRAC of them within
# UPDATE_TIGHT (an entry whose gradient is near eps or its own float32
# error steps by a fraction of lr that the two sides see apart).
STEP_LR = 1e-2
UPDATE_ATOL, UPDATE_TIGHT, UPDATE_FRAC = 0.25, 1e-3, 1e-3


def train_pair(arch, seed=0, dtype="float32", **over):
    """(jax model, jax params, port model, port params) at the reduced
    config with ``over`` applied on both sides, the reference's init with
    live Mamba-2 mixers, RG-LRU blocks and vision gates (the same numbers
    on both sides)."""
    jcfg = jax_get_config(arch, reduced=True).replace(
        dtype=dtype, param_dtype=dtype, **over)
    cfg = get_config(arch, reduced=True).replace(
        dtype=dtype, param_dtype=dtype, **over)
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 5)
    if cfg.ssm:
        draws = [ssm.draw_live_mixer(rng, cfg) for _ in range(cfg.n_layers)]
        mixer = dict(jp["layers"]["mixer"])
        for k in draws[0]:
            mixer[k] = jnp.asarray(np.stack([d[k] for d in draws]),
                                   mixer[k].dtype)
        jp = dict(jp, layers=dict(jp["layers"], mixer=mixer))
    if cfg.family == "griffin":
        jp = live_griffin(jp, cfg, rng)
    if cfg.family == "vision":
        jp = live_gates(jp, cfg, rng)
    return jm, jp, Model(cfg), lm_params_from_reference(jp, cfg)


def train_batch(cfg, B=2, S=20, seed=1, src_len=12):
    """(reference batch, port batch): tokens and labels [B, S] from the
    seed, and frames [B, src_len, d] (encdec) or patches [B,
    n_img_tokens, d] (vision), float32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    data = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    if cfg.family == "encdec":
        data["frames"] = rng.standard_normal(
            (B, src_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vision":
        data["patches"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    pb = {k: (torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v)) for k, v in data.items()}
    return jb, pb


def port_loss_and_grads(m, pp, pb):
    live = tree_map(lambda t: t.detach().requires_grad_(True), pp)
    loss = m.loss(live, pb)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), tree_unflatten(pp, grads)


def assert_grads_close(port, ref):
    """Leaf by leaf (``tree_leaves`` order): within GRAD_REL of the
    reference leaf's largest entry."""
    pl, rl = tree_leaves(port), tree_leaves(ref)
    assert len(pl) == len(rl) > 0
    for a, b in zip(pl, rl):
        a, b = a.float().numpy(), b.float().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_REL * np.abs(b).max())


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def assert_same_update(old, new, want):
    """(new - old) / STEP_LR against (want - old) / STEP_LR, leaf by leaf
    (``tree_leaves`` order): every entry within UPDATE_ATOL, all but
    UPDATE_FRAC of them within UPDATE_TIGHT; and the update is visible,
    with at least a quarter of the entries moving by more than half a
    step (a skipped update would fail)."""
    far = tight_off = n = 0
    worst = 0.0
    for o, a, b in zip(tree_leaves(old), tree_leaves(new),
                       tree_leaves(want)):
        got, ref = ((_np(t) - _np(o)) / STEP_LR for t in (a, b))
        d = np.abs(got - ref)
        worst = max(worst, float(d.max()))
        tight_off += int((d > UPDATE_TIGHT).sum())
        far += int((np.abs(ref) > 0.5).sum())
        n += d.size
    assert worst <= UPDATE_ATOL, worst
    assert tight_off <= UPDATE_FRAC * n, (tight_off, n)
    assert far >= n / 4, (far, n)


# -- make_train_step against the jitted reference step -----------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2_1_5b", "recurrentgemma_2b",
                                  "dbrx_132b", "deepseek_v2_236b"])
def test_train_step_matches_reference(arch, grad_accum):
    """One step (loss, gradients, clipping, AdamW) at lr STEP_LR: loss
    and grad_norm within LOSS_RTOL, every parameter's update within the
    UPDATE_* limits of the reference's, compared both ways through the
    converters, and the first moments (the clipped gradients) within
    GRAD_REL of each leaf's largest entry."""
    jm, jp, m, pp = train_pair(arch, block_kv=8)
    jb, pb = train_batch(m.cfg, B=4)
    jopt, opt = jadamw(lr=lambda s: STEP_LR), adamw(lr=lambda s: STEP_LR)
    jstep = jax.jit(jtrain_loop.make_train_step(jm, jopt,
                                                grad_accum=grad_accum))
    jnew, jstate, jmet = jstep(jp, jopt.init(jp), jb, jax.random.PRNGKey(0))
    step = make_train_step(m, opt, grad_accum=grad_accum)
    new, state, met = step(pp, opt.init(pp), pb)
    assert state.step == 1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=LOSS_RTOL)
    assert_same_update(pp, new, lm_params_from_reference(jnew, m.cfg))
    assert_same_update(jax.tree.leaves(jp), jax.tree.leaves(
        lm_params_to_reference(new, m.cfg)), jax.tree.leaves(jnew))
    for a, b in zip(tree_leaves(state.mu),
                    tree_leaves(lm_params_from_reference(jstate.mu, m.cfg))):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=GRAD_REL * np.abs(_np(b)).max())


def test_grad_accum_equals_the_mean_of_microbatch_gradients():
    """grad_accum=2 on a batch of 4 takes the same step as the gradient
    averaged by hand over its two halves."""
    _, _, m, pp = train_pair("qwen2_1_5b")
    _, pb = train_batch(m.cfg, B=4)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in pb.items()}
              for i in range(2)]
    parts = [port_loss_and_grads(m, pp, h) for h in halves]
    mean = tree_map(lambda a, b: (a.float() + b.float()) / 2, parts[0][1],
                    parts[1][1])
    opt = adamw()
    want, _, _ = opt.update(mean, opt.init(pp), pp)
    got, _, met = make_train_step(m, opt, grad_accum=2)(pp, opt.init(pp),
                                                        pb)
    assert float(met["loss"]) == pytest.approx(
        float(parts[0][0] + parts[1][0]) / 2, rel=1e-6)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-7)


def test_train_step_with_int8_compression_is_deterministic():
    """compress="int8": the same generator seed gives the same step; the
    loss is the uncompressed step's (compression acts on the gradients);
    a batch that does not split into grad_accum microbatches raises."""
    _, _, m, pp = train_pair("qwen2_1_5b")
    _, pb = train_batch(m.cfg, B=4)
    opt = adamw()
    step = make_train_step(m, opt, grad_accum=2, compress="int8")
    runs = [step(pp, opt.init(pp), pb, torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    plain = make_train_step(m, opt, grad_accum=2)(pp, opt.init(pp), pb)
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[0][1].mu), tree_leaves(runs[2][1].mu)))
    assert float(runs[0][2]["loss"]) == float(plain[2]["loss"])
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(m, opt, grad_accum=3)(pp, opt.init(pp), pb)
    with pytest.raises(ValueError, match="compress"):
        make_train_step(m, opt, compress="fp8")


def test_training_lowers_the_loss_on_synthetic_tokens():
    """A few steps of the reduced qwen2 on ``SyntheticTokens`` (the Zipf
    unigram is learnable) at a constant learning rate: the loss falls."""
    m = Model(get_config("qwen2_1_5b", reduced=True).replace(remat="full"))
    params = m.init(torch.Generator().manual_seed(0))
    opt = adamw(lr=lambda s: 3e-3)
    state = opt.init(params)
    step = make_train_step(m, opt, grad_accum=2)
    data = SyntheticTokens(m.cfg.vocab, 32, 8, seed=0, device="cpu")
    losses = []
    for i in range(6):
        params, state, met = step(params, state, data.batch(i))
        losses.append(float(met["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.3
    assert params["embed"]["tokens"].dtype == torch.bfloat16


# -- AdamW on a bf16 tree -----------------------------------------------------

def test_adamw_update_of_a_bf16_tree_matches_reference():
    """bf16 parameters (nested dicts and lists, as an LM's tree), float32
    moments, the update in float32 and the cast back: two updates at lr
    STEP_LR on weights of scale 1e-2, where each step moves an entry by
    about 160 bf16 ulps. The parameters equal the reference's to one bf16
    ulp, each step's update (new - old) / lr the reference's within
    2^-7 of the parameters' largest entry over lr (one ulp at that scale:
    5e-3), and the moments to float32 rounding."""
    rng = np.random.default_rng(0)

    def draw(scale):
        def leaf(*shape):
            return (scale * rng.standard_normal(shape)).astype(np.float32)
        return dict(embed=leaf(16, 8),
                    layers=[dict(w=leaf(8, 8), b=leaf(8)) for _ in range(2)])
    def jtree(t):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)

    def ptree(t):
        return tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), t)
    p_np = draw(1e-2)
    opt, jopt = adamw(lr=lambda s: STEP_LR), jadamw(lr=lambda s: STEP_LR)
    pp, jp = ptree(p_np), jtree(p_np)
    state, jstate = opt.init(pp), jopt.init(jp)
    for _ in range(2):
        g_np = draw(3.0)
        old = pp
        pp, state, gn = opt.update(ptree(g_np), state, pp)
        jp, jstate, jgn = jopt.update(jtree(g_np), jstate, jp)
        assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
        for o, a, b in zip(tree_leaves(old), tree_leaves(pp),
                           jax.tree.leaves(jp)):
            assert a.dtype == torch.bfloat16
            o, a, b = _np(o), _np(a), _np(b)
            np.testing.assert_allclose(a, b, rtol=2 ** -8, atol=0)
            got, want = (a - o) / STEP_LR, (b - o) / STEP_LR
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=2 ** -7 * max(np.abs(b).max(), np.abs(o).max())
                / STEP_LR)
            assert np.abs(want).mean() > 0.5
    for a, b in zip(tree_leaves(state.nu), jax.tree.leaves(jstate.nu)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


# -- gradient compression -----------------------------------------------------

def test_int8_roundtrip_error_bound():
    """The reference test's bound: max error at most one quantum (1.01x
    max|g| / 127), on a float32 and a bf16 leaf in a nested tree."""
    g = dict(w=torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32)), l=[torch.linspace(-3, 2, 300).to(
            torch.bfloat16)])
    out = compression.int8_roundtrip(g, torch.Generator().manual_seed(1))
    for a, b in zip(tree_leaves(out), tree_leaves(g)):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = float(b.float().abs().max()) / 127.0
        # bf16 leaves also round the dequantized value to bf16.
        extra = float(b.float().abs().max()) * 2 ** -8 if (
            b.dtype == torch.bfloat16) else 0.0
        assert float((a.float() - b.float()).abs().max()) <= \
            scale * 1.01 + extra


def test_int8_roundtrip_is_unbiased_and_deterministic():
    """The mean over 400 generators is the gradient within 5 standard
    errors of the rounding noise (at most one quantum each); one generator
    seed gives the same payload twice; the reference's roundtrip on the
    same leaf keeps the same bound."""
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        512).astype(np.float32))
    q = float(g.abs().max()) / 127.0
    outs = torch.stack([compression.int8_roundtrip(
        dict(w=g), torch.Generator().manual_seed(s))["w"]
        for s in range(400)])
    # Each entry's rounding error has standard deviation at most q / 2.
    assert float((outs.mean(0) - g).abs().max()) < 5 * 0.5 * q / np.sqrt(
        400)
    a = compression.compress_int8(g, torch.Generator().manual_seed(7))
    b = compression.compress_int8(g, torch.Generator().manual_seed(7))
    assert a[0].dtype == torch.int8 and torch.equal(a[0], b[0])
    assert float(a[1]) == pytest.approx(float(jnp.max(jnp.abs(
        jnp.asarray(g.numpy())))) / 127.0, rel=1e-7)
    ref = jcompression.int8_roundtrip(dict(w=jnp.asarray(g.numpy())),
                                      jax.random.PRNGKey(1))
    assert float(jnp.abs(ref["w"] - g.numpy()).max()) <= q * 1.01


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_error_feedback_matches_reference(frac):
    """Deterministic: on continuous draws (no ties at the threshold) the
    sent tensors and residuals equal the reference's, over two rounds of
    feedback, on a nested tree with a bf16 leaf."""
    rng = np.random.default_rng(3)
    rounds = [dict(a=rng.standard_normal((40, 25)).astype(np.float32),
                   b=[rng.standard_normal(300).astype(np.float32)])
              for _ in range(2)]
    res = jres = None
    for g in rounds:
        pg = dict(a=torch.from_numpy(g["a"]),
                  b=[torch.from_numpy(g["b"][0]).to(torch.bfloat16)])
        jg = dict(a=jnp.asarray(g["a"]),
                  b=[jnp.asarray(g["b"][0], jnp.bfloat16)])
        before = (np.zeros_like(g["a"]) if res is None else _np(res["a"]))
        sent, res = compression.topk_error_feedback(pg, res, frac)
        jsent, jres = jcompression.topk_error_feedback(jg, jres, frac)
        for a, b in zip(tree_leaves(sent) + tree_leaves(res),
                        jax.tree.leaves(jsent) + jax.tree.leaves(jres)):
            np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
        assert int((sent["a"] != 0).sum()) == max(int(1000 * frac), 1)
        # Nothing is lost: what is sent plus what is kept back is the
        # gradient plus what was kept back before.
        np.testing.assert_allclose(_np(sent["a"]) + _np(res["a"]),
                                   g["a"] + before, atol=1e-6)


# -- the synthetic token pipeline ---------------------------------------------

def test_pipeline_is_deterministic_resumable_and_shifted():
    """The reference test's properties: a step's batch is the same every
    time, resuming at a step gives that step's batch, consecutive steps
    differ, labels are the tokens shifted by one; extras ride along."""
    src = SyntheticTokens(vocab=128, seq_len=16, global_batch=4, seed=0,
                          device="cpu")
    b5a, b5b, b6 = src.batch(5), src.batch(5), src.batch(6)
    assert b5a["tokens"].shape == b5a["labels"].shape == (4, 16)
    assert b5a["tokens"].dtype == b5a["labels"].dtype == torch.int32
    assert torch.equal(b5a["tokens"], b5b["tokens"])
    assert not torch.equal(b5a["tokens"], b6["tokens"])
    assert torch.equal(b5a["tokens"][:, 1:], b5a["labels"][:, :-1])
    it = make_batch_iterator(128, 16, 4, seed=0, start_step=5,
                             extras=dict(frames="x"), device="cpu")
    first, second = next(it), next(it)
    assert torch.equal(first["labels"], b5a["labels"])
    assert torch.equal(second["tokens"], b6["tokens"])
    assert first["frames"] == "x"
    other = SyntheticTokens(128, 16, 4, seed=1, device="cpu").batch(5)
    assert not torch.equal(other["tokens"], b5a["tokens"])
    ref = JaxSyntheticTokens(128, 16, 4, 0)
    np.testing.assert_array_equal(src._unigram_logits(),
                                  ref._unigram_logits())


def test_pipeline_draws_the_zipf_unigram():
    """Rank frequencies of 2^18 draws match the Zipf(1.2) unigram: the
    top ranks within 5 standard errors, the ranks in order, and every
    token in range."""
    src = SyntheticTokens(vocab=1000, seq_len=1023, global_batch=256,
                          seed=3, device="cpu")
    toks = torch.cat([src.batch(0)["tokens"].reshape(-1),
                      src.batch(0)["labels"][:, -1]])
    n = toks.numel()
    assert 0 <= int(toks.min()) and int(toks.max()) < 1000
    freq = torch.bincount(toks, minlength=1000).double().numpy() / n
    p = np.exp(src._unigram_logits())
    se = np.sqrt(p * (1 - p) / n)
    np.testing.assert_array_less(np.abs(freq[:20] - p[:20]), 5 * se[:20])
    assert (np.diff(freq[:8]) < 0).all()


# -- the MoE auxiliary loss ---------------------------------------------------

@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (16, 4)])
def test_aux_load_balance_loss_matches_reference(E, k):
    rng = np.random.default_rng(E)
    logits = rng.standard_normal((64, E)).astype(np.float32)
    ids = np.argsort(-logits, axis=-1)[:, :k].astype(np.int32)
    ref = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(ids),
                                     E, k)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(ids), E, k)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    # Balanced routing gives the minimum, 1.
    flat = torch.zeros((E, E))
    ids = torch.arange(E)[:, None]
    assert float(moe.aux_load_balance_loss(flat, ids, E, 1)) == \
        pytest.approx(1.0)


# -- inputs and shapes --------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_1_5b", "llama_3_2_vision_11b",
                                  "seamless_m4t_large_v2",
                                  "recurrentgemma_2b"])
def test_make_inputs_matches_reference(arch):
    """Every ShapeSpec kind: the reference's (concrete) inputs, leaf for
    leaf in shape, zero, on the device asked for; the step shapes equal."""
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in
            SHAPES.items()} == {k: (s.seq_len, s.global_batch, s.kind)
                                for k, s in JAX_SHAPES.items()}
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(
        arch, reduced=True)
    jm, m = JaxModel(jcfg), Model(cfg)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("s", 24, 2, kind)
        got = m.make_inputs(shape, "cpu", enc_ctx=10)
        ref, _ = split_tree(jm.make_inputs(shape, concrete=True, enc_ctx=10))
        if kind == "decode":
            if cfg.family == "griffin":
                g, t = ref["cache"]
                n = cfg.n_layers // 3
                ref["cache"] = ([jax.tree.map(lambda a: a[i], g)
                                 for i in range(n)],
                                [jax.tree.map(lambda a: a[i], t)
                                 for i in range(cfg.n_layers % 3)])
            else:
                ref["cache"] = ref_cache_unstacked(cfg, ref["cache"])
        assert sorted(got) == sorted(ref)
        pl = jax.tree.leaves(got, is_leaf=lambda t: isinstance(
            t, torch.Tensor))
        rl = jax.tree.leaves(ref)
        assert len(pl) == len(rl) > 0
        for a, b in zip(pl, rl):
            assert tuple(a.shape) == tuple(b.shape)
            assert a.device.type == "cpu" and not a.any()


def test_qwen2_72b_still_raises_naming_the_sharding_slice():
    """qwen2_72b is ported; what still raises is its sharded step without
    a process group to shard over, and the production mesh on too few
    ranks, each naming what it needs."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import MeshShape
    m = Model(get_config("qwen2_72b", reduced=True))
    with pytest.raises(RuntimeError, match="process group"):
        make_train_step(m, adamw(), mesh=MeshShape(("data", "model"),
                                                   (2, 2)))
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()


# -- the flash and SSD wrappers' gradients ------------------------------------

FLASH_CASES = [
    # (B, Sq, Skv, Kh, G, D, Dv, causal, window, scale, block)
    (2, 20, 20, 2, 2, 16, 16, True, 0, None, 8),
    (1, 33, 33, 1, 3, 16, 16, True, 7, None, 16),
    (2, 9, 17, 2, 1, 16, 16, False, 0, None, 8),
    (2, 17, 9, 1, 2, 16, 16, False, 0, 0.3, 4),
    (1, 24, 24, 2, 1, 24, 16, True, 0, np.float64(1 / np.sqrt(24)), 8),
]


def _flash_inputs(B, Sq, Skv, Kh, G, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, Kh, G, D), (B, Skv, Kh, D), (B, Skv, Kh, Dv))]


def _grads(fn, inputs, w):
    live = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*live)
    return [out.detach(), *torch.autograd.grad((out * w).sum(), live)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_wrapper_gradients_equal_the_plain_versions(case):
    """On the CPU ``ops.flash_attention`` is the plain version, and its
    gradient is autograd's through it. The card's backward is the gradient
    of the blocked plain version (``ref.flash_attention_blocked``):
    equal to it here, in output and gradients. ``_Flash`` itself, with
    the plain version standing in for the kernel, carries that backward;
    and so does the kernel layout's wrapper."""
    B, Sq, Skv, Kh, G, D, Dv, causal, window, scale, block = case
    inputs = _flash_inputs(B, Sq, Skv, Kh, G, D, Dv)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, Sq, Kh, G, Dv)).astype(np.float32))
    kw = dict(causal=causal, window=window, scale=scale)
    want = _grads(lambda q, k, v: fref.flash_attention_ref(q, k, v, **kw),
                  inputs, w)
    blocked = functools.partial(fref.flash_attention_blocked, block_kv=block,
                                **kw)
    for fn in (lambda q, k, v: fops.flash_attention(q, k, v, **kw), blocked,
               lambda q, k, v: fops._Flash.apply(
                   fref.flash_attention_ref, functools.partial(
                       fref.flash_attention_blocked, block_kv=block), kw, q,
                   k, v)):
        for a, b in zip(_grads(fn, inputs, w), want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                       rtol=1e-5)
    # The kernel layout: heads first, head h attending kv head h // G.
    q, k, v = inputs
    bh = [q.permute(0, 2, 3, 1, 4).reshape(-1, Sq, D),
          k.permute(0, 2, 1, 3).reshape(-1, Skv, D),
          v.permute(0, 2, 1, 3).reshape(-1, Skv, Dv)]
    wb = w.permute(0, 2, 3, 1, 4).reshape(-1, Sq, Dv)
    kwb = dict(kw, group=G)
    want = _grads(lambda *t: fops.flash_attention_bh(*t, **kwb), bh, wb)
    got = _grads(lambda *t: fops._Flash.apply(
        fref.flash_attention_bh_ref, functools.partial(
            fref.flash_attention_bh_blocked, block_kv=block), kwb, *t),
        bh, wb)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=1e-5)


def test_flash_backward_is_not_taken_while_serving():
    """Under no_grad (serving) ``_Flash`` saves nothing and its output has
    no grad_fn; with grad it saves q, k and v."""
    q, k, v = _flash_inputs(1, 8, 8, 1, 2, 16, 16)
    kernel = fref.flash_attention_ref
    plain = fref.flash_attention_blocked
    with torch.no_grad():
        o = fops._Flash.apply(kernel, plain, {}, q.requires_grad_(), k, v)
    assert o.grad_fn is None
    o = fops._Flash.apply(kernel, plain, {}, q, k, v)
    assert len(o.grad_fn.saved_tensors) == 3


@pytest.mark.parametrize("S,chunk,G", [(20, 8, 1), (64, 16, 2), (7, 8, 1)])
def test_ssd_wrapper_gradients_equal_the_plain_version(monkeypatch, S, chunk,
                                                       G):
    """On the CPU ``ops.ssd_scan`` is the plain chunked version. Its
    ``_Scan`` (the card's path), with the plain version standing in for
    the kernel, returns autograd's gradients through it, for y and the
    final state together."""
    rng = np.random.default_rng(S)
    b, H, P, N = 2, 4, 8, 6
    x = rng.standard_normal((b, S, H, P))
    dt = np.exp(rng.uniform(np.log(1e-2), np.log(0.5), (b, S, H)))
    A = -rng.uniform(0.5, 4.0, H)
    Bm, Cm = (rng.standard_normal((b, S, G, N)) for _ in range(2))
    inputs = [torch.from_numpy(t.astype(np.float32))
              for t in (x, dt, A, Bm, Cm)]
    wy = torch.from_numpy(rng.standard_normal((b, S, H, P)).astype(
        np.float32))
    ws = torch.from_numpy(rng.standard_normal((b, H, P, N)).astype(
        np.float32))

    def grads(fn):
        live = [t.clone().requires_grad_(True) for t in inputs]
        y, s = fn(*live)
        loss = (y * wy).sum() + (s * ws).sum()
        return [y.detach(), s.detach(), *torch.autograd.grad(loss, live)]
    want = grads(lambda *t: ssd_ref(*t, chunk=min(chunk, S)))
    monkeypatch.setattr(sbinding, "ssd_scan_cuda",
                        lambda *t, chunk: ssd_ref(*t, chunk=min(chunk, S)))
    for fn in (lambda *t: sops.ssd_scan(*t, chunk=chunk),
               lambda *t: sops._Scan.apply(chunk, *t)):
        for a, b in zip(grads(fn), want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-5)
