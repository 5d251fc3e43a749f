"""MLA, MoE and leading dense layers in the port's LM path — the
``minicpm3_4b`` (MLA), ``dbrx_132b`` (MoE) and ``deepseek_v2_236b`` (MLA,
MoE with a shared expert, one leading dense layer) reduced configs —
against the JAX package on the same numpy-seeded inputs, with the
reference's init carried across by ``convert.lm_params_from_reference``.

Also the pieces one by one: ``moe.apply`` (with a capacity factor that
drops assignments), ``mla.apply`` in prefill and in absorbed decode, the
flash wrapper on MLA's unequal head dims (on the CPU, through its plain
version; which launch serves them on the card), and the float32 promotion
of a numpy scale.

The helpers at the top serve ``test_torch_lm_cross.py`` too: a reference
tree and its conversion for any arch (the vision family's cross-layer
gates drawn live), the batch of prompts and frames or patches, and the
reference's built cache unstacked into the port's layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import attention as jattention
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.common import split_tree
from repro.runtime.serve_loop import Server as JaxServer
from repro.runtime.serve_loop import _splice as jax_splice
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention, mla, moe, transformer
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import Server, _splice
# Tolerances and the near-tie rule of test_torch_lm.py: float32 1e-4;
# bf16 atol 0.15 / rtol 0.1, argmax allowed to differ within 0.15.
from test_torch_lm import BF16_TOL, F32_TOL, _near_tie_ok, _tokens

ARCHS = ("minicpm3_4b", "dbrx_132b", "deepseek_v2_236b")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _port_tree(tree):
    """A reference (sub)tree of arrays as tensors, bf16 leaves exactly."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, np.float32))
    return t.to(torch.bfloat16) if arr.dtype.name == "bfloat16" else t


def live_gates(jp, cfg, rng):
    """The reference's vision tree with every cross layer's gates drawn by
    ``transformer.draw_live_gates`` (stacked per group)."""
    n = cfg.n_layers // cfg.cross_every
    draws = [transformer.draw_live_gates(rng) for _ in range(n)]
    cross = dict(jp["groups"]["cross"])
    for k in draws[0]:
        cross[k] = jnp.asarray(np.stack([d[k] for d in draws]),
                               cross[k].dtype)
    return dict(jp, groups=dict(jp["groups"], cross=cross))


def pair(arch, dtype, seed=0, live=True):
    """(jax model, jax params, port model, port params) at the reduced
    config with the reference's init on both sides; the vision family's
    gates drawn live unless ``live`` is False."""
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=dtype,
                                                      param_dtype=dtype)
    cfg = get_config(arch, reduced=True).replace(dtype=dtype,
                                                 param_dtype=dtype)
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    if cfg.family == "vision" and live:
        jp = live_gates(jp, cfg, np.random.default_rng(seed + 5))
    return jm, jp, Model(cfg), lm_params_from_reference(jp, cfg)


def inputs(cfg, B=2, S=20, seed=1, src_len=12):
    """(reference batch, port batch): prompts, and frames [B, src_len, d]
    (encdec) or patches [B, n_img_tokens, d] (vision) as float32 numpy
    from the seed."""
    toks = _tokens(cfg, B, S, seed)
    rng = np.random.default_rng(seed + 100)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, src_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vision":
        extra["patches"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    jb = dict(tokens=jnp.asarray(toks),
              **{k: jnp.asarray(v) for k, v in extra.items()})
    pb = dict(tokens=torch.from_numpy(toks).long(),
              **{k: torch.from_numpy(v) for k, v in extra.items()})
    return toks, extra, jb, pb


def ref_cache_unstacked(cfg, tree):
    """The reference's cache (stacked on leading axes) in the port's
    layout: (dense, rest) lists for the decoder family, a list per group
    of dict(img, selfs=[...]) for vision, a list per layer for encdec."""
    def at(t, i):
        return jax.tree.map(lambda a: a[i], t)

    def unstack(t, n):
        return [at(t, i) for i in range(n)]
    if cfg.family == "vision":
        per = cfg.cross_every
        return [dict(img=at(tree["img"], g),
                     selfs=unstack(at(tree["selfs"], g), per - 1))
                for g in range(cfg.n_layers // per)]
    if cfg.family == "encdec":
        return unstack(tree, cfg.n_layers)
    dense, rest = tree
    return ((unstack(dense, cfg.first_dense) if cfg.first_dense else None),
            unstack(rest, cfg.n_layers - cfg.first_dense))


def assert_trees_close(port, ref, tol):
    """Leaf by leaf, in the order both flatten to (dict keys sorted, None
    subtrees empty)."""
    port_leaves = jax.tree.leaves(
        port, is_leaf=lambda t: isinstance(t, torch.Tensor))
    ref_leaves = jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def reference_cache_lengths(cfg, extra):
    """The cross caches' lengths as the reference's ``Server.generate``
    sizes them (``src_len`` from the frames, ``n_img`` from the config)."""
    return dict(src_len=extra["frames"].shape[1]
                if cfg.family == "encdec" else 0, n_img=cfg.n_img_tokens)


def reference_run(jm, jp, cfg, jb, extra, max_new):
    """The reference's serving run through its ``Server``'s jitted steps
    (compiled once each, then reused): (greedy tokens, prefill logits,
    prefill cache, [decode logits teacher-forced along the tokens],
    final cache)."""
    server = JaxServer(jm, jp)
    tokens = server.generate(jb, max_new=max_new)
    B, S = jb["tokens"].shape
    logits, built = server.prefill_step(jp, jb)
    cache, _ = split_tree(jm.init_cache(B, S + max_new,
                                        **reference_cache_lengths(jm.cfg,
                                                                  extra)))
    cache = jax_splice(cache, built, S)
    # The decode step donates its cache, which may hold prefill leaves
    # (the static cross K/V) as they are: keep host copies.
    built = jax.tree.map(np.asarray, built)
    steps = []
    for t in range(max_new - 1):
        _, a, cache = server.decode_step(jp, cache,
                                         jnp.asarray(tokens[:, t:t + 1]),
                                         S + t)
        steps.append(a)
    return tokens, logits, built, steps, cache


def port_steps(m, pp, pb, extra, ref_tokens, max_new):
    """The port's prefill, then decode teacher-forced along the
    reference's tokens: (prefill logits, prefill cache, [decode logits],
    final cache)."""
    B, S = pb["tokens"].shape
    pl, pbuilt = m.prefill(pp, pb)
    pcache = _splice(m.init_cache(B, S + max_new, "cpu",
                                  **m.cache_lengths(pb)), pbuilt)
    steps = []
    for t in range(max_new - 1):
        pa, pcache = m.decode(pp, pcache, torch.from_numpy(
            ref_tokens[:, t:t + 1]).long(), S + t)
        steps.append(pa)
    return pl, pbuilt, steps, pcache


def check_f32(arch, seed=0):
    """Prefill logits and caches, every decode step along the reference's
    tokens, and ``Server.generate``'s tokens, float32: returns the
    reference's prefill logits."""
    jm, jp, m, pp = pair(arch, "float32", seed)
    cfg = m.cfg
    toks, extra, jb, pb = inputs(cfg)
    max_new = 5
    ref_tokens, jl, jbuilt, jsteps, jcache = reference_run(
        jm, jp, cfg, jb, extra, max_new)
    pl, pbuilt, psteps, pcache = port_steps(m, pp, pb, extra, ref_tokens,
                                            max_new)
    np.testing.assert_allclose(_np(pl), _np(jl), **F32_TOL)
    assert_trees_close(pbuilt, ref_cache_unstacked(cfg, jbuilt), F32_TOL)
    for pa, ja in zip(psteps, jsteps):
        np.testing.assert_allclose(_np(pa), _np(ja), **F32_TOL)
    assert_trees_close(pcache, ref_cache_unstacked(cfg, jcache), F32_TOL)
    port_tokens = Server(m, pp, device="cpu").generate(dict(tokens=toks,
                                                            **extra),
                                                       max_new=max_new)
    assert port_tokens.dtype == np.int32
    np.testing.assert_array_equal(port_tokens, ref_tokens)
    return _np(jl)


def check_bf16(arch, seed=0):
    """bf16 serving: teacher-forced decode logits within the bf16
    tolerance and near-tie rule at every step; the generated streams equal
    up to the first near-tie."""
    jm, jp, m, pp = pair(arch, "bfloat16", seed)
    cfg = m.cfg
    toks, extra, jb, pb = inputs(cfg)
    B = toks.shape[0]
    max_new = 5
    ref_tokens, jl, _, jsteps, _ = reference_run(jm, jp, cfg, jb, extra,
                                                 max_new)
    pl, _, psteps, _ = port_steps(m, pp, pb, extra, ref_tokens, max_new)
    port_tokens = Server(m, pp, device="cpu").generate(dict(tokens=toks,
                                                            **extra),
                                                       max_new=max_new)
    steps = [(_np(pl), _np(jl))] + [(_np(a), _np(b))
                                    for a, b in zip(psteps, jsteps)]
    live = np.ones(B, bool)
    for t, (port, ref) in enumerate(steps):
        np.testing.assert_allclose(port, ref, **BF16_TOL)
        ok, same = _near_tie_ok(port, ref)
        assert ok, f"step {t}: argmax differs beyond a near-tie"
        same_tok = port_tokens[:, t] == ref_tokens[:, t]
        assert (same_tok | ~live | ~same).all()
        live &= same_tok


def check_decode_matches_forward(arch):
    """The port's own cache consistency, float32: teacher-forced decode
    from a prefilled cache reproduces the one-shot forward's logits. MoE
    compares dropless, as the reference's test does: capacity can drop
    assignments in the one-shot forward, never in one-token decode."""
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 param_dtype="float32")
    if cfg.n_experts:
        cfg = cfg.replace(moe_capacity_factor=8.0)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    if cfg.family == "vision":
        rng = np.random.default_rng(9)
        for g in params["groups"]:
            g["cross"].update({k: torch.from_numpy(v) for k, v in
                               transformer.draw_live_gates(rng).items()})
    B, S, extra_steps = 2, 16, 4
    toks, extra, _, pb = inputs(cfg, B, S + extra_steps, seed=3)
    full, _ = transformer.apply(cfg, params, pb, "train")
    prompt = dict(pb, tokens=pb["tokens"][:, :S])
    _, built = m.prefill(params, prompt)
    cache = _splice(m.init_cache(B, S + extra_steps, "cpu",
                                 **m.cache_lengths(pb)), built)
    for t in range(S, S + extra_steps):
        logits, cache = m.decode(params, cache, pb["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **F32_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,E,k,cf,n_shared", [
    ("float32", 4, 2, 1.25, 0),        # dbrx-like
    ("float32", 8, 2, 0.5, 0),         # capacity short: assignments drop
    ("float32", 8, 2, 1.25, 1),        # deepseek-like shared expert
    ("bfloat16", 8, 3, 0.75, 1),       # drops, bf16
])
def test_moe_matches_reference(dtype, E, k, cf, n_shared):
    B, S, d, f = 2, 24, 16, 12
    jdt = jnp.dtype(dtype)
    jp, _ = split_tree(jmoe.init(jax.random.PRNGKey(3), d, f, E,
                                 n_shared=n_shared, dtype=jdt))
    x = np.random.default_rng(4).standard_normal((B, S, d)).astype(
        np.float32)
    ref = jmoe.apply(jnp.asarray(x, jdt), jp, top_k=k, n_experts=E,
                     capacity_factor=cf)
    pp = _port_tree(jp)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out = moe.apply(xt, pp, top_k=k, n_experts=E, capacity_factor=cf)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    # Assignments beyond an expert's C slots in a row are dropped.
    C = moe.capacity(S, k, E, cf)
    _, ids = moe.route(xt, pp["router"], k)
    load = torch.stack([torch.bincount(r, minlength=E)
                        for r in ids.reshape(B, -1)])
    dropped = int((load - C).clamp(min=0).sum())
    if cf < 1.0:
        assert dropped > 0, (C, load)


def test_moe_router_takes_the_reference_top_k():
    """Ties and order: the stable sort's top k equal jax.lax.top_k's,
    also on exactly tied probabilities (the lower index first)."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    gate, ids = jax.lax.top_k(jnp.asarray(probs), 2)
    # route() takes the router's logits: log-probabilities give the same
    # softmax.
    g, i = moe.route(torch.from_numpy(np.log(probs)), torch.eye(4), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ids))
    np.testing.assert_allclose(g.numpy(), np.asarray(
        gate / gate.sum(-1, keepdims=True)), atol=1e-6)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_DIMS = dict(n_heads=4, kv_lora=16, d_nope=16, d_rope=8, d_v=16)


@pytest.mark.parametrize("q_lora", [32, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_decode_match_reference(dtype, q_lora):
    """Prefill output and latents, then one absorbed decode step at
    position S from the prefilled cache (its row written in place)."""
    B, S, d, Smax = 2, 18, 64, 24
    jdt = jnp.dtype(dtype)
    jp, _ = split_tree(jmla.init(jax.random.PRNGKey(6), d, q_lora=q_lora,
                                 dtype=jdt, **MLA_DIMS))
    pp = _port_tree(jp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S + 1, d)).astype(np.float32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    pos = np.arange(S)
    kw = dict(q_lora=q_lora, **MLA_DIMS)
    ref, _ = jmla.apply(jnp.asarray(x[:, :S], jdt), jp,
                        positions=jnp.asarray(pos), **kw)
    ref_cache = jmla._latent(jnp.asarray(x[:, :S], jdt), jp,
                             MLA_DIMS["kv_lora"], jnp.asarray(pos))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out, cache = mla.apply(xt[:, :S], pp, positions=torch.from_numpy(pos),
                           **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    for a, b in zip(cache, ref_cache):
        np.testing.assert_allclose(_np(a), _np(b), **tol)

    # Decode at position S over a [B, Smax] cache holding the prefill.
    jc = tuple(jnp.zeros((B, Smax, a.shape[-1]), jdt).at[:, :S].set(a)
               for a in ref_cache)
    ref_d, ref_dc = jmla.apply(jnp.asarray(x[:, S:], jdt), jp,
                               positions=jnp.asarray([S]), cache=jc,
                               decode_pos=S, **kw)
    pc = tuple(torch.zeros((B, Smax, a.shape[-1]), dtype=xt.dtype)
               for a in cache)
    for c, a in zip(pc, cache):
        c[:, :S] = a
    out_d, pc2 = mla.apply(xt[:, S:], pp, positions=torch.tensor([S]),
                           cache=pc, decode_pos=S, **kw)
    assert pc2[0] is pc[0]                        # written in place
    np.testing.assert_allclose(_np(out_d), _np(ref_d), **tol)
    for a, b in zip(pc2, ref_dc):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("scale", [1.0 / np.sqrt(24), 0.3])
def test_scale_promotion_matches_reference_bf16(scale):
    """A numpy float64 scale promotes bf16 q to float32 before the product
    (the reference's MLA scale); a Python float scales q in bf16. Both
    against the reference's blocked attention at bf16, to the bit where
    the two promotions differ by a bf16 rounding."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 16, 2, 2, 24)).astype(np.float32) * 3
    k = rng.standard_normal((1, 16, 2, 24)).astype(np.float32)
    v = rng.standard_normal((1, 16, 2, 16)).astype(np.float32)
    pos = np.arange(16)
    ref = jattention.blocked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(pos), jnp.asarray(pos), softmax_scale=scale)
    port = attention.blocked_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(pos), torch.from_numpy(pos), softmax_scale=scale)
    np.testing.assert_allclose(_np(port), _np(ref), atol=8e-3, rtol=8e-3)
    qb = torch.from_numpy(q).bfloat16()
    ref_q = np.asarray(jnp.asarray(q, jnp.bfloat16) * scale)
    assert ref_q.dtype == (np.float32 if isinstance(scale, np.floating)
                           else jnp.bfloat16)
    np.testing.assert_array_equal(
        _np(attention._scaled_f32(qb, scale)), ref_q.astype(np.float32))


@pytest.mark.parametrize("D,Dv,G", [(96, 64, 1), (192, 128, 1), (96, 64, 2)])
def test_padded_flash_entry_matches_reference(D, Dv, G):
    """MLA's unequal head dims through the flash wrapper on CPU tensors
    (the plain version, unpadded) at the scale of D_qk, given or by
    default — the reference's blocked attention with MLA's numpy scale;
    and the head dim the card's float32 calls are padded to (128 or 256:
    the scalar kernel takes one head dim)."""
    assert fops.padded_dim(D, Dv) == (128 if D <= 128 else 256)
    rng = np.random.default_rng(D)
    B, S, Kh = 2, 40, 3
    q = rng.standard_normal((B, S, Kh, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Kh, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Kh, Dv)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    pos = np.arange(S)
    ref = jattention.blocked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos),
        jnp.asarray(pos), softmax_scale=scale, block_kv=16)
    for given in (scale, None):         # None: 1/sqrt(D) of the unpadded q
        out = fops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True, scale=given)
        assert out.shape == (B, S, Kh, G, Dv)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    with pytest.raises(ValueError, match="above 256"):
        fops.padded_dim(320, 64)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_236b"])
def test_mla_prefill_takes_its_own_wgmma_instantiation(arch, reduced):
    """The launch that serves an MLA prefill's attention on the card: in
    bf16 at the published configs the wgmma kernel at (D_qk, D_v) itself,
    96/64 and 192/128, unpadded; in float32 the scalar kernel at the
    padded head dim; the reduced configs' 24/16, which has no
    instantiation, padded to the wgmma kernel's D 64."""
    cfg = get_config(arch, reduced=reduced)
    D, Dv = cfg.d_nope + cfg.d_rope, cfg.d_v
    if reduced:
        assert fops.kernel_call(torch.bfloat16, D, Dv) == ("wgmma", 64, 64)
        return
    assert (D, Dv) == {"minicpm3_4b": (96, 64),
                       "deepseek_v2_236b": (192, 128)}[arch]
    assert fops.kernel_call(torch.bfloat16, D, Dv) == ("wgmma", D, Dv)
    Dp = fops.padded_dim(D, Dv)
    assert fops.kernel_call(torch.float32, D, Dv) == ("scalar", Dp, Dp)


# ---------------------------------------------------------------------------
# Per architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_reference_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_bf16(arch):
    check_bf16(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    check_decode_matches_forward(arch)


def test_deepseek_tree_and_cache_hold_the_dense_layer():
    """first_dense: the leading layer is a dense MLP of dense_d_ff under
    MLA, unstacked by convert; the cache is (dense, rest)."""
    jm, jp, m, pp = pair("deepseek_v2_236b", "float32")
    cfg = m.cfg
    assert len(pp["dense_layers"]) == cfg.first_dense == 1
    assert len(pp["layers"]) == cfg.n_layers - 1
    assert pp["dense_layers"][0]["mlp"]["wi"].shape == (cfg.d_model,
                                                        cfg.dense_d_ff)
    assert set(pp["layers"][0]["mlp"]) == {"router", "wi", "wg", "wo",
                                           "shared"}
    np.testing.assert_array_equal(
        pp["layers"][1]["mlp"]["wi"].numpy(),
        np.asarray(jp["layers"]["mlp"]["wi"][1]))
    dense, rest = m.init_cache(2, 10, "cpu")
    assert len(dense) == 1 and len(rest) == cfg.n_layers - 1
    assert [tuple(t.shape) for t in dense[0]] == [(2, 10, cfg.kv_lora),
                                                  (2, 10, cfg.d_rope)]
