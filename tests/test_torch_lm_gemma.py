"""The gemma family of the port's LM path — ``gemma3`` (5:1 local:global
attention, dual RoPE base) and ``griffin`` (RG-LRU + local MQA, GeGLU) with
gemma-style ``embed_scale`` — against the JAX package on the same
numpy-seeded inputs and parameters.

The reference's RG-LRU init zeroes the conv, so the recurrence would carry
exact zeros; every RG-LRU test here draws the block's conv, gate biases and
lam with ``models.rglru.draw_live_block`` (the same numbers on both sides)
and asserts a nonzero recurrence. On the CPU the port's recurrence is the
plain sequential loop; the reference's is an associative scan: both
float32, held at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import common as jcommon
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro.models.common import split_tree
from repro.runtime.serve_loop import Server as JaxServer
from repro.runtime.serve_loop import _splice as jax_splice
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import common, rglru, transformer
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import Server, _splice
# F32_TOL: float32 on both sides, matmuls in other orders and the
# associative scan against the sequential loop; BF16_TOL: the reference's
# test_decode_matches_forward tolerance. _pair: the reduced config on both
# sides, the reference's init with live RG-LRU draws.
from test_torch_lm import BF16_TOL, F32_TOL, _pair

GEMMA = ("gemma3_4b", "recurrentgemma_2b")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _live_block_params(W, d, dtype, seed):
    """One RG-LRU block: the reference's init, then live draws; (ref tree,
    port tree) holding the same numbers."""
    cfg = get_config("recurrentgemma_2b", reduced=True).replace(lru_width=W)
    jp, _ = split_tree(jrglru.block_init(jax.random.PRNGKey(seed), d,
                                         lru_width=W, dtype=dtype))
    live = rglru.draw_live_block(np.random.default_rng(seed), cfg)
    jp = {k: (jnp.asarray(live[k], v.dtype) if k in live else v)
          for k, v in jp.items()}
    return jp, {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}


def test_geglu_mlp_matches_reference():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    mlp = {k: rng.standard_normal(s).astype(np.float32) / 3 for k, s in
           (("wi", (8, 12)), ("wg", (8, 12)), ("wo", (12, 8)))}
    for gate in ("gelu", "silu"):
        port = common.mlp_apply(torch.from_numpy(h), {
            k: torch.from_numpy(v) for k, v in mlp.items()}, gate=gate)
        ref = jcommon.mlp_apply(jnp.asarray(h), {
            k: jnp.asarray(v) for k, v in mlp.items()}, gate=gate)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_block_matches_reference(mode, dtype):
    """The block in each mode, live draws, against the reference's
    ``block_apply``; in bf16 the gate weights are bf16 and the gate math
    float32 (the reference casts every gate weight and bias). Decode runs
    one step from a prefilled cache. The recurrence carries signal."""
    B, S, W, d = 2, 24, 16, 12
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jp, p = _live_block_params(W, d, jdt, seed=3)
    x = np.random.default_rng(4).standard_normal((B, S + 1, d)).astype(
        np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    if mode == "decode":
        _, jc = jrglru.block_apply(xj[:, :S], jp, mode="prefill")
        _, pc = rglru.block_apply(xt[:, :S], p, mode="prefill")
        ref, jc = jrglru.block_apply(xj[:, S:], jp, mode="decode", cache=jc)
        out, pc = rglru.block_apply(xt[:, S:], p, mode="decode", cache=pc)
    else:
        ref, jc = jrglru.block_apply(xj, jp, mode=mode)
        out, pc = rglru.block_apply(xt, p, mode=mode)
    assert out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    if mode == "train":
        assert jc is None and pc is None
    else:
        assert pc["conv"].dtype == pc["state"].dtype == tdt
        for k in ("conv", "state"):
            np.testing.assert_allclose(_np(pc[k]), _np(jc[k]), **tol)
        assert float(pc["state"].float().abs().max()) > 1e-3


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(with_h0):
    """``rglru_scan`` with and without a carried state (folded in as a
    virtual step 0 in both): y in x's dtype, h_final float32."""
    B, S, W = 3, 40, 16
    jp, p = _live_block_params(W, W, jnp.float32, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    ry, rh = jrglru.rglru_scan(jnp.asarray(x), jp,
                               None if h0 is None else jnp.asarray(h0))
    y, h = rglru.rglru_scan(torch.from_numpy(x), p,
                            None if h0 is None else torch.from_numpy(h0))
    assert h.dtype == torch.float32 and h.shape == (B, W)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **F32_TOL)
    assert float(y.abs().max()) > 1e-3


def test_rglru_step_matches_reference():
    """One O(1) decode step from a nonzero state, in bf16 (the state in
    the cache's dtype, the gate math in float32)."""
    B, W = 2, 16
    jp, p = _live_block_params(W, W, jnp.bfloat16, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 1, W)).astype(np.float32)
    h = rng.standard_normal((B, W)).astype(np.float32)
    ry, rh = jrglru.rglru_step(jnp.asarray(x, jnp.bfloat16), jp,
                               jnp.asarray(h, jnp.bfloat16))
    y, hn = rglru.rglru_step(torch.from_numpy(x).bfloat16(), p,
                             torch.from_numpy(h).bfloat16())
    assert y.dtype == hn.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(ry), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(hn), _np(rh), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d_model", [64, 80, 2048, 2304, 2560, 3072, 3584])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_rounds_as_the_reference(d_model, dtype):
    """sqrt(d_model) in the compute dtype, as ``np.sqrt(d).astype(dtype)``
    rounds it: 50.5 in bf16 at d 2560."""
    scale = transformer.embed_scale(d_model, getattr(torch, dtype))
    ref = np.sqrt(d_model).astype(jnp.dtype(dtype))
    assert scale.dtype == getattr(torch, dtype) and scale.dim() == 0
    assert float(scale) == float(ref)
    if dtype == "bfloat16" and d_model == 2560:
        assert float(scale) == 50.5


def test_embed_scale_in_the_forward(monkeypatch):
    """A gemma3 stack in bf16 at d_model 80 (sqrt 8.944 -> 8.9375 in bf16):
    the embeddings the first layer sees are the reference's, bit for bit."""
    cfg = get_config("gemma3_4b", reduced=True).replace(d_model=80)
    jcfg = jax_get_config("gemma3_4b", reduced=True).replace(d_model=80)
    jp, _ = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    pp = lm_params_from_reference(jp, cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 6))
    ref = jcommon.embed_tokens(jnp.asarray(toks), jp["embed"],
                               jnp.bfloat16) * np.sqrt(80).astype(
                                   jnp.bfloat16)
    seen = []

    def first_layer(cfg_, p, x, *args, **kw):
        seen.append(x)
        raise StopIteration
    monkeypatch.setattr(transformer, "decoder_layer_apply", first_layer)
    with pytest.raises(StopIteration):
        transformer.apply(cfg, pp, dict(tokens=torch.from_numpy(toks)),
                          "train")
    assert seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(seen[0]), _np(ref))


def test_gemma3_layer_pattern_and_rope_bases():
    """Every 6th layer global (BIG_WINDOW, RoPE base 1e6), the rest local
    (window 1024, base 1e4), as the reference's flags and
    ``_gemma3_layer_args`` give them; at full and reduced size."""
    for reduced in (False, True):
        cfg = get_config("gemma3_4b", reduced)
        jcfg = jax_get_config("gemma3_4b", reduced)
        flags = (np.arange(cfg.n_layers) % jcfg.attn_every
                 == jcfg.attn_every - 1)
        for i, flag in enumerate(flags):
            kind, window, theta = transformer.attention_args(cfg, i)
            jwin, jtheta = jtransformer._gemma3_layer_args(
                jcfg, jnp.float32(flag))
            assert (kind, window, theta) == ("sliding", int(jwin),
                                             float(jtheta))
        globals_ = [i for i in range(cfg.n_layers)
                    if transformer.attention_args(cfg, i)[1]
                    == transformer.BIG_WINDOW]
        assert globals_ == list(range(5, cfg.n_layers, 6))
    assert transformer.BIG_WINDOW == jtransformer.BIG_WINDOW


@pytest.fixture
def recurrences(monkeypatch):
    """Records max |y| of every RG-LRU scan the port's model runs."""
    seen = []
    plain = rglru.rglru_scan

    def record(*args, **kw):
        y, h = plain(*args, **kw)
        seen.append(float(y.float().abs().max()))
        return y, h
    monkeypatch.setattr(rglru, "rglru_scan", record)
    return seen


@pytest.mark.parametrize("arch", GEMMA)
def test_decode_crosses_the_window(arch, recurrences):
    """Reduced config (window 8), float32: a prompt of 20 and 8 new tokens
    cross the window in prefill and again in decode. Prefill logits, every
    teacher-forced decode step and ``Server.generate``'s tokens equal the
    reference's."""
    _, jm, jp, cfg, m, pp = _pair(arch, "float32", seed=1)
    assert cfg.window == 8
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 20)).astype(
        np.int32)
    B, S = toks.shape
    max_new = 8
    jl, jbuilt = jm.prefill(jp, dict(tokens=jnp.asarray(toks)))
    pl, pbuilt = m.prefill(pp, dict(tokens=torch.from_numpy(toks).long()))
    np.testing.assert_allclose(_np(pl), _np(jl), **F32_TOL)
    if cfg.family == "griffin":
        assert len(recurrences) == 2 * (cfg.n_layers // 3) + \
            cfg.n_layers % 3
        assert min(recurrences) > 1e-3
    ref_tokens = JaxServer(jm, jp).generate(dict(tokens=jnp.asarray(toks)),
                                            max_new=max_new)
    port_tokens = Server(m, pp, device="cpu").generate(dict(tokens=toks),
                                                       max_new=max_new)
    np.testing.assert_array_equal(port_tokens, ref_tokens)
    jcache, _ = split_tree(jm.init_cache(B, S + max_new))
    jcache = jax_splice(jcache, jbuilt, S)
    pcache = _splice(m.init_cache(B, S + max_new, "cpu"), pbuilt)
    for t in range(max_new - 1):
        tok = ref_tokens[:, t:t + 1]
        ja, jcache = jm.decode(jp, jcache, jnp.asarray(tok), S + t)
        pa, pcache = m.decode(pp, pcache, torch.from_numpy(tok).long(),
                              S + t)
        np.testing.assert_allclose(_np(pa), _np(ja), **F32_TOL)


def test_convert_unstacks_griffin_groups_and_tail():
    """``groups`` (dicts of rec1, rec2, attn stacked on a group axis) and
    ``tail`` (stacked recurrent layers) become lists; bf16 leaves stay
    bf16 and exact, lam stays float32; the tree is the port's own init's
    tree, shape for shape."""
    _, jm, jp, cfg, m, pp = _pair("recurrentgemma_2b", "bfloat16")
    n_groups, rem = divmod(cfg.n_layers, 3)
    assert (len(pp["groups"]), len(pp["tail"])) == (n_groups, rem) == (1, 2)
    assert set(pp) == {"embed", "final_norm", "groups", "tail"}
    mixer = pp["tail"][1]["mixer"]
    assert mixer["in_x"].dtype == torch.bfloat16
    assert mixer["lam"].dtype == torch.float32
    np.testing.assert_array_equal(
        _np(mixer["lam"]), np.asarray(jp["tail"]["mixer"]["lam"][1]))
    np.testing.assert_array_equal(
        _np(pp["groups"][0]["attn"]["attn"]["wq"]),
        _np(jp["groups"]["attn"]["attn"]["wq"][0]))
    np.testing.assert_array_equal(
        _np(pp["groups"][0]["rec2"]["mlp"]["wo"]),
        _np(jp["groups"]["rec2"]["mlp"]["wo"][0]))
    own = m.init(torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert shapes(own) == shapes(pp)


def test_griffin_cache_layout_matches_reference():
    """``init_cache`` is the reference's ``(groups, tail)`` unstacked: the
    same leaves, shapes and dtypes per group and tail layer."""
    cfg = get_config("recurrentgemma_2b", reduced=True)
    jcache, _ = split_tree(JaxModel(jax_get_config(
        "recurrentgemma_2b", reduced=True)).init_cache(2, 12))
    groups, tail = Model(cfg).init_cache(2, 12, "cpu")
    jg, jt = jcache
    for g, grp in enumerate(groups):
        for name in ("rec1", "rec2", "attn"):
            ours = jax.tree.leaves(grp[name], is_leaf=lambda t: isinstance(
                t, torch.Tensor))
            ref = jax.tree.leaves(jax.tree.map(lambda a: a[g], jg[name]))
            assert [tuple(t.shape) for t in ours] == [r.shape for r in ref]
            assert all(t.dtype == torch.bfloat16 for t in ours)
    assert len(tail) == jt["state"].shape[0]
    assert tuple(tail[0]["state"].shape) == jt["state"].shape[1:]
