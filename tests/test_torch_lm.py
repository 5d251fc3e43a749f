"""The port's LM serving path against the JAX package's, on the reduced
``qwen2_1_5b``, ``mamba2_2_7b``, ``gemma3_4b`` and ``recurrentgemma_2b``
configs (configs and parameter counts for all nine ported archs): the
reference's init carried
across by ``convert.lm_params_from_reference``, then prefill logits and
caches, every decode step and ``Server.generate``'s tokens compared in one
process, in float32 (tight) and bfloat16 (the reference's own tolerance
and near-tie rule).

The reference's Mamba-2 init zeroes the conv, so x, B and C reach the SSD
as exact zeros and a comparison at that init proves nothing about the
scan. Every Mamba-2 test here draws the mixer's conv and SSM scalars with
``models.ssm.draw_live_mixer`` (the same numbers on both sides) and
asserts that the scan's output is nonzero. The reference's RG-LRU init
zeroes its conv the same way: every griffin test draws the blocks with
``models.rglru.draw_live_block`` and asserts a nonzero recurrence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import Model as JaxModel
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.models.common import split_tree
from repro.runtime.serve_loop import Server as JaxServer
from repro.runtime.serve_loop import _splice as jax_splice
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import attention, common, rglru, ssm, transformer
from repro_torch.models.model import Model
from repro_torch.runtime.serve_loop import Server, _splice

ARCHS = ["qwen2_1_5b", "mamba2_2_7b", "gemma3_4b", "recurrentgemma_2b"]
# Every arch the port serves: all ten of the reference's, in its
# registry's order (the newer five are held in test_torch_lm_mla_moe.py
# and test_torch_lm_cross.py, qwen2_72b in test_torch_sharding.py and
# test_torch_distributed.py).
ALL_ARCHS = ["dbrx_132b", "deepseek_v2_236b", "seamless_m4t_large_v2",
             "qwen2_72b", "qwen2_1_5b", "gemma3_4b", "minicpm3_4b",
             "recurrentgemma_2b", "llama_3_2_vision_11b", "mamba2_2_7b"]
# float32 on both sides; matmuls and reductions in other orders (XLA vs
# PyTorch's CPU kernels) over at most 2 layers of width 64.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# test_decode_matches_forward's bf16 tolerance and near-tie gap.
BF16_TOL = dict(atol=0.15, rtol=0.1)
TIE_GAP = 0.15


def _pair(arch, dtype, seed=0):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    with the reference's init on both sides; Mamba-2 mixers and RG-LRU
    blocks live."""
    jcfg = jax_get_config(arch, reduced=True).replace(dtype=dtype,
                                                      param_dtype=dtype)
    cfg = get_config(arch, reduced=True).replace(dtype=dtype,
                                                 param_dtype=dtype)
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    if cfg.ssm:
        rng = np.random.default_rng(seed + 5)
        draws = [ssm.draw_live_mixer(rng, cfg) for _ in range(cfg.n_layers)]
        mixer = dict(jp["layers"]["mixer"])
        for k in draws[0]:
            mixer[k] = jnp.asarray(np.stack([d[k] for d in draws]),
                                   mixer[k].dtype)
        jp = dict(jp, layers=dict(jp["layers"], mixer=mixer))
    if cfg.family == "griffin":
        jp = live_griffin(jp, cfg, np.random.default_rng(seed + 5))
    return jcfg, jm, jp, cfg, Model(cfg), lm_params_from_reference(jp, cfg)


def _tokens(cfg, B=2, S=20, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def live_griffin(jp, cfg, rng):
    """The reference's griffin tree with every RG-LRU block's conv, gate
    biases and lam drawn by ``draw_live_block`` (stacked per layer)."""
    def live(layers):
        n = layers["mixer"]["lam"].shape[0]
        draws = [rglru.draw_live_block(rng, cfg) for _ in range(n)]
        mixer = dict(layers["mixer"])
        for k in draws[0]:
            mixer[k] = jnp.asarray(np.stack([d[k] for d in draws]),
                                   mixer[k].dtype)
        return dict(layers, mixer=mixer)
    g = jp["groups"]
    out = dict(jp, groups=dict(g, rec1=live(g["rec1"]),
                               rec2=live(g["rec2"])))
    if "tail" in jp:
        out["tail"] = live(jp["tail"])
    return out


def _recurrent(cfg) -> bool:
    return bool(cfg.ssm) or cfg.family == "griffin"


@pytest.fixture
def scan_outputs(monkeypatch):
    """Records max |y| of every plain SSD scan and RG-LRU scan the port
    runs."""
    seen = []

    def record(mod, name):
        plain = getattr(mod, name)

        def recorded(*args, **kw):
            y, s = plain(*args, **kw)
            seen.append(float(y.float().abs().max()))
            return y, s
        monkeypatch.setattr(mod, name, recorded)
    record(ssm, "ssd_chunked")
    record(rglru, "rglru_scan")
    return seen


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def test_configs_match_reference():
    assert list_archs() == tuple(ALL_ARCHS)
    assert jax_list_archs() == tuple(ALL_ARCHS)
    for arch in ALL_ARCHS:
        for reduced in (False, True):
            assert dataclasses.asdict(get_config(arch, reduced)) == \
                dataclasses.asdict(jax_get_config(arch, reduced))
        cfg = get_config(arch)
        assert cfg.compute_dtype == torch.bfloat16
        assert cfg.params_dtype == torch.bfloat16
        assert cfg.padded_vocab == jax_get_config(arch).padded_vocab
        assert cfg.sub_quadratic == jax_get_config(arch).sub_quadratic
    assert dataclasses.asdict(get_config("qwen2_72b")) == \
        dataclasses.asdict(jax_get_config("qwen2_72b"))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_matches_reference(arch):
    n = Model(get_config(arch)).param_count()
    assert n == JaxModel(jax_get_config(arch)).param_count()
    cfg = get_config(arch, reduced=True)
    assert Model(cfg).param_count() == JaxModel(
        jax_get_config(arch, reduced=True)).param_count()
    params = Model(cfg).init(torch.Generator().manual_seed(0))

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return t.numel()
    assert count(params) == Model(cfg).param_count()


def test_common_blocks_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e6).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e6)), atol=1e-5)
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    sc, bi = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        common.layer_norm(*map(torch.from_numpy, (h, sc, bi))).numpy(),
        np.asarray(jcommon.layer_norm(*map(jnp.asarray, (h, sc, bi)))),
        atol=1e-5)
    mlp = {k: rng.standard_normal(s).astype(np.float32) / 3 for k, s in
           (("wi", (8, 12)), ("wg", (8, 12)), ("wo", (12, 8)))}
    np.testing.assert_allclose(
        common.mlp_apply(torch.from_numpy(h), {k: torch.from_numpy(v) for
                                               k, v in mlp.items()}).numpy(),
        np.asarray(jcommon.mlp_apply(jnp.asarray(h), {
            k: jnp.asarray(v) for k, v in mlp.items()})), atol=1e-5)
    table = rng.standard_normal((32, 8)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        port = common.logits_from_hidden(torch.from_numpy(h).to(dt),
                                         {"tokens": torch.from_numpy(table)},
                                         20, dt)
        ref = jcommon.logits_from_hidden(jnp.asarray(h, jdt),
                                         {"tokens": jnp.asarray(table)}, 20,
                                         jdt)
        assert port.dtype == dt
        np.testing.assert_allclose(_np(port), _np(ref), atol=2e-2)
    assert common.pad_vocab(151936) == jcommon.pad_vocab(151936) == 153600


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_reference_f32(arch,
                                                         scan_outputs):
    jcfg, jm, jp, cfg, m, pp = _pair(arch, "float32")
    toks = _tokens(cfg)
    B, S = toks.shape
    max_new = 6
    jl, jbuilt = jm.prefill(jp, dict(tokens=jnp.asarray(toks)))
    pl, pbuilt = m.prefill(pp, dict(tokens=torch.from_numpy(toks).long()))
    np.testing.assert_allclose(_np(pl), _np(jl), **F32_TOL)
    if _recurrent(cfg):
        assert scan_outputs and min(scan_outputs) > 1e-3
    # Prefill caches, layer by layer: (k, v) or dict(conv, state).
    for layer, jl_i in _layer_caches(cfg, pbuilt, jbuilt):
        port_leaves = jax.tree.leaves(
            layer, is_leaf=lambda t: isinstance(t, torch.Tensor))
        ref_leaves = jax.tree.leaves(jl_i)
        assert len(port_leaves) == len(ref_leaves)
        for port_leaf, ref_leaf in zip(port_leaves, ref_leaves):
            np.testing.assert_allclose(_np(port_leaf), _np(ref_leaf),
                                       **F32_TOL)

    ref_tokens = JaxServer(jm, jp).generate(dict(tokens=jnp.asarray(toks)),
                                            max_new=max_new)
    port_tokens = Server(m, pp, device="cpu").generate(dict(tokens=toks),
                                                       max_new=max_new)
    assert port_tokens.dtype == np.int32
    np.testing.assert_array_equal(port_tokens, ref_tokens)

    # Each decode step along the reference's tokens.
    jcache, _ = split_tree(jm.init_cache(B, S + max_new))
    jcache = jax_splice(jcache, jbuilt, S)
    pcache = _splice(m.init_cache(B, S + max_new, "cpu"), pbuilt)
    for t in range(max_new - 1):
        tok = ref_tokens[:, t:t + 1]
        ja, jcache = jm.decode(jp, jcache, jnp.asarray(tok), S + t)
        pa, pcache = m.decode(pp, pcache, torch.from_numpy(tok).long(),
                              S + t)
        np.testing.assert_allclose(_np(pa), _np(ja), **F32_TOL)


def _layer_caches(cfg, pbuilt, jbuilt):
    """(port layer cache, reference layer cache) pairs: the reference's
    stacks indexed along their leading axis. The decoder's cache is
    (None, layers); griffin's (groups, tail)."""
    def at(tree, i):
        return jax.tree.map(lambda a: a[i], tree)
    if cfg.family != "griffin":
        return [(c, at(jbuilt[1], i)) for i, c in enumerate(pbuilt[1])]
    pairs = [(grp[name], at(jbuilt[0][name], g))
             for g, grp in enumerate(pbuilt[0])
             for name in ("rec1", "rec2", "attn")]
    return pairs + [(c, at(jbuilt[1], j))
                    for j, c in enumerate(pbuilt[1] or [])]


def _near_tie_ok(port, ref):
    """test_decode_matches_forward's rule: where the argmax differs, the
    port's token's reference logit is within TIE_GAP of the max."""
    ai, bi = port.argmax(-1), ref.argmax(-1)
    rows = np.arange(ref.shape[0])
    gap = ref[rows, bi] - ref[rows, ai]
    return bool(((ai == bi) | (gap <= TIE_GAP)).all()), ai == bi


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_bf16(arch, scan_outputs):
    """bf16 serving: teacher-forced decode logits within the reference's
    tolerance and near-tie rule at every step; the generated streams equal
    up to the first near-tie, where they may part."""
    jcfg, jm, jp, cfg, m, pp = _pair(arch, "bfloat16")
    toks = _tokens(cfg)
    B, S = toks.shape
    max_new = 6
    jl, jbuilt = jm.prefill(jp, dict(tokens=jnp.asarray(toks)))
    pl, pbuilt = m.prefill(pp, dict(tokens=torch.from_numpy(toks).long()))
    np.testing.assert_allclose(_np(pl), _np(jl), **BF16_TOL)
    if _recurrent(cfg):
        assert scan_outputs and min(scan_outputs) > 1e-3
    ref_tokens = JaxServer(jm, jp).generate(dict(tokens=jnp.asarray(toks)),
                                            max_new=max_new)
    port_tokens = Server(m, pp, device="cpu").generate(dict(tokens=toks),
                                                       max_new=max_new)
    # Step 0 is the prefill's argmax; steps 1.. are decode logits.
    steps = [(_np(pl), _np(jl))]
    jcache, _ = split_tree(jm.init_cache(B, S + max_new))
    jcache = jax_splice(jcache, jbuilt, S)
    pcache = _splice(m.init_cache(B, S + max_new, "cpu"), pbuilt)
    for t in range(max_new - 1):
        tok = ref_tokens[:, t:t + 1]
        ja, jcache = jm.decode(jp, jcache, jnp.asarray(tok), S + t)
        pa, pcache = m.decode(pp, pcache, torch.from_numpy(tok).long(),
                              S + t)
        np.testing.assert_allclose(_np(pa), _np(ja), **BF16_TOL)
        steps.append((_np(pa), _np(ja)))
    live = np.ones(B, bool)      # rows whose streams have not parted yet
    for t, (port, ref) in enumerate(steps):
        ok, same = _near_tie_ok(port, ref)
        assert ok, f"step {t}: argmax differs beyond a near-tie"
        same_tok = port_tokens[:, t] == ref_tokens[:, t]
        assert (same_tok | ~live | ~same).all()
        live &= same_tok


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, scan_outputs):
    """The port's own cache consistency, as the reference's
    test_decode_matches_forward, in float32 and with live Mamba-2 mixers
    and RG-LRU blocks (so the recurrences carry signal): teacher-forced
    decode from a prefilled cache reproduces the one-shot forward's
    logits."""
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 param_dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    if cfg.ssm:
        rng = np.random.default_rng(9)
        for lp in params["layers"]:
            lp["mixer"].update({k: torch.from_numpy(v) for k, v in
                                ssm.draw_live_mixer(rng, cfg).items()})
    if cfg.family == "griffin":
        rng = np.random.default_rng(9)
        recs = [g[name] for g in params["groups"] for name in ("rec1",
                                                               "rec2")]
        for lp in recs + params.get("tail", []):
            lp["mixer"].update({k: torch.from_numpy(v) for k, v in
                                rglru.draw_live_block(rng, cfg).items()})
    B, S, extra = 2, 16, 4
    toks = torch.from_numpy(_tokens(cfg, B, S + extra, seed=3)).long()
    full, _ = transformer.apply(cfg, params, dict(tokens=toks), "train")
    _, built = m.prefill(params, dict(tokens=toks[:, :S]))
    if _recurrent(cfg):
        assert min(scan_outputs) > 1e-3
    cache = _splice(m.init_cache(B, S + extra, "cpu"), built)
    for t in range(S, S + extra):
        logits, cache = m.decode(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **F32_TOL)


def test_train_mode_matches_reference_forward():
    jcfg, jm, jp, cfg, m, pp = _pair("qwen2_1_5b", "float32", seed=2)
    toks = _tokens(cfg, seed=4)
    ref, _ = jtransformer.apply(jcfg, jp, dict(tokens=jnp.asarray(toks)),
                                "train")
    port, cache = transformer.apply(cfg, pp, dict(
        tokens=torch.from_numpy(toks).long()), "train")
    assert cache is None
    np.testing.assert_allclose(_np(port), _np(ref), **F32_TOL)


def test_convert_keeps_leaf_dtypes():
    """bf16 leaves (ml_dtypes arrays) go through float32 exactly; the
    Mamba-2 float32 scalars stay float32; layers are unstacked."""
    jcfg, jm, jp, cfg, m, pp = _pair("mamba2_2_7b", "bfloat16")
    assert len(pp["layers"]) == cfg.n_layers
    mixer = pp["layers"][1]["mixer"]
    assert mixer["in_proj"].dtype == torch.bfloat16
    assert mixer["A_log"].dtype == torch.float32
    np.testing.assert_array_equal(
        mixer["in_proj"].float().numpy(),
        np.asarray(jp["layers"]["mixer"]["in_proj"][1], np.float32))
    np.testing.assert_array_equal(
        pp["embed"]["tokens"].float().numpy(),
        np.asarray(jp["embed"]["tokens"], np.float32))


def test_unported_paths_raise():
    """No reference arch is left (qwen2_72b's reduced config is the
    reference's); a family the reference does not have raises; a causal
    prefill attention with Sq != Skv raises rather than mis-masks."""
    assert dataclasses.asdict(get_config("qwen2_72b", reduced=True)) == \
        dataclasses.asdict(jax_get_config("qwen2_72b", reduced=True))
    cfg = get_config("qwen2_1_5b", reduced=True)
    with pytest.raises(NotImplementedError, match="family"):
        Model(cfg.replace(family="rwkv"))
    x = torch.zeros((1, 4, cfg.d_model))
    p, _ = common.split_tree(attention.init(
        torch.Generator().manual_seed(0), cfg.d_model, cfg.n_heads,
        cfg.n_kv, cfg.head_dim_))
    with pytest.raises(ValueError, match="Sq == Skv"):
        attention.apply(x, p, n_kv=cfg.n_kv, n_heads=cfg.n_heads,
                        positions=torch.arange(4), kind="causal",
                        kv_x=torch.zeros((1, 6, cfg.d_model)),
                        kv_positions=torch.arange(6))
