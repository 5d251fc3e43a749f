"""Cross-attention and the two families built on it — ``vision``
(llama-3.2-vision-11B: tanh-gated cross-attention layers leading groups of
decoder layers, K/V from image patches) and ``encdec``
(SeamlessM4T-large-v2: a bidirectional encoder over frames, decoder layers
with cross-attention to its memory) — against the JAX package on the
same numpy-seeded inputs and parameters.

The reference zero-initialises the cross layers' gates, so at init every
cross layer adds exactly nothing and a wrong cross-attention would pass
any comparison. Every vision test here draws the gates with
``transformer.draw_live_gates`` (the same numbers on both sides) and
asserts that the cross layers change the logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import attention as jattention
from repro.models.common import split_tree
from repro_torch.configs import get_config
from repro_torch.models import attention, transformer
from repro_torch.models.model import Model
from test_torch_lm import BF16_TOL, F32_TOL
# Shared with the MLA/MoE file: the reference tree and its conversion
# (live gates), the prompts with frames or patches, the reference's cache
# unstacked, and the whole-arch checks.
from test_torch_lm_mla_moe import (_np, _port_tree, check_bf16,
                                   check_decode_matches_forward, check_f32,
                                   inputs, pair, ref_cache_unstacked)

ARCHS = ("llama_3_2_vision_11b", "seamless_m4t_large_v2")
NEW_ARCHS = ("minicpm3_4b", "dbrx_132b", "deepseek_v2_236b",
             "llama_3_2_vision_11b", "seamless_m4t_large_v2")


def _attn_params(d, H, Kh, D, dtype, seed):
    jp, _ = split_tree(jattention.init(jax.random.PRNGKey(seed), d, H, Kh,
                                       D, dtype=jnp.dtype(dtype)))
    return jp, _port_tree(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv", [(9, 17), (17, 9)])
def test_cross_attention_matches_reference(dtype, Sq, Skv):
    """``attention.apply(kv_x=, kv_positions=)`` with kind ``full`` and
    Sq ≠ Skv (a memory longer and shorter than the queries), then a decode
    step that attends the static cache and leaves it as it was."""
    B, d, H, Kh, D = 2, 32, 4, 2, 16
    jp, pp = _attn_params(d, H, Kh, D, dtype, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, Sq + 1, d)).astype(np.float32)
    mem = rng.standard_normal((B, Skv, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    kw = dict(n_kv=Kh, n_heads=H, kind="full", rope_theta=None)
    ref, _ = jattention.apply(jnp.asarray(x[:, :Sq], jdt), jp,
                              positions=jnp.arange(Sq),
                              kv_x=jnp.asarray(mem, jdt),
                              kv_positions=jnp.arange(Skv), **kw)
    out, kv = attention.apply(torch.from_numpy(x[:, :Sq]).to(tdt), pp,
                              positions=torch.arange(Sq),
                              kv_x=torch.from_numpy(mem).to(tdt),
                              kv_positions=torch.arange(Skv), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    assert kv[0].shape == (B, Skv, Kh, D)

    jk, jv = jattention.project_kv(jnp.asarray(mem, jdt), jp, None,
                                   jnp.arange(Skv))
    ref_d, _ = jattention.apply(jnp.asarray(x[:, Sq:], jdt), jp,
                                positions=jnp.asarray([Sq]), cache=(jk, jv),
                                decode_pos=0, **kw)
    before = [t.clone() for t in kv]
    out_d, kv_d = attention.apply(torch.from_numpy(x[:, Sq:]).to(tdt), pp,
                                  positions=torch.tensor([Sq]), cache=kv,
                                  decode_pos=0, **kw)
    np.testing.assert_allclose(_np(out_d), _np(ref_d), **tol)
    for a, b in zip(kv_d, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attention_matches_reference(dtype):
    """Bidirectional self-attention (kind ``full``, with RoPE): the
    encoder's."""
    B, S, d, H, Kh, D = 2, 21, 32, 4, 4, 16
    jp, pp = _attn_params(d, H, Kh, D, dtype, 3)
    x = np.random.default_rng(4).standard_normal((B, S, d)).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    kw = dict(n_kv=Kh, n_heads=H, kind="full", rope_theta=1e4, block_kv=8)
    ref, _ = jattention.apply(jnp.asarray(x, jdt), jp,
                              positions=jnp.arange(S), **kw)
    out, _ = attention.apply(torch.from_numpy(x).to(tdt), pp,
                             positions=torch.arange(S), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **(
        F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("kind", ["causal", "sliding"])
def test_masked_prefill_attention_with_unequal_lengths_raises(kind):
    """The flash kernel puts q and kv positions both at 0, so a causal or
    sliding prefill with Sq ≠ Skv raises on every device rather than
    mis-masks; kind ``full`` takes it."""
    q = torch.zeros((1, 4, 1, 2, 16))
    k = torch.zeros((1, 6, 1, 16))
    with pytest.raises(ValueError, match="Sq == Skv"):
        attention.prefill_attention(q, k, k, kind=kind, window=3)
    assert attention.prefill_attention(q, k, k,
                                       kind="full").shape == q.shape


@pytest.mark.parametrize("kind,window,Skv", [
    ("causal", 0, 13), ("sliding", 4, 13), ("full", 0, 13), ("full", 0, 29)])
def test_prefill_attention_masks_from_zero(kind, window, Skv):
    """``prefill_attention`` puts q and kv positions at ``arange`` on every
    device, as the kernel's mask does: on the CPU it equals the
    reference's ``blocked_attention`` at those positions."""
    B, Sq, Kh, G, D = 2, 13, 2, 2, 16
    rng = np.random.default_rng(Skv + window)
    q = rng.standard_normal((B, Sq, Kh, G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, Kh, D)).astype(np.float32)
            for _ in range(2))
    ref = jattention.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(Sq),
        jnp.arange(Skv), kind=kind, window=window, block_kv=8)
    out = attention.prefill_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), kind=kind, window=window,
        block_kv=8)
    np.testing.assert_allclose(_np(out), _np(ref), **F32_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cache_lengths_follow_reference_server(arch):
    """``Model.cache_lengths``, the one rule that sizes the cross caches
    (``Server.generate`` uses it): ``src_len`` the frames' length for
    encdec, ``n_img`` the config's ``n_img_tokens``, as the reference's
    ``Server.generate`` sizes them — also when a batch holds fewer
    patches."""
    m = Model(get_config(arch, reduced=True))
    cfg = jax_get_config(arch, reduced=True)
    batch = dict(tokens=np.zeros((2, 5), np.int64),
                 frames=np.zeros((2, 7, cfg.d_model), np.float32),
                 patches=np.zeros((2, 3, cfg.d_model), np.float32))
    assert m.cache_lengths(batch) == dict(
        src_len=7 if cfg.family == "encdec" else 0, n_img=cfg.n_img_tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_reference_f32(arch):
    logits = check_f32(arch)
    if arch.startswith("llama"):
        # The live gates matter: with the reference's zero gates the
        # logits differ from these by far more than the tolerance.
        jm, jp0, _, _ = pair(arch, "float32", live=False)
        _, _, jb, _ = inputs(jm.cfg)
        dead, _ = jm.prefill(jp0, jb)
        assert np.abs(np.asarray(dead) - logits).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_bf16(arch):
    check_bf16(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    check_decode_matches_forward(arch)


def test_convert_unstacks_nested_and_encdec_stacks():
    """vision: ``groups`` and each group's ``selfs`` stack become lists;
    encdec: ``enc_layers`` and ``layers`` do, ``enc_norm`` stays."""
    jm, jp, m, pp = pair("llama_3_2_vision_11b", "bfloat16")
    cfg = m.cfg
    assert len(pp["groups"]) == cfg.n_layers // cfg.cross_every
    selfs = pp["groups"][0]["selfs"]
    assert isinstance(selfs, list) and len(selfs) == cfg.cross_every - 1
    assert selfs[2]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        selfs[2]["attn"]["wq"].float().numpy(),
        np.asarray(jp["groups"]["selfs"]["attn"]["wq"][0, 2], np.float32))
    gate = pp["groups"][0]["cross"]["gate_attn"]
    assert gate.shape == (1,) and float(gate.abs()) > 0.4
    jm, jp, m, pp = pair("seamless_m4t_large_v2", "float32")
    cfg = m.cfg
    assert (len(pp["enc_layers"]), len(pp["layers"])) == (cfg.enc_layers,
                                                          cfg.n_layers)
    assert set(pp["enc_norm"]) == {"scale", "bias"}
    np.testing.assert_array_equal(
        pp["layers"][1]["cross"]["wk"].numpy(),
        np.asarray(jp["layers"]["cross"]["wk"][1]))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cache_layout_matches_reference(arch):
    """``init_cache`` (with ``src_len`` and ``n_img``) has the reference's
    leaves, shapes and dtypes, unstacked."""
    jm = JaxModel(jax_get_config(arch, reduced=True))
    m = Model(get_config(arch, reduced=True))
    lengths = dict(src_len=7, n_img=m.cfg.n_img_tokens)
    ref, _ = split_tree(jm.init_cache(2, 11, **lengths))
    port = m.init_cache(2, 11, "cpu", **lengths)
    ref = ref_cache_unstacked(m.cfg, ref)
    port_leaves = jax.tree.leaves(
        port, is_leaf=lambda t: isinstance(t, torch.Tensor))
    ref_leaves = jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        assert not a.any()


def test_cross_layers_are_the_identity_at_init():
    """The reference's zero gates: a vision model's logits do not depend
    on its patches until the gates are drawn live."""
    cfg = get_config("llama_3_2_vision_11b", reduced=True).replace(
        dtype="float32", param_dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 6), dtype=torch.long)
    runs = []
    for seed in (0, 1, 0):
        if len(runs) == 2:
            rng = np.random.default_rng(3)
            for g in params["groups"]:
                g["cross"].update({k: torch.from_numpy(v) for k, v in
                                   transformer.draw_live_gates(rng).items()})
        patches = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (1, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
        runs.append(m.prefill(params, dict(tokens=toks, patches=patches))[0])
    assert torch.equal(runs[0], runs[1])           # zero gates: no effect
    assert (runs[2] - runs[0]).abs().max() > 1e-3  # live gates: an effect
