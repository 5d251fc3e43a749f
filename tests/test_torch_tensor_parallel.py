"""Tensor-parallel compute on ``model`` without ranks: which kv heads a
rank's q heads read (``models/attention._Heads``), which leaves compute
tensor-parallel (``transformer.tensor_parallel_mask``), the loss's
layout-independent sum (``common.softmax_xent``) and the flash kernel's
input check on one rank's heads. The multi-rank steps are
``test_torch_distributed.py``'s and
``test_torch_tensor_parallel_layers.py``'s; this file imports neither jax
nor the JAX package.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.flash_attention import flash_attention as fk
from repro_torch.models import attention, common, transformer
from repro_torch.models.model import Model, tree_tensors
from repro_torch.runtime import sharding


class _Rank:
    """A ``TensorParallel`` stand-in: its index on ``model`` alone."""

    def __init__(self, rank):
        self.rank = rank


# (q heads, kv heads, model): kv split with the heads; replicated kv
# read whole groups (qwen2-72B's 8 on 16, reduced qwen2-72B's 2 on 4,
# recurrentgemma's MQA); a group split over ranks; q heads straddling
# two kv groups unevenly (12 over 3 on 4, 6 over 3 on 4).
HEAD_CASES = [(64, 8, 8), (64, 8, 16), (4, 2, 4), (4, 1, 2), (16, 2, 4),
              (12, 3, 4), (6, 3, 2), (12, 4, 3)]


@pytest.mark.parametrize("H,Kh,M", HEAD_CASES)
def test_each_local_q_head_meets_its_own_kv_head(H, Kh, M):
    """On every rank, the kv heads ``_Heads`` selects — from every kv
    head (a replicated cache or the prefill's whole projection), from
    the kv weights cut by ``weights`` before the product, or as the
    rank's block — line up with the rank's q heads in the layout it
    gives q: local q head j of rank r reads kv head (r·H/M + j) // (H/Kh),
    as the reference's grouped query heads do."""
    D, Hl = 2, H // M
    for r in range(M):
        kv_held = Kh // M if Kh % M == 0 else Kh
        p = dict(wq=torch.zeros(1, Hl, D), wk=torch.zeros(1, kv_held, D),
                 wv=torch.zeros(1, kv_held, D), bk=torch.zeros(kv_held, D),
                 bv=torch.zeros(kv_held, D))
        heads = attention._Heads(p, H, Kh, _Rank(r))
        n_kv, group = heads.layout
        assert n_kv * group == Hl
        ids = torch.arange(Kh, dtype=torch.float32)
        whole = ids.view(1, 1, Kh, 1).expand(1, 1, Kh, D)
        if kv_held == Kh:
            cut = heads.weights(dict(p, wk=whole[0].clone()))["wk"]
            sources = [whole, cut[None]]
        else:
            sources = [whole, whole[:, :, r * kv_held:(r + 1) * kv_held]]
        want = [(r * Hl + j) // (H // Kh) for j in range(Hl)]
        for t in sources:
            got = heads.select(t)[0, 0, :, 0]
            assert got.shape == (n_kv,)
            per_q = got.repeat_interleave(group).tolist()
            assert per_q == want, (r, per_q, want)


def test_unsharded_heads_are_the_layers_own():
    """Without a ``model`` split every head is local: q as [B, S, Kh,
    H/Kh, D] over the kv heads as they are (no selection, no copy)."""
    p = dict(wq=torch.zeros(1, 12, 2), wk=torch.zeros(1, 2, 2))
    heads = attention._Heads(p, 12, 2, None)
    assert heads.layout == (2, 6) and heads.index is None
    t = torch.zeros(1, 3, 2, 2)
    assert heads.select(t) is t and heads.weights(p) is p


def _marked(mask, path=()):
    if isinstance(mask, dict):
        return {k2 for k, v in mask.items() for k2 in _marked(v, path + (k,))}
    if isinstance(mask, (list, tuple)):
        return {k2 for v in mask for k2 in _marked(v, path)}
    return {path} if mask else set()


# The parameter dicts whose leaves compute tensor-parallel, by the last
# two keys of their path (lists dropped), per family: every sub-layer's.
TP_SUBLAYERS = dict(
    qwen2_72b={("embed", "tokens"), ("embed", "head"), ("attn", "wq"),
               ("mlp", "wo")},
    dbrx_132b={("embed", "head"), ("attn", "wk"), ("mlp", "wo"),
               ("mlp", "wi")},
    minicpm3_4b={("embed", "tokens"), ("mlp", "wi"), ("attn", "wkv_a"),
                 ("attn", "wkv_b_k"), ("kv_norm", "scale")},
    mamba2_2_7b={("embed", "tokens"), ("mixer", "in_proj"),
                 ("mixer", "A_log"), ("mixer", "norm_scale")},
    recurrentgemma_2b={("rec1", "mlp"), ("attn", "wv"), ("mixer", "w_a"),
                       ("mixer", "lam"), ("mixer", "out")},
    llama_3_2_vision_11b={("cross", "wq"), ("selfs", "attn"),
                          ("cross", "mlp")},
    seamless_m4t_large_v2={("enc_layers", "attn"), ("self", "wo"),
                           ("cross", "wq")},
    deepseek_v2_236b={("dense_layers", "mlp"), ("shared", "wi"),
                      ("mlp", "wo"), ("mlp", "wg"), ("attn", "wq_b"),
                      ("attn", "wkv_b_v"), ("q_norm", "scale")})
# Leaves every family gathers whole: the layers' norms, the final and
# encoder norms, the vision cross layers' gates and MoE's router (every
# rank routes all of its tokens, for the same whole gradient).
WHOLE_SUBLAYERS = {"ln1", "ln2", "ln3", "final_norm", "enc_norm",
                   "gate_attn", "gate_mlp", "router"}


def _unmarked(mask, shapes, path=()):
    if isinstance(mask, dict):
        return {k2 for k, v in mask.items()
                for k2 in _unmarked(v, shapes[k], path + (k,))}
    if isinstance(mask, (list, tuple)):
        return {k2 for v, t in zip(mask, shapes)
                for k2 in _unmarked(v, t, path)}
    return set() if mask else {path}


@pytest.mark.parametrize("arch", list_archs())
def test_tensor_parallel_mask_names_the_dense_sublayers(arch):
    """``Model.tensor_parallel_mask`` marks every sub-layer's leaves: the
    embedding and logits head, dense attention (self, cross, the
    encoder's), dense MLPs, MLA (its norms too), MoE (routed and shared
    experts) and the Mamba-2 and RG-LRU mixers — the leaves
    ``materialize`` leaves to ``sharding.local_params``; the only leaves
    left unmarked, and so gathered whole, are the layers' norms, the
    cross layers' gates and MoE's router."""
    model = Model(get_config(arch, reduced=True))
    shapes, _ = model.abstract_params()
    mask = model.tensor_parallel_mask(shapes)
    marked = _marked(mask)
    assert {("embed", "tokens")} <= marked
    for a, b in TP_SUBLAYERS.get(arch, ()):
        assert any(a in p and (b in p) for p in marked), (arch, a, b)
    for path in _unmarked(mask, shapes):
        assert path[-2] in WHOLE_SUBLAYERS or \
            path[-1] in WHOLE_SUBLAYERS, (arch, path)


@pytest.mark.parametrize("V", [2048, 4096 + 64, 100])
def test_loss_sums_exponentials_in_vocabulary_blocks(V):
    """``softmax_xent`` without ``tp``: the log-sum-exp from 64-entry
    block sums (the order a vocab-parallel rank's blocks keep) agrees
    with ``torch.logsumexp`` to float32 rounding, and its gradient is
    softmax minus the label's one-hot over the rows."""
    g = torch.Generator().manual_seed(V)
    logits = (3 * torch.randn(3, 5, V, generator=g)).requires_grad_(True)
    labels = torch.randint(0, V, (3, 5), generator=g)
    loss = common.softmax_xent(logits, labels)
    want = torch.mean(torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None])[..., 0])
    assert abs(loss.item() - want.item()) <= 2e-6 * abs(want.item())
    (grad,) = torch.autograd.grad(loss, logits)
    ref = (torch.softmax(logits, -1) - torch.nn.functional.one_hot(
        labels, V)) / labels.numel()
    np.testing.assert_allclose(grad.numpy(), ref.detach().numpy(),
                               atol=1e-7)


def test_flash_check_accepts_one_ranks_heads():
    """qwen2-72B's attention on one rank of model 8 hands the flash
    kernel its 8 q heads over 1 kv head, [4, S, 8, 128] group 8 in bf16,
    as the column-parallel projections make them (contiguous, and as
    column views of a wider projection): the wgmma variant takes them."""
    B, S, d = 4, 64, 256
    x = torch.randn(B, S, d).to(torch.bfloat16)
    wide = x @ torch.randn(d, 2 * 8 * 128).to(torch.bfloat16)
    q = (x @ torch.randn(d, 8 * 128).to(torch.bfloat16)).view(B, S, 8, 128)
    k, v = (wide[..., i * 1024:i * 1024 + 128].view(B, S, 1, 128)
            for i in range(2))
    assert fk.check_inputs(q, k, v) == "wgmma"
    assert fk.check_inputs(wide[..., :1024].view(B, S, 8, 128), k, v) == \
        "wgmma"


def test_tensor_parallel_needs_a_split_over_model():
    """Outside a sharded step (plain tensors), or where no leaf is split
    over ``model``, a sub-layer computes whole: ``local_params`` hands its
    tree back with no handle."""
    p = dict(wi=torch.zeros(2, 4), wg=torch.zeros(2, 4), wo=torch.zeros(4, 2))
    out, tp = sharding.local_params(p)
    assert out is p and tp is None
    assert sharding.model_split(p) is None
    mask = transformer.tensor_parallel_mask(dict(embed=dict(tokens=1),
                                                 mlp=p))
    assert tree_tensors(mask) == [True, True, True, True]
