"""``Model.loss`` and its gradients for all nine architectures the port
runs, against ``jax.value_and_grad`` of the reference's ``Model.loss``,
on the CPU in float32 at the reduced configs: the loss within LOSS_RTOL
and every gradient leaf within GRAD_REL of its largest entry. Then the
three remat policies give the same gradients.

The kv blocks are cut to 8 rows on both sides (S 20), so the blocked
attention's per-block checkpoint runs over several blocks, a ragged one
included. Mamba-2 mixers, RG-LRU blocks and vision gates are drawn live
(``train_pair``), and each check asserts that their gradients are not
zero.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import lm_params_from_reference
from repro_torch.optim.adamw import tree_leaves
from test_torch_lm import ALL_ARCHS
from test_torch_train import (LOSS_RTOL, assert_grads_close,
                              port_loss_and_grads, train_batch, train_pair)


def _live_leaf(cfg, grads):
    """The gradient of a parameter the reference's init leaves dead (a
    zero conv or gate), or of the first attention's query weights."""
    if cfg.ssm:
        return grads["layers"][0]["mixer"]["conv_w"]
    if cfg.family == "griffin":
        return grads["groups"][0]["rec1"]["mixer"]["conv_w"]
    if cfg.family == "vision":
        return grads["groups"][0]["cross"]["gate_attn"]
    if cfg.family == "encdec":
        return grads["layers"][0]["cross"]["wq"]
    return grads["layers"][-1]["attn"]["wkv_a" if cfg.mla else "wq"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jm, jp, m, pp = train_pair(arch, block_kv=8)
    jb, pb = train_batch(m.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    loss, grads = port_loss_and_grads(m, pp, pb)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert_grads_close(grads, lm_params_from_reference(jgrads, m.cfg))
    assert float(_live_leaf(m.cfg, grads).abs().max()) > 1e-6
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "recurrentgemma_2b",
                                  "llama_3_2_vision_11b",
                                  "seamless_m4t_large_v2", "mamba2_2_7b"])
def test_remat_policies_give_equal_grads(arch):
    """remat "none", "dots" and "full" (vision's groups checkpointed
    around checkpointed layers) give the same loss and gradients; an
    unknown policy raises."""
    out = {}
    for remat in ("none", "dots", "full"):
        _, _, m, pp = train_pair(arch, block_kv=8, remat=remat)
        _, pb = train_batch(m.cfg)
        out[remat] = port_loss_and_grads(m, pp, pb)
    for remat in ("dots", "full"):
        assert float(out[remat][0]) == float(out["none"][0])
        for a, b in zip(tree_leaves(out[remat][1]),
                        tree_leaves(out["none"][1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)
    _, _, m, pp = train_pair(arch, remat="some")
    _, pb = train_batch(m.cfg)
    with pytest.raises(ValueError, match="remat"):
        port_loss_and_grads(m, pp, pb)
