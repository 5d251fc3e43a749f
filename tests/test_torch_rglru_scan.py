"""The port's RG-LRU scan (forward and backward) and the Griffin block
around it, against the JAX package on the same inputs.

On the CPU the port's wrapper takes its plain versions (the sequential
loop forward, the reverse recurrence backward); the reference runs its
Pallas kernel in interpret mode. Both are float32; the reference's own
kernel tests hold its scan at atol 1e-4, and so do these."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ops import rglru_scan as ref_scan
from repro.models import common as ref_common
from repro.models import rglru as ref_rglru
from repro_torch import convert, numerics
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan import rglru_scan as binding
from repro_torch.kernels.rglru_scan.ref import (rglru_gates,
                                                rglru_layer_ref,
                                                rglru_scan_bwd_ref,
                                                rglru_scan_chunked_ref,
                                                rglru_scan_ref)
from repro_torch.models import common, rglru

ATOL = 1e-4


def _inputs(rng, B, S, W, top=0.95):
    a = (rng.random((B, S, W)) * top).astype(np.float32)
    bx = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, bx


@pytest.mark.parametrize("B,S,W,chunk", [
    (2, 64, 32, 16), (2, 128, 128, 64), (2, 32, 256, 32),  # scan sweep
    (15, 48, 16, 128), (5, 29, 16, 128), (2, 7, 15, 128),  # forecast shapes
    (64, 48, 16, 128), (75, 48, 16, 128), (16, 48, 16, 128),  # forecaster
])
def test_scan_forward_matches_reference(B, S, W, chunk):
    """The reference's Pallas kernel (interpret mode) against the port's
    wrapper on CPU tensors; ``chunk`` goes to both (the port ignores it)."""
    rng = np.random.default_rng(B * 1000 + S + W)
    a, bx = _inputs(rng, B, S, W)
    y_ref = np.asarray(ref_scan(jnp.asarray(a), jnp.asarray(bx),
                                chunk=chunk, interpret=True))
    y = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                       chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=ATOL)


@pytest.mark.parametrize("B,S,W,chunk", [(2, 32, 16, 16), (3, 48, 8, 48),
                                         (1, 64, 4, 16)])
def test_scan_gradients_match_reference_vjp(B, S, W, chunk):
    """Autograd through the port's wrapper (its backward is the reverse
    recurrence) against ``jax.grad`` through the reference's custom VJP,
    at the shapes of the reference's VJP test; atol/rtol 1e-4 as there."""
    rng = np.random.default_rng(B * 100 + S)
    a = rng.uniform(0.2, 0.95, (B, S, W)).astype(np.float32)
    bx = rng.normal(size=(B, S, W)).astype(np.float32)
    w = rng.normal(size=(B, S, W)).astype(np.float32)
    loss = lambda a_, bx_: jnp.sum(w * ref_scan(a_, bx_, chunk=chunk,
                                                interpret=True))
    ga, gbx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a),
                                              jnp.asarray(bx))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(bx).requires_grad_(True)
    (torch.from_numpy(w) * ops.rglru_scan(at, bt, chunk=chunk)).sum() \
        .backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gbx), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("B,S,W", [(64, 48, 16), (2, 7, 15), (3, 1, 5)])
def test_backward_recurrence_matches_autograd_of_plain_loop(B, S, W):
    """The backward the kernel computes (``rglru_scan_bwd_ref`` on the CPU)
    against autograd through the plain forward loop: the same function,
    two orders of operations."""
    rng = np.random.default_rng(S * W)
    a, bx = _inputs(rng, B, S, W)
    gy = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(bx).requires_grad_(True)
    y = rglru_scan_ref(at, bt)
    da, dbx = torch.autograd.grad(y, (at, bt), gy)
    da_r, dbx_r = rglru_scan_bwd_ref(at.detach(), y.detach(), gy)
    torch.testing.assert_close(da_r, da, atol=ATOL, rtol=0)
    torch.testing.assert_close(dbx_r, dbx, atol=ATOL, rtol=0)


def test_cuda_binding_rejects_cpu_and_bad_inputs():
    """The binding checks its inputs before it builds or launches: CPU
    tensors, wrong types and ragged shapes raise (no fallback)."""
    a = torch.rand(2, 7, 15)
    with pytest.raises(ValueError, match="CUDA"):
        binding.rglru_scan_fwd_cuda(a, a.clone())
    with pytest.raises(ValueError, match="CUDA"):
        binding.rglru_scan_bwd_cuda(a, a.clone(), a.clone())
    with pytest.raises(ValueError, match="B, S, W"):
        binding.rglru_scan_fwd_cuda(a[0], a[0])
    with pytest.raises(ValueError, match="device"):
        ops.rglru_scan(a.to("meta"), a.to("meta"))


def _block_params(seed, W):
    tree, _ = ref_common.split_tree(
        ref_rglru.block_init(jax.random.PRNGKey(seed), W, lru_width=W))
    # Non-trivial conv taps, biases and decay rates, so every term is used.
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, tree)
    for k in ("conv_w", "conv_b", "b_a", "b_x", "lam"):
        tree[k] = (rng.standard_normal(tree[k].shape) * 0.5).astype(
            np.float32)
    return tree, convert.learned_params_from_reference(tree)


def test_gates_and_block_match_reference():
    """``_gates`` (softplus in logaddexp form) and the train-mode block
    (tanh GELU, causal conv, RG-LRU, gated projection) on the same params
    and input, with the plain layer, the fused wrapper and the scan
    wrapper over the plain gates; float32 matmuls in two libraries, atol
    1e-5."""
    B, S, W = 2, 32, 16
    ref_p, p = _block_params(3, W)
    x = np.random.default_rng(3).standard_normal((B, S, W)).astype(
        np.float32)
    a_r, bx_r = ref_rglru._gates(jnp.asarray(x), ref_p)
    a, bx = rglru._gates(torch.from_numpy(x), p)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=1e-5)
    np.testing.assert_allclose(bx.numpy(), np.asarray(bx_r), atol=1e-5)
    y_r = np.asarray(ref_rglru.block_apply(jnp.asarray(x), ref_p)[0])
    scan_layer = lambda *args: ops.rglru_scan(*rglru_gates(*args))
    for layer in (rglru_layer_ref, ops.rglru_layer, scan_layer):
        y, cache = rglru.block_apply(torch.from_numpy(x), p, layer=layer)
        assert cache is None
        np.testing.assert_allclose(y.numpy(), y_r, atol=1e-5)


def test_softplus_has_no_linear_switch():
    """``jax.nn.softplus`` is logaddexp(x, 0) everywhere; torch's default
    softplus switches to x above 20. The port's matches the reference."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.9, 20.1, 25.0], np.float32)
    np.testing.assert_array_equal(
        numerics.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
        .numpy(),
        np.asarray(ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6)


def _layer_inputs(B, S, W, seed, clamp):
    """x, the gate parameters and an output weighting, from a seed. With
    ``clamp`` the recurrence gate's bias is -50, so pre_r <= -40 and
    1 - exp(2 log_a) is 0: every element takes the 1e-12 floor."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    p = dict(w_a=rng.standard_normal((W, W)) / np.sqrt(W),
             b_a=rng.standard_normal(W) * 0.5 - (50.0 if clamp else 0.0),
             w_x=rng.standard_normal((W, W)) / np.sqrt(W),
             b_x=rng.standard_normal(W) * 0.5,
             lam=rng.standard_normal(W) * 0.5)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    wt = rng.standard_normal((B, S, W)).astype(np.float32)
    return x, p, wt


@pytest.mark.parametrize("B,S,W,clamp", [
    (64, 48, 16, False), (16, 48, 16, False), (5, 29, 16, False),
    (2, 7, 15, False), (4, 48, 16, True)])
def test_layer_matches_reference_forward_and_grads(B, S, W, clamp):
    """``ops.rglru_layer`` on CPU tensors (its plain version, through
    autograd) against the reference's ``_gates`` and Pallas scan
    (interpret mode, custom VJP) under ``jax.grad``: the output and the
    gradients in x, w_a, b_a, w_x, b_x and lam through the gate products.
    atol 1e-4 and rtol 1e-4 (the parameter gradients sum over B x S). In
    the clamp case every gradient through the gates is below 1.6e-4, so
    the absolute bound says nothing there: it is held relatively, rtol
    1e-3 (the sqrt factor's slope is 0 in both, the rest is the exp's
    last bits in two libraries)."""
    x, p, wt = _layer_inputs(B, S, W, B + S + W, clamp)

    def loss(x_, p_):
        return jnp.sum(wt * ref_scan(*ref_rglru._gates(x_, p_),
                                     interpret=True))
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    y_ref = np.asarray(ref_scan(*ref_rglru._gates(jnp.asarray(x), pj),
                                interpret=True))
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), pj)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    pre_r = xt @ pt["w_a"] + pt["b_a"]
    pre_i = xt @ pt["w_x"] + pt["b_x"]
    if clamp:
        a, _ = rglru_gates(pre_r, pre_i, xt, pt["lam"])
        assert bool((1.0 - a.detach() ** 2 < 1e-12).all())
    y = ops.rglru_layer(pre_r, pre_i, xt, pt["lam"])
    (torch.from_numpy(wt) * y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=ATOL)
    grads = dict(x=(xt.grad, gx), **{k: (pt[k].grad, gp[k]) for k in p})
    for name, (got, want) in grads.items():
        want = np.asarray(want)
        if clamp:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                       rtol=ATOL, err_msg=name)


@pytest.mark.parametrize("B,S,W,chunk", [
    (2, 48, 16, 6), (3, 29, 5, 4), (2, 7, 15, 1), (2, 200, 8, 8),
    (1, 130, 3, 16), (64, 48, 16, binding.chunk_for(48)),
    (1, 300, 4, binding.chunk_for(300))])
def test_chunked_twin_matches_loop_and_reference(B, S, W, chunk):
    """The twin of the kernels' chunk order (one tile, several tiles with
    a ragged last one, chunks of 1 to 16 steps, the forecaster's shape and
    a long S at the chunks the kernels take) against the sequential loop,
    atol 1e-5, and the reference's oracle loop, atol 1e-5."""
    from repro.kernels.rglru_scan.ref import rglru_ref
    rng = np.random.default_rng(S + chunk)
    a, bx = _inputs(rng, B, S, W)
    y = rglru_scan_chunked_ref(torch.from_numpy(a), torch.from_numpy(bx),
                               chunk)
    torch.testing.assert_close(
        y, rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bx)),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(rglru_ref(jnp.asarray(a), jnp.asarray(bx))),
        atol=1e-5)


def test_kernel_chunks_cover_any_length():
    """``chunk_for`` gives one tile of at most 16-step chunks up to S 128
    (6 steps at the forecaster's S 48), 8-step chunks beyond."""
    assert binding.chunk_for(48) == 6
    assert [binding.chunk_for(S) for S in (1, 7, 8, 9, 128)] == [1, 1, 1, 2,
                                                                  16]
    assert binding.chunk_for(129) == binding.chunk_for(2048) == 8


def test_layer_binding_rejects_cpu_and_bad_inputs():
    """The fused binding checks its inputs before it builds or launches:
    CPU tensors, a lam of the wrong width and non-[B, S, W] inputs raise
    (no fallback)."""
    t = torch.rand(2, 7, 15)
    lam = torch.rand(15)
    with pytest.raises(ValueError, match="CUDA"):
        binding.rglru_layer_fwd_cuda(t, t, t, lam)
    with pytest.raises(ValueError, match="CUDA"):
        binding.rglru_layer_bwd_cuda(t, t, t, lam, t, t)
    with pytest.raises(ValueError, match="B, S, W"):
        binding.rglru_layer_fwd_cuda(t[0], t[0], t[0], lam)
    with pytest.raises(ValueError, match="device"):
        ops.rglru_layer(t.to("meta"), t.to("meta"), t.to("meta"),
                        lam.to("meta"))
