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
from repro_torch import convert
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan import rglru_scan as binding
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
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
    and input; float32 matmuls in two libraries, atol 1e-5."""
    B, S, W = 2, 32, 16
    ref_p, p = _block_params(3, W)
    x = np.random.default_rng(3).standard_normal((B, S, W)).astype(
        np.float32)
    a_r, bx_r = ref_rglru._gates(jnp.asarray(x), ref_p)
    a, bx = rglru._gates(torch.from_numpy(x), p)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_r), atol=1e-5)
    np.testing.assert_allclose(bx.numpy(), np.asarray(bx_r), atol=1e-5)
    y_r = np.asarray(ref_rglru.block_apply(jnp.asarray(x), ref_p)[0])
    for scan in (rglru_scan_ref, ops.rglru_scan):
        y = rglru.block_apply(torch.from_numpy(x), p, scan=scan)
        np.testing.assert_allclose(y.numpy(), y_r, atol=1e-5)


def test_softplus_has_no_linear_switch():
    """``jax.nn.softplus`` is logaddexp(x, 0) everywhere; torch's default
    softplus switches to x above 20. The port's matches the reference."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.9, 20.1, 25.0], np.float32)
    np.testing.assert_array_equal(
        rglru.softplus(torch.from_numpy(x)).numpy(),
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
