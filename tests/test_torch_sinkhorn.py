"""The port's Sinkhorn iteration against the JAX package's: its plain
version against the reference oracle and the Pallas kernel (interpret mode,
as tests/test_kernels.py runs it on the CPU). The CUDA kernel against the
plain version on the card is in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.sinkhorn.ops import sinkhorn_iteration as jax_iteration
from repro.kernels.sinkhorn.ref import sinkhorn_iteration_ref as jax_ref
from repro_torch.kernels.sinkhorn import ops, sinkhorn

# The tolerance of the reference's own kernel test (test_kernels.py).
ATOL = 2e-4


def _case(M, N, eps):
    rng = np.random.default_rng(M * 100 + N * 10 + int(eps * 100))
    C = rng.random((M, N)).astype(np.float32)
    g = (rng.standard_normal(N) * 0.1).astype(np.float32)
    log_a = np.full(M, -np.log(M), np.float32)
    b = rng.random(N) + 0.5
    log_b = np.log(b / b.sum()).astype(np.float32)
    return C, g, log_a, log_b


@pytest.mark.parametrize("eps", [0.05, 0.2, 1.0])
@pytest.mark.parametrize("N", [2, 6, 9])
@pytest.mark.parametrize("M", [128, 256, 512])
def test_plain_iteration_matches_reference_and_pallas(M, N, eps):
    C, g, log_a, log_b = _case(M, N, eps)
    before = sinkhorn.LAUNCHES
    f_t, g_t = ops.sinkhorn_iteration(
        torch.from_numpy(C), None, torch.from_numpy(g),
        torch.from_numpy(log_a), torch.from_numpy(log_b), eps)
    assert sinkhorn.LAUNCHES == before      # a CPU call launches nothing
    assert f_t.dtype == g_t.dtype == torch.float32
    jargs = (jnp.asarray(C), None, jnp.asarray(g), jnp.asarray(log_a),
             jnp.asarray(log_b), eps)
    f_r, g_r = jax_ref(*jargs)
    f_p, g_p = jax_iteration(*jargs, interpret=True)
    for f_j, g_j in ((f_r, g_r), (f_p, g_p)):
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel's launcher takes CUDA tensors only: it raises before any
    build or launch when handed host memory (the dispatch in ops is the
    only route from a CPU tensor to the plain version)."""
    C, g, log_a, log_b = (torch.from_numpy(x) for x in _case(128, 6, 0.2))
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn.sinkhorn_iteration_cuda(C, g, log_a, log_b, 0.2)
    with pytest.raises(ValueError):
        sinkhorn.sinkhorn_iteration_cuda(C[:, None], g, log_a, log_b, 0.2)
