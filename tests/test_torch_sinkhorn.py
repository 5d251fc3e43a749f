"""The port's Sinkhorn iteration and annealed solve against the JAX
package's: their plain versions against the reference oracle and the Pallas
kernel (interpret mode, as tests/test_kernels.py runs it on the CPU). The
CUDA kernels against the plain versions on the card are in
test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.round import _sinkhorn_pallas
from repro.kernels.sinkhorn.ops import sinkhorn_iteration as jax_iteration
from repro.kernels.sinkhorn.ref import sinkhorn_iteration_ref as jax_ref
from repro_torch.kernels.sinkhorn import ops, sinkhorn
from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_ref

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


# The fused round's duals, port vs reference: the parity contract's 1e-4
# (float32 on both sides, sums in other orders over 360 iterations).
SOLVE_ATOL = 1e-4


def _solve_case(M, N):
    rng = np.random.default_rng(M + N)
    C = rng.random((M, N)).astype(np.float32)
    log_a = np.full(M, -np.log(M), np.float32)
    b = rng.random(N) + 0.5
    log_b = np.log(b / b.sum()).astype(np.float32)
    return C, log_a, log_b


@pytest.mark.parametrize("N", [6, 41])
@pytest.mark.parametrize("M", [4, 128, 512])
def test_plain_solve_matches_pallas_anneal(M, N):
    """The annealed solve's plain version (the CPU side of the one-launch
    kernel) against the reference's annealed loop of the Pallas kernel."""
    C, log_a, log_b = _solve_case(M, N)
    f_j, g_j, eps_j = _sinkhorn_pallas(
        jnp.asarray(C), jnp.asarray(log_a), jnp.asarray(log_b), eps0=0.5,
        eps_min=0.005, iters=60, anneal_stages=6, interpret=True)
    table = ops.eps_table(0.5, 0.005, 6)
    f_t, g_t = sinkhorn_solve_ref(torch.from_numpy(C),
                                  torch.from_numpy(log_a),
                                  torch.from_numpy(log_b), table, 60)
    assert f_t.dtype == g_t.dtype == torch.float32
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=SOLVE_ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=SOLVE_ATOL)
    assert ops.anneal_schedule(0.5, 0.005, 6)[-1] == eps_j


@pytest.mark.parametrize("eps0,eps_min,stages", [(0.5, 0.005, 6),
                                                 (1.0, 0.01, 4),
                                                 (0.3, 0.3, 1)])
def test_eps_table_is_the_loops_eps_in_float32(eps0, eps_min, stages):
    """The annealed launch's table holds, bit for bit, the float32 eps that
    the per-iteration loop hands the iteration kernel at each stage: the
    reference loop's Python double, rounded by ctypes."""
    import ctypes
    decay = (eps_min / eps0) ** (1.0 / max(stages - 1, 1))
    loop = [eps0 * decay ** s for s in range(stages)]
    assert ops.anneal_schedule(eps0, eps_min, stages) == loop
    want = np.array([ctypes.c_float(e).value for e in loop], np.float32)
    got = np.array(ops.eps_table(eps0, eps_min, stages), np.float32)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.array(loop, np.float32).tobytes()


def test_cpu_solve_launches_nothing():
    C, log_a, log_b = (torch.from_numpy(x) for x in _solve_case(128, 6))
    before = (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES)
    f, g = ops.sinkhorn_solve(C, log_a, log_b, ops.eps_table(0.5, 0.005, 6),
                              60)
    assert (sinkhorn.LAUNCHES, sinkhorn.ANNEAL_LAUNCHES) == before
    f_r, g_r = sinkhorn_solve_ref(C, log_a, log_b,
                                  ops.eps_table(0.5, 0.005, 6), 60)
    assert torch.equal(f, f_r) and torch.equal(g, g_r)


def test_solve_wrapper_rejects_what_the_launch_does_not_take():
    """The annealed launch's binding raises before any build or launch on
    host memory, a bad shape or an eps table it cannot hold; the dispatch in
    ops is the only route from a CPU tensor to the plain loop."""
    C, log_a, log_b = (torch.from_numpy(x) for x in _solve_case(128, 6))
    table = ops.eps_table(0.5, 0.005, 6)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn.sinkhorn_solve_cuda(C, log_a, log_b, table, 60)
    with pytest.raises(ValueError, match="shape"):
        sinkhorn.sinkhorn_solve_cuda(C[:, None], log_a, log_b, table, 60)
    wide = torch.zeros(4, sinkhorn.MAX_ANNEAL_COLUMNS + 1)
    with pytest.raises(ValueError, match="unsupported"):
        sinkhorn.sinkhorn_solve_cuda(wide, log_a[:4],
                                     torch.zeros(wide.shape[1]), table, 60)
    for bad in ([], [0.5] * (sinkhorn.MAX_STAGES + 1)):
        with pytest.raises(ValueError, match="stages"):
            sinkhorn.sinkhorn_solve_cuda(C, log_a, log_b, bad, 60)
    with pytest.raises(ValueError, match="iters"):
        sinkhorn.sinkhorn_solve_cuda(C, log_a, log_b, table, -1)
    meta = [t.to("meta") for t in (C, log_a, log_b)]
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        ops.sinkhorn_solve(*meta, table, 60)
