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
from repro_torch.kernels.sinkhorn.ref import (sinkhorn_solve_batched_ref,
                                              sinkhorn_solve_ref)

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


# --- Many cells at once: the cell-batched launch's plain version -------------

def _cells(B, M, N, seed):
    rng = np.random.default_rng(seed)
    C = rng.random((B, M, N)).astype(np.float32)
    log_a = np.full((B, M), -np.log(M), np.float32)
    b = rng.random((B, N)) + 0.5
    log_b = np.log(b / b.sum(1, keepdims=True)).astype(np.float32)
    return C, log_a, log_b


@pytest.mark.parametrize("B,M,N", [(1, 4, 6), (3, 16, 6), (5, 128, 41),
                                   (8, 512, 6), (2, 512, 40), (4, 7, 3)])
def test_batched_plain_solve_is_bitwise_the_per_cell_loop(B, M, N):
    """The plain version of the cell-batched launch, cell for cell, bit for
    bit the single-cell plain loop (each reduction runs within its cell),
    and no launch on a CPU tensor."""
    C, log_a, log_b = (torch.from_numpy(x) for x in _cells(B, M, N, B + M))
    table = ops.eps_table(0.5, 0.005, 6)
    before = (sinkhorn.ANNEAL_LAUNCHES, sinkhorn.ANNEAL_BATCHED_LAUNCHES)
    f_b, g_b = ops.sinkhorn_solve_batched(C, log_a, log_b, table, 60)
    assert (sinkhorn.ANNEAL_LAUNCHES,
            sinkhorn.ANNEAL_BATCHED_LAUNCHES) == before
    assert f_b.shape == (B, M) and g_b.shape == (B, N)
    for b in range(B):
        f, g = sinkhorn_solve_ref(C[b], log_a[b], log_b[b], table, 60)
        assert torch.equal(f_b[b], f) and torch.equal(g_b[b], g)


@pytest.mark.parametrize("B,M,N", [(3, 16, 6), (2, 64, 40)])
def test_batched_plain_solve_matches_vmapped_pallas_anneal(B, M, N):
    """Against the reference's batched path: ``jax.vmap`` of its annealed
    loop of the Pallas kernel (interpret mode) over the cell axis, as its
    ``fused_round_batch`` runs it; two stages of 20 iterations keep the
    interpreted loop short. Within SOLVE_ATOL."""
    import functools

    import jax
    C, log_a, log_b = _cells(B, M, N, B * N)
    run = functools.partial(_sinkhorn_pallas, eps0=0.5, eps_min=0.05,
                            iters=20, anneal_stages=2, interpret=True)
    f_j, g_j, _ = jax.vmap(run)(jnp.asarray(C), jnp.asarray(log_a),
                                jnp.asarray(log_b))
    f_t, g_t = sinkhorn_solve_batched_ref(
        torch.from_numpy(C), torch.from_numpy(log_a), torch.from_numpy(log_b),
        ops.eps_table(0.5, 0.05, 2), 20)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=SOLVE_ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=SOLVE_ATOL)


def test_batched_wrapper_rejects_what_the_launch_does_not_take():
    """The cell-batched binding raises before any build or launch on host
    memory, a bad shape or a bad schedule; the dispatch in ops is the only
    route from a CPU tensor to the plain loop."""
    C, log_a, log_b = (torch.from_numpy(x) for x in _cells(2, 128, 6, 0))
    table = ops.eps_table(0.5, 0.005, 6)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn.sinkhorn_solve_batched_cuda(C, log_a, log_b, table, 60)
    with pytest.raises(ValueError, match="shape"):
        sinkhorn.sinkhorn_solve_batched_cuda(C[0], log_a, log_b, table, 60)
    wide = torch.zeros(2, 4, sinkhorn.MAX_ANNEAL_COLUMNS + 1)
    with pytest.raises(ValueError, match="unsupported"):
        sinkhorn.sinkhorn_solve_batched_cuda(
            wide, log_a[:, :4], torch.zeros(2, wide.shape[2]), table, 60)
    with pytest.raises(ValueError, match="stages"):
        sinkhorn.sinkhorn_solve_batched_cuda(C, log_a, log_b, [], 60)
    with pytest.raises(ValueError, match="iters"):
        sinkhorn.sinkhorn_solve_batched_cuda(C, log_a, log_b, table, 1.5)
    with pytest.raises(ValueError, match="B, M, N"):
        sinkhorn_solve_batched_ref(C[0], log_a[0], log_b[0], table, 60)
    meta = [t.to("meta") for t in (C, log_a, log_b)]
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        ops.sinkhorn_solve_batched(*meta, table, 60)


# --- The warm-started solve with a convergence exit -------------------------

def _adaptive_case(M, N, seed, drift=0.0):
    """A round's solve inputs at M rows (M - 1 jobs and the dummy row):
    normalized costs with forbidden arcs at BIG, prepared by the port's
    device stage on the CPU. ``drift`` multiplies the raw costs by
    ``1 + drift * noise`` (a drifted next round). Returns torch tensors."""
    from repro_torch.core import round as port_round
    rng = np.random.default_rng(seed)
    jobs = M - 1
    cost = rng.random((jobs, N)) * 10
    allowed = rng.random((jobs, N)) > 0.2
    allowed[np.arange(jobs), rng.integers(0, N, jobs)] = True
    cap = np.full(N, jobs // N + 2, np.float32)
    noise = np.random.default_rng(seed + 1).standard_normal(cost.shape)
    cost = cost * (1 + drift * noise)
    C, log_a, log_b, _, _ = port_round._prepare_device(
        torch.from_numpy(cost.astype(np.float32)), torch.from_numpy(allowed),
        torch.from_numpy(cap), torch.ones(jobs, dtype=torch.bool))
    return C, log_a, log_b


def _ref_adaptive(C, log_a, log_b, g0, **kw):
    from repro.core.solvers import jax_solver
    f, g, eps, used = jax_solver._sinkhorn_log_adaptive_impl(
        jnp.asarray(C.numpy()), jnp.asarray(log_a.numpy()),
        jnp.asarray(log_b.numpy()), jnp.asarray(g0.numpy()),
        jnp.float32(jax_solver.SINKHORN_TOL), **kw)
    return np.asarray(f), np.asarray(g), np.asarray(eps), int(used)


COLD = dict(eps0=0.5, eps_min=0.005, iters=60, anneal_stages=6)
WARM = dict(eps0=0.005, eps_min=0.005, iters=360, anneal_stages=1)


@pytest.mark.parametrize("M,N", [(64, 6), (256, 40), (512, 40)])
def test_adaptive_solve_matches_reference(M, N):
    """``torch_solver._sinkhorn_log_adaptive_impl`` against the reference's
    ``_sinkhorn_log_adaptive_impl``: cold (6 x 60 from g = 0), then warm (one
    final-eps stage capped at 360) on a drifted instance from the cold
    solve's g. Duals within SOLVE_ATOL, iteration counts equal, the same
    float32 eps; the kernel's plain loop is bitwise the solver's."""
    from repro.core.solvers import jax_solver
    from repro_torch.core.solvers import torch_solver
    from repro_torch.kernels.sinkhorn.ref import sinkhorn_solve_adaptive_ref
    assert torch_solver.SINKHORN_TOL == jax_solver.SINKHORN_TOL
    C, log_a, log_b = _adaptive_case(M, N, seed=M + N)
    g0 = torch.zeros(N)
    for kw, case in ((COLD, (C, log_a, log_b)),
                     (WARM, _adaptive_case(M, N, seed=M + N, drift=0.03))):
        f_j, g_j, eps_j, used_j = _ref_adaptive(*case, g0, **kw)
        before = sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES
        f, g, eps, used = torch_solver._sinkhorn_log_adaptive_impl(
            *case, g0, torch_solver.SINKHORN_TOL, **kw)
        assert sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES == before
        assert used.dtype == torch.int32 and int(used) == used_j
        assert 0 < used_j < kw["iters"] * kw["anneal_stages"]
        np.testing.assert_allclose(f.numpy(), f_j, atol=SOLVE_ATOL)
        np.testing.assert_allclose(g.numpy(), g_j, atol=SOLVE_ATOL)
        assert eps.dtype == torch.float32 and float(eps) == float(eps_j)
        table = torch_solver.eps_schedule(
            kw["eps0"], kw["eps_min"], kw["anneal_stages"]).tolist()
        f_r, g_r, used_r = sinkhorn_solve_adaptive_ref(
            *case, g0, torch_solver.SINKHORN_TOL, table, kw["iters"])
        assert torch.equal(f_r, f) and torch.equal(g_r, g)
        assert int(used_r) == int(used)
        f_o, g_o, used_o = ops.sinkhorn_solve_adaptive(
            *case, g0, torch_solver.SINKHORN_TOL, table, kw["iters"])
        assert torch.equal(f_o, f) and torch.equal(g_o, g)
        assert int(used_o) == int(used)
        g0 = torch.from_numpy(g_j.copy())  # the warm start is the cold g
    assert used_j < 360                    # the warm stage converged


def test_adaptive_schedule_is_the_references_float32():
    """The eps of each stage, as the adaptive solve runs it, bit for bit the
    reference's float32 ``eps0 * decay ** arange(stages)``."""
    import jax
    from repro_torch.core.solvers import torch_solver
    for eps0, eps_min, stages in ((0.5, 0.005, 6), (0.005, 0.005, 1),
                                  (1.0, 0.01, 4)):
        decay = (eps_min / eps0) ** (1.0 / max(stages - 1, 1))
        ref = jax.jit(lambda: eps0 * decay ** jnp.arange(stages))()
        got = torch_solver.eps_schedule(eps0, eps_min, stages).numpy()
        assert got.tobytes() == np.asarray(ref, np.float32).tobytes()


def test_adaptive_solve_exits_on_nan_as_the_reference():
    """A NaN change of g exits a stage, as ``NaN > tol`` is false in JAX:
    every stage runs exactly one iteration on a cost with a NaN."""
    from repro_torch.core.solvers import torch_solver
    C, log_a, log_b = _adaptive_case(16, 6, seed=3)
    C[2, 1] = float("nan")
    g0 = torch.zeros(6)
    _, _, _, used_j = _ref_adaptive(C, log_a, log_b, g0, **COLD)
    _, g, _, used = torch_solver._sinkhorn_log_adaptive_impl(
        C, log_a, log_b, g0, torch_solver.SINKHORN_TOL, **COLD)
    assert int(used) == used_j == COLD["anneal_stages"]
    assert torch.isnan(g).any()


def test_adaptive_wrapper_rejects_what_the_launch_does_not_take():
    """The adaptive launch's binding raises before any build or launch on
    host memory, a bad shape, a g0 of the wrong width or a schedule it
    cannot hold; the dispatch in ops is the only route from a CPU tensor to
    the plain loop."""
    C, log_a, log_b = _adaptive_case(128, 6, seed=0)
    g0 = torch.zeros(6)
    table = [0.005]
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn.sinkhorn_solve_adaptive_cuda(C, log_a, log_b, g0, 1e-5,
                                              table, 360)
    with pytest.raises(ValueError, match="shape"):
        sinkhorn.sinkhorn_solve_adaptive_cuda(C[:, None], log_a, log_b, g0,
                                              1e-5, table, 360)
    wide = torch.zeros(4, sinkhorn.MAX_ANNEAL_COLUMNS + 1)
    with pytest.raises(ValueError, match="unsupported"):
        sinkhorn.sinkhorn_solve_adaptive_cuda(
            wide, log_a[:4], torch.zeros(wide.shape[1]),
            torch.zeros(wide.shape[1]), 1e-5, table, 360)
    with pytest.raises(ValueError, match="stages"):
        sinkhorn.sinkhorn_solve_adaptive_cuda(C, log_a, log_b, g0, 1e-5, [],
                                              360)
    with pytest.raises(ValueError, match="iters"):
        sinkhorn.sinkhorn_solve_adaptive_cuda(C, log_a, log_b, g0, 1e-5,
                                              table, -1)
    meta = [t.to("meta") for t in (C, log_a, log_b, g0)]
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        ops.sinkhorn_solve_adaptive(*meta, 1e-5, table, 360)
