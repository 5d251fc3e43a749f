"""The port's solver backends against the JAX package's on the same
instances: ``torch`` vs ``jax``, ``fused`` vs ``fused``. Assignments,
statuses and float64 objectives must be equal; duals within 1e-4."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import round as ref_round
from repro.core import solvers as ref_solvers
from repro.core.solvers import jax_solver
from repro_torch.core import round as port_round
from repro_torch.core import solvers
from repro_torch.core.solvers import torch_solver

# Dual potentials: float32 on both sides, logsumexp and exp/log from two
# libraries; measured <= 3.5e-6 on the CPU.
DUAL_ATOL = 1e-4


def _rand_instance(rng, M, N):
    """The instances of tests/test_round.py."""
    cost = rng.random((M, N)) * 10
    allowed = rng.random((M, N)) > 0.2
    allowed[np.arange(M), rng.integers(0, N, M)] = True   # no empty rows
    cap = np.full(N, (M + N) // N + 1)
    return cost, allowed, cap


def _assert_same(r_ref, r_port, backend):
    assert r_port.backend == backend
    assert r_ref.status == r_port.status
    np.testing.assert_array_equal(r_ref.assign, r_port.assign)
    assert r_ref.objective == r_port.objective
    np.testing.assert_array_equal(r_ref.penalties, r_port.penalties)


def test_buckets_match_reference():
    assert torch_solver.BUCKETS == jax_solver.BUCKETS
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for rows in [1, 4, 5, 100, 4097, 16384, 16385, 40000]:
            assert torch_solver.bucket_for(rows) == jax_solver.bucket_for(rows)


@pytest.mark.parametrize("M,N", [(3, 4), (60, 6), (500, 6), (200, 8)])
def test_sinkhorn_duals_match_reference(M, N):
    rng = np.random.default_rng(M + N)
    cost, allowed, cap = _rand_instance(rng, M, N)
    c_eff, mask = torch_solver._effective(cost, allowed, False, None, None,
                                          10.0)
    pad = torch_solver.bucket_for(M + 1) - (M + 1)
    C, log_a, log_b, _ = torch_solver._prepare(c_eff, mask, cap, pad)
    f_j, g_j, eps_j = jax_solver._sinkhorn_log_impl(
        jnp.asarray(C), jnp.asarray(log_a), jnp.asarray(log_b), 0.5, 0.005,
        60, 6)
    f_t, g_t, eps_t = torch_solver._sinkhorn_log_impl(
        torch.from_numpy(C), torch.from_numpy(log_a),
        torch.from_numpy(log_b), 0.5, 0.005, 60, 6)
    assert float(eps_t) == float(eps_j)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=DUAL_ATOL)
    np.testing.assert_allclose(f_t.numpy()[:M + 1], np.asarray(f_j)[:M + 1],
                               atol=DUAL_ATOL)


@pytest.mark.parametrize("M,N", [(3, 4), (10, 5), (60, 6), (200, 8)])
def test_hard_backends_match_reference(M, N):
    rng = np.random.default_rng(M * 1000 + N)
    cost, allowed, cap = _rand_instance(rng, M, N)
    _assert_same(ref_solvers.solve(cost, allowed, cap, backend="jax"),
                 solvers.solve(cost, allowed, cap, backend="torch",
                               device="cpu"), "torch")
    _assert_same(ref_solvers.solve(cost, allowed, cap, backend="fused"),
                 solvers.solve(cost, allowed, cap, backend="fused",
                               device="cpu"), "fused")


@pytest.mark.parametrize("M,N", [(6, 4), (40, 5)])
def test_soft_backends_match_reference(M, N):
    rng = np.random.default_rng(M * 7 + N)
    cost, allowed, cap = _rand_instance(rng, M, N)
    overrun = rng.random((M, N)) * 3
    tol = rng.random(M) * 2
    kw = dict(soften=True, overrun=overrun, tol=tol, sigma=10.0)
    _assert_same(ref_solvers.solve(cost, allowed, cap, backend="jax", **kw),
                 solvers.solve(cost, allowed, cap, backend="torch",
                               device="cpu", **kw), "torch")
    _assert_same(ref_solvers.solve(cost, allowed, cap, backend="fused", **kw),
                 solvers.solve(cost, allowed, cap, backend="fused",
                               device="cpu", **kw), "fused")


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_infeasible_matches_reference(backend):
    ref_backend = "jax" if backend == "torch" else "fused"
    cost = np.ones((4, 2))
    allowed = np.ones((4, 2), bool)
    for cap, row0 in ((np.array([1, 1]), True), (np.array([4, 4]), False)):
        allowed[0] = row0      # a row with no allowed arc is infeasible too
        r_ref = ref_solvers.solve(cost, allowed, cap, backend=ref_backend)
        r_port = solvers.solve(cost, allowed, cap, backend=backend,
                               device="cpu")
        assert r_port.status == r_ref.status == "infeasible"
        np.testing.assert_array_equal(r_port.assign, r_ref.assign)


@pytest.mark.parametrize("M,N", [(10, 5), (60, 6)])
def test_fused_kernel_order_matches_pallas_path(M, N):
    """impl "kernel" on a CPU tensor runs the kernel's plain version in the
    kernel's order (f <- g, then g <- f): its decisions equal the
    reference's Pallas path (interpret mode)."""
    rng = np.random.default_rng(M * 1000 + N)
    cost, allowed, cap = _rand_instance(rng, M, N)
    r_ref = ref_round.fused_solve(cost, allowed, cap, sinkhorn_impl="pallas",
                                  interpret=True)
    r_port = port_round.fused_solve(cost, allowed, cap,
                                    sinkhorn_impl="kernel", device="cpu")
    _assert_same(r_ref, r_port, "fused")


def test_fused_rejects_unknown_impl():
    cost, allowed, cap = _rand_instance(np.random.default_rng(0), 5, 3)
    with pytest.raises(ValueError, match="sinkhorn_impl"):
        port_round.fused_solve(cost, allowed, cap, sinkhorn_impl="xla",
                               device="cpu")


# --- solve_many: queued windows in one batched Sinkhorn a bucket -------------

def _random_instance(rng):
    """The instances of tests/test_scenarios.py's solve_many tests."""
    M = int(rng.integers(3, 30))
    N = int(rng.integers(2, 6))
    cost = rng.random((M, N)) * 10
    allowed = rng.random((M, N)) < 0.85
    allowed[np.arange(M), rng.integers(0, N, M)] = True
    cap = rng.integers(1, max(M // max(N - 1, 1), 2), N)
    while cap.sum() < M:
        cap[rng.integers(0, N)] += 1
    return cost, allowed, cap


@pytest.mark.parametrize("soften", [False, True])
def test_solve_many_matches_single_solves(soften):
    """Each instance of a batched ``solve_many`` equals its own ``solve``
    (same decisions, same float64 objective: the batched Sinkhorn is the
    single one over a leading axis, bitwise on the CPU), and the
    reference's ``solve_many`` over ``jax``; capacities hold."""
    rng = np.random.default_rng(11 + soften)
    insts = [_random_instance(rng) for _ in range(12)]
    costs, alloweds, caps = map(list, zip(*insts))
    kw = {}
    if soften:
        kw = dict(overruns=[rng.random(c.shape) * 3 for c in costs],
                  tols=[rng.random(c.shape[0]) * 2 for c in costs])
    batched = solvers.solve_many(costs, alloweds, caps, backend="torch",
                                 soften=soften, device="cpu", **kw)
    ref = ref_solvers.solve_many(costs, alloweds, caps, backend="jax",
                                 soften=soften, **kw)
    assert len(batched) == len(insts) == len(ref)
    for k, (c, a, p) in enumerate(insts):
        single = solvers.solve(c, a, p, backend="torch", device="cpu",
                               soften=soften,
                               overrun=kw.get("overruns", [None] * 12)[k],
                               tol=kw.get("tols", [None] * 12)[k])
        _assert_same(single, batched[k], "torch")
        _assert_same(ref[k], batched[k], "torch")
        if batched[k].feasible:
            assert (np.bincount(batched[k].assign, minlength=len(p))
                    <= p).all()


def test_solve_many_loop_fallback_backend():
    rng = np.random.default_rng(13)
    insts = [_random_instance(rng) for _ in range(4)]
    costs, alloweds, caps = map(list, zip(*insts))
    rs = solvers.solve_many(costs, alloweds, caps, backend="flow")
    for (c, a, p), r in zip(insts, rs):
        ref = solvers.solve(c, a, p, backend="flow")
        assert r.status == ref.status and r.backend == "flow"
        if r.feasible:
            assert r.objective == pytest.approx(ref.objective, abs=1e-9)
    with pytest.raises(KeyError, match="'torch'"):
        solvers.solve_many(costs, alloweds, caps, backend="jax")


def test_solve_many_infeasible_and_default_backend():
    """An infeasible instance short-circuits inside a batch; the default
    backend is ``torch`` (the reference's ``jax``)."""
    import inspect
    rng = np.random.default_rng(17)
    cost, allowed, cap = _random_instance(rng)
    short = np.ones_like(cap)
    short[0] = 0
    out = solvers.solve_many([cost, cost], [allowed, allowed], [cap, short],
                             device="cpu")
    assert out[0].feasible and out[1].status == "infeasible"
    assert inspect.signature(solvers.solve_many).parameters[
        "backend"].default == "torch"


def test_intercepted_hook_sees_every_solve_and_nests():
    """A thread's hook is offered each ``solve`` first, device included;
    ``None`` declines to the backend; the innermost hook wins; other
    threads are untouched."""
    import threading
    cost, allowed, cap = _rand_instance(np.random.default_rng(2), 6, 3)
    seen = []
    canned = solvers.solve(cost, allowed, cap, backend="flow")

    def outer(*args, **kw):
        seen.append(("outer", kw["backend"], kw["device"]))
        return None

    def inner(*args, **kw):
        seen.append(("inner", kw["backend"], kw["device"]))
        return canned
    with solvers.intercepted(outer):
        r = solvers.solve(cost, allowed, cap, backend="fused", device="cpu")
        assert r.backend == "fused"
        with solvers.intercepted(inner):
            assert solvers.solve(cost, allowed, cap, backend="torch",
                                 device="cpu") is canned
            other = []
            t = threading.Thread(target=lambda: other.append(solvers.solve(
                cost, allowed, cap, backend="flow")))
            t.start()
            t.join()
            assert other[0] is not canned
        solvers.solve(cost, allowed, cap, backend="flow")
    assert seen == [("outer", "fused", "cpu"), ("inner", "torch", "cpu"),
                    ("outer", "flow", None)]
