"""The port's batched cell execution against the JAX package's (the
counterpart of tests/test_device_executor.py): ``fused_round_batch``
bitwise equal per cell to ``fused_solve`` and equal in decisions to the
reference's ``fused_round_batch``, request grouping (property-tested), the
``device`` executor's grammar, classification, barrier and rows, all on
the CPU. The cell-batched kernel launch on the card is in
test_torch_cuda.py."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import experiments as ref_experiments
from repro.core import round as ref_round
from repro_torch import experiments
from repro_torch.core import round as port_round
from repro_torch.core.round import (SolveRequest, fused_round_batch,
                                    group_requests)
from repro_torch.core.solvers.torch_solver import bucket_for
from repro_torch.experiments.executor import DeviceExecutor, _CellBatcher
from repro_torch.experiments.plan import Cell
from test_torch_forecast_round import MAPE_RTOL
from test_torch_policy import schema_tuples


def _request(rng, M=12, C=4, soften=False, dtype=np.float64):
    """The reference test's requests."""
    cost = rng.uniform(1.0, 5.0, (M, C)).astype(dtype)
    allowed = rng.random((M, C)) > 0.2
    allowed[:, 0] = True                     # every job has an arc
    return SolveRequest(
        cost=cost, allowed=allowed, capacity=np.full(C, M, np.int64),
        soften=soften, overrun=rng.uniform(0.0, 2.0, (M, C)),
        tol=rng.uniform(0.0, 1.0, M), sigma=8.0)


def _ref_request(r):
    return ref_round.SolveRequest(
        cost=r.cost, allowed=r.allowed, capacity=r.capacity, soften=r.soften,
        overrun=r.overrun, tol=r.tol, sigma=r.sigma)


def _single(r, **kw):
    return port_round.fused_solve(
        r.cost, r.allowed, r.capacity, soften=r.soften, overrun=r.overrun,
        tol=r.tol, sigma=r.sigma, device="cpu", **kw)


def _assert_same_result(a, b):
    assert a.status == b.status
    assert a.objective == b.objective        # bit-identical, not approx
    np.testing.assert_array_equal(a.assign, b.assign)
    np.testing.assert_array_equal(a.penalties, b.penalties)


def _mixed_requests(seed=0):
    """Mixed sizes (buckets 16 to 32) and mixed hard/soft, one call."""
    rng = np.random.default_rng(seed)
    return [_request(rng, M=10 + 3 * k, soften=(k % 2 == 0))
            for k in range(6)]


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_batch_matches_single_cell_fused_solve_bitwise(impl):
    """Every cell's decisions bitwise those of a per-cell ``fused_solve``,
    through both Sinkhorn orders on the CPU (the ``kernel`` one is the
    batched kernel's plain loop)."""
    reqs = _mixed_requests()
    for r in reqs:
        r.sinkhorn_impl = impl
    batch = fused_round_batch(reqs, devices=1, device="cpu")
    for r, b in zip(reqs, batch):
        assert b.backend == "fused"
        _assert_same_result(_single(r, sinkhorn_impl=impl), b)


def test_batched_body_is_bitwise_the_single_body():
    """The device half itself: a group's [B, ...] body gives, cell for
    cell, the normalized costs and plans of the single-cell body."""
    rng = np.random.default_rng(7)
    reqs = [_request(rng, M=m, soften=s) for m, s in
            ((9, False), (11, False), (14, False))]
    bucket = bucket_for(reqs[0].cost.shape[0] + 1)
    packed = [port_round._pack(r.cost, r.allowed, r.overrun, r.tol,
                               bucket - 1 - r.cost.shape[0]) for r in reqs]
    caps = [r.capacity.astype(np.float32) for r in reqs]
    for impl in ("torch", "kernel"):
        kw = dict(soften=False, sigma=8.0, impl=impl)
        Cn_b, X_b = port_round._assignment_body(
            torch.from_numpy(np.stack([p[0] for p in packed])),
            torch.from_numpy(np.stack([p[1] for p in packed])),
            torch.from_numpy(np.stack(caps)), **kw)
        for b, (arcs, tolv) in enumerate(packed):
            Cn, X = port_round._assignment_body(
                torch.from_numpy(arcs), torch.from_numpy(tolv),
                torch.from_numpy(caps[b]), **kw)
            assert torch.equal(Cn_b[b], Cn) and torch.equal(X_b[b], X)


def test_batch_matches_reference_batch():
    """Assignments and statuses equal the reference's ``fused_round_batch``
    on the same requests (its default ``xla`` order against the port's
    CPU default ``torch``)."""
    reqs = _mixed_requests(seed=5)
    port = fused_round_batch(reqs, device="cpu")
    ref = ref_round.fused_round_batch([_ref_request(r) for r in reqs])
    for a, b in zip(ref, port):
        assert a.status == b.status
        np.testing.assert_array_equal(a.assign, b.assign)
        assert a.objective == b.objective
        np.testing.assert_array_equal(a.penalties, b.penalties)


def test_batch_devices_validation():
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError, match="exceeds"):
        fused_round_batch([_request(rng)], devices=2, device="cpu")
    assert port_round.visible_devices(torch.device("cpu")) == 1


def test_batch_infeasible_requests_short_circuit():
    """Per-request infeasibility (capacity shortfall, fully masked row)
    resolves exactly like ``fused_solve`` without touching the device."""
    rng = np.random.default_rng(3)
    good = _request(rng, M=8)
    short = _request(rng, M=8)
    short.capacity = np.full(4, 1, np.int64)         # sum 4 < 8 jobs
    masked = _request(rng, M=8)
    masked.allowed = np.zeros((8, 4), bool)
    out = fused_round_batch([good, short, masked], devices=1, device="cpu")
    assert out[0].feasible
    assert out[1].status == "infeasible" and not out[1].feasible
    assert out[2].status == "infeasible"
    for req, res in zip([short, masked], out[1:]):
        _assert_same_result(_single(req), res)
    assert fused_round_batch([short], device="cpu")[0].status == "infeasible"


@given(st.lists(st.tuples(st.integers(1, 40),      # rows M
                          st.integers(2, 5),       # cols C
                          st.booleans(),           # soften
                          st.sampled_from([np.float32, np.float64])),
                min_size=1, max_size=16))
@settings(max_examples=50, deadline=None)
def test_group_requests_never_mixes_buckets_or_dtypes(shapes):
    rng = np.random.default_rng(5)
    reqs = [_request(rng, M=m, C=c, soften=s, dtype=dt)
            for m, c, s, dt in shapes]
    groups = group_requests(reqs)
    seen = sorted(i for idxs in groups.values() for i in idxs)
    assert seen == list(range(len(reqs)))     # exact cover, no dup/loss
    for key, idxs in groups.items():
        buckets = {bucket_for(reqs[i].cost.shape[0] + 1) for i in idxs}
        cols = {reqs[i].cost.shape[1] for i in idxs}
        dtypes = {np.asarray(reqs[i].cost).dtype for i in idxs}
        softs = {reqs[i].soften for i in idxs}
        assert len(buckets) == len(cols) == len(dtypes) == len(softs) == 1
        assert (bucket_for(reqs[idxs[0]].cost.shape[0] + 1),
                reqs[idxs[0]].cost.shape[1]) == key[:2]
    # The same partition as the reference's (its key adds ``interpret``).
    ref = ref_round.group_requests([_ref_request(r) for r in reqs])
    assert sorted(groups.values()) == sorted(ref.values())


# ---------------------------------------------------------------------------
# The device executor backend
# ---------------------------------------------------------------------------

def test_device_executor_spec_grammar_matches_reference():
    ex = experiments.get_executor("device[devices=2,max_cells=8]")
    assert (ex.devices, ex.max_cells) == (2, 8)
    ex = experiments.get_executor("device")
    assert (ex.devices, ex.max_cells) == (0, 0)
    assert isinstance(ex, experiments.DeviceExecutor)
    assert "device" in experiments.list_executors()
    assert schema_tuples(experiments.executor_schema("device")) == \
        schema_tuples(ref_experiments.executor_schema("device"))


@pytest.mark.parametrize("pol,want", [
    ("waterwise[backend=fused]", True), ("waterwise", False),
    ("waterwise[backend=flow]", False), ("waterwise-forecast", False),
    ("waterwise-forecast[backend=fused]", False), ("baseline", False),
    ("no-such-policy", False)])
def test_device_executor_batchable_classification(pol, want):
    from repro.experiments.executor import DeviceExecutor as RefDevice
    from repro.experiments.plan import Cell as RefCell
    assert DeviceExecutor._batchable(Cell(scenario="nominal", policy=pol,
                                          seed=0)) is want
    assert RefDevice._batchable(RefCell(scenario="nominal", policy=pol,
                                        seed=0)) is want


def test_cell_batcher_flushes_on_finish_and_broadcasts_errors():
    """Barrier liveness: a finishing thread flushes waiters; a flush
    exception reaches every waiting submit."""
    import threading
    calls = []

    def flush(reqs):
        calls.append(len(reqs))
        return [r * 10 for r in reqs]

    b = _CellBatcher(flush)
    b.register()
    assert b.submit(7) == 70                 # active=1 → immediate flush
    b.finish()
    assert calls == [1]

    # Two threads: the first waits until the second, which submits nothing,
    # finishes — its finish flushes the first's wave.
    b = _CellBatcher(flush)
    b.register()
    b.register()
    out = []
    t = threading.Thread(target=lambda: out.append(b.submit(3)))
    t.start()
    b.finish()
    t.join(timeout=10)
    assert out == [30] and calls == [1, 1]

    def boom(reqs):
        raise RuntimeError("device exploded")

    b = _CellBatcher(boom)
    b.register()
    with pytest.raises(RuntimeError, match="device exploded"):
        b.submit(1)
    b.finish()


def test_cell_batcher_stress_lockstep():
    """More threads than cores, each submitting its own number of requests
    with a short switch interval: every submit gets its own result, every
    flush holds at most one request a thread (the barrier is lockstep),
    and no request is lost or served twice."""
    import sys
    import threading
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 25, 24)
    flushes = []

    def flush(reqs):
        owners = [t for t, _ in reqs]
        assert len(owners) == len(set(owners))
        flushes.append(len(reqs))
        return [(t, k * 10) for t, k in reqs]

    b = _CellBatcher(flush)
    got = {t: [] for t in range(len(counts))}

    def cell(t):
        try:
            for k in range(counts[t]):
                got[t].append(b.submit((t, k)))
        finally:
            b.finish()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=cell, args=(t,), daemon=True)
                   for t in range(len(counts))]
        for t in threads:
            b.register()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for t, n in enumerate(counts):
        assert got[t] == [(t, k * 10) for k in range(n)]
    assert sum(flushes) == counts.sum()
    assert len(flushes) == counts.max()      # one flush a wave


PLAN = dict(
    scenarios=["diurnal[days=0.05,jobs_per_day=20000.0,tolerance=0.5]",
               "nominal[days=0.05,jobs_per_day=20000.0]"],
    policies=["waterwise[backend=fused]", "waterwise-forecast"])
# Host wall times; utilization is compared exactly here (one engine run).
WALL = ("wall_s", "mean_solve_ms")


@pytest.fixture(scope="module")
def device_rows():
    plan = experiments.ExperimentPlan.build(**PLAN)
    return (plan.run("serial", device="cpu"),
            plan.run("device", device="cpu"))


def test_device_executor_matches_serial_rows(device_rows):
    """Acceptance: ``device`` rows equal ``serial`` rows on the reference's
    2-scenario × 2-policy plan — including the forecast-driven policy,
    which cannot batch and runs on the serial path."""
    serial, device = device_rows
    assert len(serial) == len(device) == 4
    for s, d in zip(serial, device):
        assert not s["error"] and not d["error"]
        for key in s:
            if key in WALL or key.startswith("_"):
                continue
            assert s[key] == d[key], f"column {key!r}: {s[key]} != {d[key]}"


def test_device_rows_match_reference_device_rows(device_rows):
    """The same plan through the reference's ``device`` executor: every
    non-timing column equal (its forecast row runs ``backend=jax``, the
    port's ``torch``), the Holt-Winters forecast MAPE within MAPE_RTOL."""
    _, device = device_rows
    ref = ref_experiments.ExperimentPlan.build(**PLAN).run("device")
    for r, d in zip(ref, device):
        assert not r["error"] and not d["error"]
        assert set(r) == set(d)
        for key in r:
            if key in WALL or key.startswith("_"):
                continue
            if key == "forecast_mape":
                assert d[key] == pytest.approx(r[key], rel=MAPE_RTOL)
            else:
                assert r[key] == d[key], \
                    f"column {key!r}: {r[key]} != {d[key]}"


def test_device_executor_batches_the_cells_solves(monkeypatch):
    """The batchable cells' solves reach ``fused_round_batch`` in waves of
    several cells, and no fused solve runs per cell."""
    waves = []
    real = port_round.fused_round_batch

    def spy(reqs, devices=1, device=None):
        waves.append(len(reqs))
        return real(reqs, devices=devices, device=device)
    monkeypatch.setattr(port_round, "fused_round_batch", spy)
    from repro_torch.core import solvers
    single = []
    real_single = solvers.get_solver("fused")
    monkeypatch.setitem(solvers._REGISTRY, "fused",
                        lambda *a, **k: single.append(1)
                        or real_single(*a, **k))
    plan = experiments.ExperimentPlan.build(
        ["nominal[days=0.01,jobs_per_day=20000.0]"],
        ["waterwise[backend=fused]", "waterwise[backend=fused,lam_h2o=0.7]",
         "baseline"], seeds=[0, 1])
    rows = plan.run("device", device="cpu")
    assert all(not r["error"] for r in rows)
    assert max(waves) == 4 and sum(waves) > len(waves)
    assert not single
