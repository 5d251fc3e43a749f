"""The forecast round's solve in the port against the JAX package: the
temporal planner and Program 2 (``fused_temporal_round``) on the
instances of tests/test_round.py. The whole round end to end is in
tests/test_torch_forecast_round.py."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import footprint as ref_footprint
from repro.core import problem as ref_problem
from repro.core import round as ref_round
from repro.core import solvers as ref_solvers
from repro.core import telemetry as ref_telemetry
from repro.forecast.planner import build_temporal_plan as ref_plan
from repro_torch import convert
from repro_torch.core import footprint, problem
from repro_torch.core import round as port_round
from repro_torch.core import solvers
from repro_torch.forecast.planner import build_temporal_plan

# Priced costs in float32, between the two programs: XLA on the CPU
# contracts a*b+c into one FMA where PyTorch rounds twice (measured
# <= 2.1e-7 relative); the reference's own bound for its float32 prices
# against the float64 host planner.
PRICE_RTOL = 2e-6


@pytest.fixture(scope="module")
def teles():
    ref = ref_telemetry.generate(days=6, seed=0)
    return ref, convert.telemetry_from_reference(ref)


def _case(ref_tele, tele, M, S=8, R=5, tolerance=4.0):
    """The instances of tests/test_round.py, built on both sides."""
    rng = np.random.default_rng(M)
    offsets = np.arange(S) * 1800.0
    kw = [dict(job_id=i, home_region=i % R, submit_time_s=0.0,
               exec_time_s=600.0 + 10 * i, energy_kwh=0.05,
               tolerance=tolerance) for i in range(M)]
    cap = np.full(R, max(2, M // R + 1))
    ci = rng.random((M, S, R)) * 300 + 50
    ewif = rng.random((M, S, R)) * 2 + 0.5
    wue = rng.random((M, S, R)) * 1 + 0.2
    sides = []
    for mod_problem, mod_fp, t in ((ref_problem, ref_footprint, ref_tele),
                                   (problem, footprint, tele)):
        snap = t.at(0.0)
        server = mod_fp.m5_metal()
        jobs = [mod_problem.Job(**k) for k in kw]
        inst = mod_problem.build(jobs, t, 0.0, cap, server, snap=snap)
        sides.append((inst, snap, server))
    return sides, offsets, ci, ewif, wue


def _args(side, offsets, ci, ewif, wue, lam_co2, lam_h2o):
    inst, snap, server = side
    return (inst, 0.0, ci, ewif, wue, snap["pue"], snap["wsf"], offsets,
            server, lam_co2, lam_h2o)


@pytest.mark.parametrize("lam_co2,lam_h2o", [(0.5, 0.5), (1.0, 0.0),
                                             (0.0, 1.0)])
@pytest.mark.parametrize("M", [3, 17, 60])
def test_temporal_plan_matches_reference(teles, lam_co2, lam_h2o, M):
    """The unfused path's planner is a numpy copy: equal arrays."""
    (ref_side, side), offsets, ci, ewif, wue = _case(*teles, M)
    p_ref = ref_plan(*_args(ref_side, offsets, ci, ewif, wue, lam_co2,
                            lam_h2o), lam_ref=0.1,
                     co2_ref=np.linspace(0.2, 1.0, 5),
                     h2o_ref=np.linspace(1.0, 0.3, 5))
    p = build_temporal_plan(*_args(side, offsets, ci, ewif, wue, lam_co2,
                                   lam_h2o), lam_ref=0.1,
                            co2_ref=np.linspace(0.2, 1.0, 5),
                            h2o_ref=np.linspace(1.0, 0.3, 5))
    for k in ("cost", "allowed", "capacity", "slot_offsets"):
        np.testing.assert_array_equal(getattr(p, k), getattr(p_ref, k))


@pytest.mark.parametrize("lam_co2,lam_h2o", [(0.5, 0.5), (1.0, 0.0),
                                             (0.0, 1.0)])
@pytest.mark.parametrize("M", [3, 17, 60])
def test_fused_temporal_round_matches_reference(teles, lam_co2, lam_h2o, M):
    """Program 2 with impl ``torch`` (the twin of the reference's default
    XLA loop) against the reference's: equal assignment, status, capacity
    and re-derived allowed arrays; costs and objective to PRICE_RTOL."""
    (ref_side, side), offsets, ci, ewif, wue = _case(*teles, M)
    extra = dict(lam_ref=0.1, co2_ref=np.linspace(0.2, 1.0, 5),
                 h2o_ref=np.linspace(1.0, 0.3, 5))
    c_r, a_r, cap_r, r_ref = ref_round.fused_temporal_round(
        *_args(ref_side, offsets, ci, ewif, wue, lam_co2, lam_h2o), **extra)
    c, a, cap, r = port_round.fused_temporal_round(
        *_args(side, offsets, ci, ewif, wue, lam_co2, lam_h2o), **extra,
        sinkhorn_impl="torch", device="cpu")
    assert r.backend == "fused" and r.status == r_ref.status
    np.testing.assert_array_equal(r.assign, r_ref.assign)
    assert r.objective == pytest.approx(r_ref.objective, rel=PRICE_RTOL)
    np.testing.assert_array_equal(cap, cap_r)
    np.testing.assert_array_equal(a, a_r)
    np.testing.assert_allclose(c, c_r, rtol=PRICE_RTOL)


@pytest.mark.parametrize("M", [3, 17])
def test_fused_temporal_round_kernel_order_matches_pallas_path(teles, M):
    """impl ``kernel`` on CPU tensors (the kernel's plain version in the
    kernel's update order) against the reference's Pallas path
    (interpret mode)."""
    (ref_side, side), offsets, ci, ewif, wue = _case(*teles, M)
    _, a_r, _, r_ref = ref_round.fused_temporal_round(
        *_args(ref_side, offsets, ci, ewif, wue, 0.5, 0.5),
        sinkhorn_impl="pallas", interpret=True)
    _, a, _, r = port_round.fused_temporal_round(
        *_args(side, offsets, ci, ewif, wue, 0.5, 0.5),
        sinkhorn_impl="kernel", device="cpu")
    assert r.status == r_ref.status
    np.testing.assert_array_equal(r.assign, r_ref.assign)
    np.testing.assert_array_equal(a, a_r)


def test_fused_temporal_round_rejects_unknown_impl(teles):
    (_, side), offsets, ci, ewif, wue = _case(*teles, 9)
    args = _args(side, offsets, ci, ewif, wue, 0.5, 0.5)
    with pytest.raises(ValueError, match="sinkhorn_impl"):
        port_round.fused_temporal_round(*args, sinkhorn_impl="xla",
                                        device="cpu")


def test_unfused_temporal_round_matches_reference(teles):
    """backend ``torch`` on the planner's instance == the reference's
    ``jax`` backend."""
    (ref_side, side), offsets, ci, ewif, wue = _case(*teles, 17)
    p_ref = ref_plan(*_args(ref_side, offsets, ci, ewif, wue, 0.5, 0.5))
    p = build_temporal_plan(*_args(side, offsets, ci, ewif, wue, 0.5, 0.5))
    r_ref = ref_solvers.solve(p_ref.cost, p_ref.allowed, p_ref.capacity,
                              backend="jax")
    r = solvers.solve(p.cost, p.allowed, p.capacity, backend="torch",
                      device="cpu")
    assert r.status == r_ref.status
    np.testing.assert_array_equal(r.assign, r_ref.assign)


# --- want_plan: the priced tensors of the forecast round ---------------------

@pytest.mark.parametrize("M", [9, 40])
def test_fused_temporal_round_want_plan_matches_planner(teles, M):
    """``want_plan=True`` returns the priced cost and mask tensors of the
    device program: the mask equal to the host planner's and to the
    reference's ``want_plan`` mask, the costs on allowed arcs within
    PRICE_RTOL of both; the decisions are those without ``want_plan``."""
    (ref_side, side), offsets, ci, ewif, wue = _case(*teles, M)
    args = _args(side, offsets, ci, ewif, wue, 0.5, 0.5)
    plan = build_temporal_plan(*args)
    cost, allowed, cap_t, res = port_round.fused_temporal_round(
        *args, want_plan=True, device="cpu")
    assert cost.dtype == np.float64 and allowed.dtype == bool
    np.testing.assert_array_equal(allowed, plan.allowed)
    np.testing.assert_allclose(cost[allowed], plan.cost[plan.allowed],
                               rtol=PRICE_RTOL)
    r_cost, r_allowed, r_cap, _ = ref_round.fused_temporal_round(
        *_args(ref_side, offsets, ci, ewif, wue, 0.5, 0.5), want_plan=True)
    np.testing.assert_array_equal(allowed, r_allowed)
    np.testing.assert_allclose(cost[allowed], r_cost[r_allowed],
                               rtol=PRICE_RTOL)
    np.testing.assert_array_equal(cap_t, r_cap)
    _, _, _, plain = port_round.fused_temporal_round(*args, device="cpu")
    assert res.feasible and res.status == plain.status
    np.testing.assert_array_equal(res.assign, plain.assign)


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_fused_mask_never_admits_infeasible_slot(data):
    """Property (the reference's, through the port's ``want_plan`` mask):
    whatever the (budget, latency, offsets, guard) draw, an admitted (job,
    slot >= 1, region) arc satisfies offset + latency + guard <= slack
    budget, and slot 0 reproduces the instance's Eq-11 mask exactly."""
    from repro_torch.core import telemetry
    tele_p = telemetry.generate(days=1, seed=1)
    R = tele_p.num_regions
    M = data.draw(st.integers(1, 7), label="jobs")
    S = data.draw(st.integers(2, 6), label="slots")
    slot_s = data.draw(st.sampled_from([600.0, 1800.0, 3600.0]))
    guard_s = data.draw(st.sampled_from([0.0, 240.0, 900.0]))
    tolerance = data.draw(st.floats(0.1, 6.0), label="tolerance")
    server = footprint.m5_metal()
    rng = np.random.default_rng(data.draw(st.integers(0, 2**16)))
    jobs = [problem.Job(job_id=i, home_region=i % R, submit_time_s=0.0,
                        exec_time_s=float(rng.uniform(60, 4000)),
                        energy_kwh=0.05, tolerance=tolerance)
            for i in range(M)]
    cap = np.full(R, M + 1)
    snap = tele_p.at(0.0)
    inst = problem.build(jobs, tele_p, 0.0, cap, server, snap=snap)
    offsets = np.arange(S) * slot_s
    ci = rng.random((M, S, R)) * 300 + 1
    ewif = rng.random((M, S, R)) + 0.1
    wue = rng.random((M, S, R)) + 0.1
    _, allowed, _, _ = port_round.fused_temporal_round(
        inst, 0.0, ci, ewif, wue, snap["pue"], snap["wsf"], offsets, server,
        0.5, 0.5, guard_s=guard_s, want_plan=True, device="cpu")
    budget = np.array([j.slack_budget_s(0.0) for j in jobs])
    grid = allowed.reshape(M, S, R)
    np.testing.assert_array_equal(grid[:, 0, :], inst.allowed)
    need = offsets[None, 1:, None] + inst.latency[:, None, :] + guard_s
    admitted = grid[:, 1:, :]
    assert (need[admitted] <= budget[:, None, None]
            .repeat(S - 1, 1).repeat(R, 2)[admitted] + 1e-9).all()


# --- Offline queued-window replay through solve_many -------------------------

def test_replay_recorded_windows_matches_live():
    """A reactive run with ``record_windows=True`` (the reference test's
    cell): every window replayed through ``solve_many`` on the torch
    backend is feasible, the assigned count equals the run's records, and
    the replay's decisions equal the reference's replay of its own run."""
    from repro.core.controller import Controller as RefController
    from repro.sim.engine import EventSimulator as RefSimulator
    from repro.sim.engine import SimConfig as RefSimConfig
    from repro.sim.trace import borg_trace, scale_capacity_for_utilization
    from repro_torch.policy.pipeline import reactive_pipeline
    from repro_torch.sim.engine import EventSimulator, SimConfig
    ref_tele = ref_telemetry.generate(days=2, seed=0)
    tele = convert.telemetry_from_reference(ref_tele)
    jobs = borg_trace(days=0.03, seed=1, tolerance=0.5,
                      target_jobs_per_day=23000.0)
    cap = scale_capacity_for_utilization(jobs, 0.03, 5, 0.15)
    pipe = reactive_pipeline(tele, record_windows=True, device="cpu")
    res = EventSimulator(tele, cap, SimConfig()).run(
        convert.jobs_from_reference(jobs), pipe)
    assert len(pipe.recorded) > 10
    replayed = pipe.replay_recorded(backend="torch")
    assert len(replayed) == len(pipe.recorded)
    assert all(r is not None and r.feasible for r in replayed)
    total = sum(int((r.assign >= 0).sum()) for r in replayed)
    assert total == len(res["records"])

    ref = RefController(ref_tele, record_windows=True)
    RefSimulator(ref_tele, cap, RefSimConfig()).run(jobs, ref)
    assert len(ref.recorded) == len(pipe.recorded)
    for r, p in zip(ref.replay_recorded(backend="jax"), replayed):
        assert r.status == p.status
        np.testing.assert_array_equal(r.assign, p.assign)
    # The loop fallback replays the same windows one by one.
    flow = pipe.replay_recorded(backend="flow")
    assert [r.status for r in flow] == ["optimal"] * len(flow)
