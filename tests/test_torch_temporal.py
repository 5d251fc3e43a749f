"""The forecast round's solve in the port against the JAX package: the
temporal planner and Program 2 (``fused_temporal_round``) on the
instances of tests/test_round.py. The whole round end to end is in
tests/test_torch_forecast_round.py."""
import numpy as np
import pytest

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
