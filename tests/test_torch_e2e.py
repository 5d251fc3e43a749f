"""The reactive WaterWise round end to end: the port's engine + pipeline
against the JAX package's on the same cell, and the state carried across
(telemetry and job traces)."""
import copy
import dataclasses

import numpy as np
import pytest

from repro.core import telemetry as ref_telemetry
from repro.policy.pipeline import reactive_pipeline as ref_reactive
from repro.sim import metrics as ref_metrics
from repro.sim import trace as ref_trace
from repro.sim.engine import EventSimulator as RefSimulator
from repro.sim.engine import SimConfig as RefConfig
from repro_torch import convert
from repro_torch.core import problem, telemetry
from repro_torch.policy.pipeline import reactive_pipeline
from repro_torch.sim import metrics, trace
from repro_torch.sim.engine import EventSimulator, SimConfig


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_tele_equal(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if fa[k] is None:
            assert fb[k] is None, k
        else:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _assert_jobs_equal(a, b):
    assert len(a) == len(b)
    for ja, jb in zip(a, b):
        assert _fields(ja) == _fields(jb)


@pytest.fixture(scope="module")
def tele_pair():
    return ref_telemetry.generate(days=6, seed=0), \
        telemetry.generate(days=6, seed=0)


@pytest.fixture(scope="module")
def cell():
    """The diurnal cell of tests/test_round.py: 665 jobs at 15% load."""
    ref_jobs = ref_trace.borg_trace(days=0.03, seed=3, tolerance=4.0,
                                    target_jobs_per_day=23000.0)
    jobs = trace.borg_trace(days=0.03, seed=3, tolerance=4.0,
                            target_jobs_per_day=23000.0)
    cap = trace.scale_capacity_for_utilization(jobs, 0.03, 5, 0.15)
    return ref_jobs, jobs, cap


def test_generators_match_reference(cell):
    _assert_tele_equal(ref_telemetry.generate(days=2, seed=0),
                       telemetry.generate(days=2, seed=0))
    ref_jobs = ref_trace.borg_trace(days=0.03, seed=3, tolerance=4.0)
    _assert_jobs_equal(ref_jobs,
                       trace.borg_trace(days=0.03, seed=3, tolerance=4.0))
    ref_jobs, jobs, cap = cell
    assert len(jobs) == 665
    _assert_jobs_equal(ref_jobs, jobs)
    np.testing.assert_array_equal(
        cap, ref_trace.scale_capacity_for_utilization(ref_jobs, 0.03, 5,
                                                      0.15))


def test_convert_carries_reference_state(tele_pair, cell):
    ref_tele, tele = tele_pair
    ref_jobs, jobs, _ = cell
    carried = convert.telemetry_from_reference(ref_tele)
    assert isinstance(carried, telemetry.Telemetry)
    _assert_tele_equal(carried, tele)
    carried_jobs = convert.jobs_from_reference(ref_jobs)
    assert all(isinstance(j, problem.Job) for j in carried_jobs)
    _assert_jobs_equal(carried_jobs, jobs)


def _key(r):
    return (r.job.job_id, r.region, r.start_s, r.finish_s, r.carbon_g,
            r.water_l)


@pytest.mark.parametrize("backend", ["fused", "flow"])
def test_e2e_records_match_reference(tele_pair, cell, backend):
    """The reactive pipeline through both event engines on the same cell:
    every record (region, start, finish, carbon, water) is equal. The port
    runs on the CPU; its fused Sinkhorn is the twin of the reference's
    default XLA loop there."""
    ref_tele, tele = tele_pair
    ref_jobs, jobs, cap = cell
    r_ref = RefSimulator(ref_tele, cap, RefConfig()).run(
        copy.deepcopy(ref_jobs), ref_reactive(ref_tele, backend=backend))
    kw = dict(device="cpu") if backend == "fused" else {}
    r_port = EventSimulator(tele, cap, SimConfig()).run(
        copy.deepcopy(jobs), reactive_pipeline(tele, backend=backend, **kw))
    assert r_ref["unfinished"] == r_port["unfinished"] == 0
    assert r_ref["rounds"] == r_port["rounds"]
    assert [_key(r) for r in r_ref["records"]] \
        == [_key(r) for r in r_port["records"]]
    s_ref, s_port = ref_metrics.summarize(r_ref), metrics.summarize(r_port)
    for k in ("mean_solve_ms",):        # wall time, not a result
        del s_ref[k], s_port[k]
    assert s_port == s_ref
