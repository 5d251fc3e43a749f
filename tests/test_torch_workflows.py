"""The port's workflow (DAG) package, the workflow scenarios and the
windowed engine against the JAX package's: the same traces, critical paths,
deadlines and CSV ingestion, equal engine records in both packages, and a
workflow cell streamed through the port's decision loop equal to its batch
run. Everything runs on the CPU."""
import copy
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import telemetry as ref_telemetry
from repro.policy.registry import build as ref_build_policy
from repro.sim import WindowedSimulator as RefWindowed
from repro.sim import borg_trace as ref_borg_trace
from repro.sim.engine import EventSimulator as RefSimulator
from repro.sim.engine import SimConfig as RefConfig
from repro.sim.scenarios import get_scenario as ref_get_scenario
from repro.sim.trace import \
    scale_capacity_for_utilization as ref_scale_capacity
from repro.workflows import cpath as ref_cpath
from repro.workflows import generators as ref_generators
from repro.workflows.ingest import load_workflow_csv as ref_load_csv
from repro_torch import policy
from repro_torch.core import problem, telemetry
from repro_torch.sim import WindowedSimulator, borg_trace
from repro_torch.sim.engine import EventSimulator, SimConfig
from repro_torch.sim.scenarios import get_scenario
from repro_torch.sim.trace import scale_capacity_for_utilization
from repro_torch.workflows import (CycleError, WorkflowSpec,
                                   assign_deadlines, cpath, critical_path_s,
                                   generators, load_workflow_csv,
                                   longest_path_to_sink,
                                   precedence_violations, topological_order,
                                   workflow_miss_rate, workflow_trace)


def _fields(job):
    return {f.name: getattr(job, f.name) for f in dataclasses.fields(job)}


def _assert_jobs_equal(a, b):
    assert len(a) == len(b) > 0
    for ja, jb in zip(a, b):
        assert _fields(ja) == _fields(jb)


def _key(r):
    return (r.job.job_id, r.region, r.start_s, r.finish_s, r.carbon_g,
            r.water_l, r.embodied_g)


# ---------------------------------------------------------------------------
# Generators, critical paths, deadlines, ingestion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,burst,rate", [(0, 0.0, 300.0), (7, 0.0, 200.0),
                                             (3, 0.5, 800.0)])
def test_generators_match_reference(seed, burst, rate):
    kw = dict(days=0.05, seed=seed, workflows_per_day=rate, burst=burst)
    jobs = workflow_trace(**kw)
    _assert_jobs_equal(jobs, ref_generators.workflow_trace(**kw))
    assert all(j.workflow_id is not None for j in jobs)
    mixed = dict(days=0.03, seed=seed, workflows_per_day=rate,
                 plain_jobs_per_day=5000.0)
    _assert_jobs_equal(generators.mixed_trace(**mixed),
                       ref_generators.mixed_trace(**mixed))


def _random_dag(rng, n):
    deps = [tuple(sorted(rng.choice(i, size=min(i, rng.integers(0, 4)),
                                    replace=False).tolist())) if i else ()
            for i in range(n)]
    perm = rng.permutation(n)                  # ids out of topological order
    ids = [int(100 + p) for p in perm]
    return ids, [tuple(ids[d] for d in dd) for dd in deps]


def _assert_same_graph_math(ids, deps, exec_s, submit, tol):
    e = cpath.edges_from_deps(ids, deps)
    e_ref = ref_cpath.edges_from_deps(ids, deps)
    np.testing.assert_array_equal(e, e_ref)
    n = len(ids)
    np.testing.assert_array_equal(topological_order(n, e),
                                  ref_cpath.topological_order(n, e_ref))
    np.testing.assert_array_equal(
        longest_path_to_sink(exec_s, e),
        ref_cpath.longest_path_to_sink(exec_s, e_ref))
    assert critical_path_s(exec_s, e) == ref_cpath.critical_path_s(exec_s,
                                                                   e_ref)
    dl, wf = assign_deadlines(exec_s, e, submit, tol)
    dl_r, wf_r = ref_cpath.assign_deadlines(exec_s, e_ref, submit, tol)
    np.testing.assert_array_equal(dl, dl_r)
    assert wf == wf_r


@pytest.mark.parametrize("seed", range(6))
def test_cpath_matches_reference_on_random_dags(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    ids, deps = _random_dag(rng, n)
    _assert_same_graph_math(ids, deps, rng.uniform(10.0, 2000.0, n),
                            float(rng.uniform(0, 1e4)),
                            float(rng.uniform(0, 2)))


@given(seed=st.integers(0, 10_000), n=st.integers(1, 24))
@settings(max_examples=40, deadline=None)
def test_cpath_matches_reference_property(seed, n):
    rng = np.random.default_rng(seed)
    ids, deps = _random_dag(rng, n)
    _assert_same_graph_math(ids, deps, rng.uniform(1.0, 500.0, n), 0.0, 0.5)


def _task(job_id, deps=(), mod=problem):
    return mod.Job(job_id=job_id, home_region=0, submit_time_s=0.0,
                   exec_time_s=100.0, energy_kwh=0.5, tolerance=0.5,
                   deps=tuple(deps))


def test_cycles_and_dangling_deps_raise_as_the_reference():
    from repro.core import problem as ref_problem
    from repro.workflows import WorkflowSpec as RefSpec
    cases = [([0, 1], [(1,), (0,)]), ([0, 1], [(), (7,)]),
             ([0, 0], [(), ()]), ([0, 1, 2], [(2,), (0,), (1,)])]
    for ids, deps in cases:
        with pytest.raises(CycleError) as err:
            WorkflowSpec(workflow_id=0, tasks=tuple(
                _task(i, d) for i, d in zip(ids, deps)))
        with pytest.raises(ref_cpath.CycleError) as ref_err:
            RefSpec(workflow_id=0, tasks=tuple(
                _task(i, d, ref_problem) for i, d in zip(ids, deps)))
        assert str(err.value) == str(ref_err.value)
    spec = WorkflowSpec(workflow_id=3, tasks=(_task(0), _task(1, (0,)),
                                              _task(2, (0,)),
                                              _task(3, (1, 2))))
    assert spec.critical_path_s == 300.0 and spec.deadline_s == 450.0
    assert [t.job_id for t in spec.topological_tasks()] == [0, 1, 2, 3]
    assert [t.deadline_override_s for t in spec.finalize()] == \
        [250.0, 350.0, 350.0, 450.0]


def test_load_workflow_csv_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    rows = ["run,task,submit_ms,duration_ms,cpu_util,home_region,deps"]
    for wf in (4, 1, 9):
        n = int(rng.integers(2, 7))
        for t in range(n):
            preds = [str(d) for d in range(t) if rng.random() < 0.4]
            rows.append(f"{wf},{t},{rng.uniform(0, 5e6):.3f},"
                        f"{rng.uniform(6e4, 9e5):.3f},"
                        f"{rng.uniform(0.3, 0.9):.4f},"
                        f"{int(rng.integers(0, 5))},{';'.join(preds)}")
    path = tmp_path / "wf.csv"
    path.write_text("\n".join(rows) + "\n")
    kw = dict(tolerance=0.7, util_to_energy=True,
              column_map=dict(workflow_id="run", task_id="task",
                              submit_s="submit_ms", duration_s="duration_ms",
                              energy_kwh="cpu_util"),
              unit_scale=dict(submit_s=1e-3, duration_s=1e-3))
    jobs = load_workflow_csv(str(path), **kw)
    _assert_jobs_equal(jobs, ref_load_csv(str(path), **kw))
    assert sorted(j.workflow_id for j in jobs)[0] == 1
    with pytest.raises(ValueError, match="lacks columns"):
        load_workflow_csv(str(path))


# ---------------------------------------------------------------------------
# The workflow scenarios and the engines, in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["workflow-diurnal", "workflow-burst"])
def test_workflow_scenarios_build_the_references_cells(name):
    args = (0.02, 2, 4000.0, 0.15)
    inst, ref = get_scenario(name).build(*args), \
        ref_get_scenario(name).build(*args)
    assert inst.name == ref.name == name
    _assert_jobs_equal(inst.jobs, ref.jobs)
    np.testing.assert_array_equal(inst.capacity, ref.capacity)
    np.testing.assert_array_equal(inst.tele.ci, ref.tele.ci)


@pytest.mark.parametrize("spec", ["baseline", "waterwise[backend=fused]"])
def test_workflow_cell_records_match_reference(spec):
    """``workflow-diurnal[days=0.01]`` through both engines: equal records,
    every task placed, no task started before a predecessor finished."""
    inst = get_scenario("workflow-diurnal").build(0.01, 0, 23000.0, 0.15)
    ref = ref_get_scenario("workflow-diurnal").build(0.01, 0, 23000.0, 0.15)
    res = EventSimulator(inst.tele, inst.capacity, SimConfig()).run(
        copy.deepcopy(inst.jobs), policy.build(spec, inst.tele,
                                               device="cpu"))
    res_ref = RefSimulator(ref.tele, ref.capacity, RefConfig()).run(
        copy.deepcopy(ref.jobs), ref_build_policy(spec, ref.tele))
    assert res["unfinished"] == res_ref["unfinished"] == 0
    assert [_key(r) for r in res["records"]] == \
        [_key(r) for r in res_ref["records"]]
    assert len(res["records"]) == len(inst.jobs)
    assert precedence_violations(res["records"]) == 0
    miss, n_wf = workflow_miss_rate(res["records"])
    assert n_wf > 0 and 0.0 <= miss <= 1.0


def test_workflow_stream_matches_batch_bit_for_bit():
    """A workflow cell streamed through the port's ``DecisionLoop`` equals
    its batch run, record for record (the reference's
    ``test_stream_matches_batch_bit_for_bit``)."""
    from repro_torch.policy.pipeline import forecast_pipeline
    from repro_torch.serve import DecisionLoop, ReplayArrivals, ServeConfig
    days = 0.05
    inst = get_scenario("workflow-diurnal").build(days, 1, 3000.0, 0.15)

    def pipe():
        return forecast_pipeline(inst.tele, forecaster="oracle", risk=0.0,
                                 defer_eps=1e-4, backend="fused",
                                 device="cpu")
    batch = EventSimulator(inst.tele, inst.capacity, SimConfig()).run(
        copy.deepcopy(inst.jobs), pipe())
    loop = DecisionLoop(EventSimulator(inst.tele, inst.capacity, SimConfig()),
                        pipe(), ReplayArrivals(copy.deepcopy(inst.jobs)),
                        ServeConfig(round_s=300.0, queue_bound=1 << 30))
    loop.run(days * 86400.0)
    stream = loop.stepper.result()
    assert [_key(r) for r in batch["records"]] == \
        [_key(r) for r in stream["records"]]
    assert precedence_violations(stream["records"]) == 0
    assert len(stream["records"]) == len(inst.jobs)


@pytest.mark.parametrize("spec", ["baseline", "waterwise[backend=torch]"])
def test_windowed_engine_matches_reference(spec):
    """``WindowedSimulator``, the fixed-window oracle, on
    tests/test_engine.py's small cell: the reference's records, and the
    event engine's placements for the same scheduler."""
    ref_tele, tele = ref_telemetry.generate(days=1, seed=0), \
        telemetry.generate(days=1, seed=0)
    jobs = borg_trace(days=0.08, seed=3, tolerance=0.5)
    ref_jobs = ref_borg_trace(days=0.08, seed=3, tolerance=0.5)
    cap = scale_capacity_for_utilization(jobs, 0.08, 5, utilization=0.15)
    np.testing.assert_array_equal(
        cap, ref_scale_capacity(ref_jobs, 0.08, 5, utilization=0.15))
    ref_spec = spec.replace("torch", "jax")
    res = WindowedSimulator(tele, cap).run(
        copy.deepcopy(jobs), policy.build(spec, tele, device="cpu"))
    res_ref = RefWindowed(ref_tele, cap).run(
        copy.deepcopy(ref_jobs), ref_build_policy(ref_spec, ref_tele))
    assert [_key(r) for r in res["records"]] == \
        [_key(r) for r in res_ref["records"]]
    for k in ("windows", "rounds", "unfinished", "horizon_s"):
        assert res[k] == res_ref[k], k
    assert res["utilization"] == res_ref["utilization"]
    event = EventSimulator(tele, cap).run(
        copy.deepcopy(jobs), policy.build(spec, tele, device="cpu"))
    place = sorted((r.job.job_id, r.region, r.start_s, r.finish_s)
                   for r in event["records"])
    assert place == sorted((r.job.job_id, r.region, r.start_s, r.finish_s)
                           for r in res["records"])
