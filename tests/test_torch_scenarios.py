"""The port's scenario registry against the JAX package's: the same names
and builder schemas, every scenario building an identical instance (host
numpy on both sides, compared exactly; the workflow scenarios' DAG traces
too), CSV-backed scenarios, and the ``run_cell`` / ``sweep`` shims on the
CPU."""
import dataclasses

import numpy as np
import pytest

from repro import experiments as ref_experiments
from repro.sim import scenarios as ref_scenarios
from repro_torch import experiments
from repro_torch.sim import scenarios
from test_torch_policy import port_spec, schema_tuples

WORKFLOW = ("workflow-burst", "workflow-diurnal")
BUILT = [n for n in ref_scenarios.list_scenarios() if n not in WORKFLOW]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_tele_equal(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if fa[k] is None:
            assert fb[k] is None, k
        else:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def assert_instance_equal(inst, ref):
    """Every field of a ``ScenarioInstance``, exactly."""
    assert inst.name == ref.name
    assert_tele_equal(inst.tele, ref.tele)
    assert len(inst.jobs) == len(ref.jobs)
    for a, b in zip(inst.jobs, ref.jobs):
        assert _fields(a) == _fields(b)
    np.testing.assert_array_equal(inst.capacity, ref.capacity)
    assert inst.capacity.dtype == ref.capacity.dtype
    assert len(inst.capacity_events) == len(ref.capacity_events)
    for (t, cap), (t_ref, cap_ref) in zip(inst.capacity_events,
                                          ref.capacity_events):
        assert t == t_ref
        if isinstance(cap_ref, tuple):
            assert cap[0] == cap_ref[0]
            np.testing.assert_array_equal(cap[1], cap_ref[1])
        else:
            np.testing.assert_array_equal(cap, cap_ref)
    if ref.water_weight is None:
        assert inst.water_weight is None
    else:
        np.testing.assert_array_equal(inst.water_weight, ref.water_weight)
    assert (inst.forecast_bias, inst.forecast_noise) == \
        (ref.forecast_bias, ref.forecast_noise)


def test_registry_matches_reference():
    assert scenarios.list_scenarios() == ref_scenarios.list_scenarios()
    for name in ref_scenarios.list_scenarios():
        s, r = scenarios.get_scenario(name), ref_scenarios.get_scenario(name)
        assert s.description == r.description
        assert schema_tuples(s.params) == schema_tuples(r.params), name
        assert schema_tuples(experiments.scenario_schema(name)) == \
            schema_tuples(ref_experiments.scenario_schema(name)), name
    for markdown in (False, True):
        assert scenarios.describe(markdown) == ref_scenarios.describe(markdown)
        assert experiments.describe_scenarios(markdown) == \
            ref_experiments.describe_scenarios(markdown)
    for name in ("diurnl", "nope"):
        with pytest.raises(KeyError) as err:
            scenarios.get_scenario(name)
        with pytest.raises(KeyError) as ref:
            ref_scenarios.get_scenario(name)
        assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", BUILT)
def test_scenario_builds_reference_instance(name, seed):
    spec = f"{name}[days=0.3,seed={seed},jobs_per_day=4000]"
    inst, cell = experiments.build_instance(spec)
    ref, ref_cell = ref_experiments.build_instance(spec)
    assert cell == ref_cell
    assert len(ref.jobs) > 0
    assert_instance_equal(inst, ref)


@pytest.mark.parametrize("spec", [
    "nominal[days=0.2,trace=alibaba,tolerance=1.5,ewif_table=wri]",
    "regime-shift[days=1.5,onset_frac=0.3,ci_flip=3.0,wue_step=1.1]",
    "capacity-loss[days=0.4,utilization=0.5,seed=2]"])
def test_builder_params_match_reference(spec):
    inst, _ = experiments.build_instance(spec)
    ref, _ = ref_experiments.build_instance(spec)
    assert_instance_equal(inst, ref)


def test_telemetry_perturbations_match_reference():
    from repro.core import telemetry as ref_telemetry
    from repro_torch.core import telemetry
    tele, ref = telemetry.generate(days=3, seed=4), \
        ref_telemetry.generate(days=3, seed=4)
    assert_tele_equal(scenarios.scale_wue(tele, 1.3),
                      ref_scenarios.scale_wue(ref, 1.3))
    assert_tele_equal(scenarios.raise_wsf(tele), ref_scenarios.raise_wsf(ref))
    assert_tele_equal(scenarios.decarbonize(tele, [1, 3], horizon_hours=30),
                      ref_scenarios.decarbonize(ref, [1, 3],
                                                horizon_hours=30))
    for days in (0.5, 2.5):
        ev, ev_ref = scenarios.heat_derate_events(tele, days), \
            ref_scenarios.heat_derate_events(ref, days)
        assert len(ev) == len(ev_ref)
        for (t, (kind, frac)), (t_r, (kind_r, frac_r)) in zip(ev, ev_ref):
            assert (t, kind) == (t_r, kind_r)
            np.testing.assert_array_equal(frac, frac_r)


@pytest.mark.parametrize("name", WORKFLOW)
def test_workflow_scenarios_raise_with_reference_schema(name):
    """The workflow scenarios, which raised until the DAG generators were
    ported, build the reference's instance: the same schema, DAG trace
    (deps, workflow ids, critical-path deadlines), telemetry and capacity,
    at two seeds and a builder parameter."""
    assert schema_tuples(scenarios.get_scenario(name).params) == \
        schema_tuples(ref_scenarios.get_scenario(name).params)
    for seed in (0, 7):
        spec = f"{name}[days=0.1,tolerance=0.7,seed={seed},jobs_per_day=4000]"
        inst, cell = experiments.build_instance(spec)
        ref, ref_cell = ref_experiments.build_instance(spec)
        assert cell == ref_cell and len(ref.jobs) > 0
        assert_instance_equal(inst, ref)
        assert all(j.workflow_id is not None for j in inst.jobs)
        assert all(j.tolerance == 0.7 for j in inst.jobs)


@pytest.fixture
def csv_scenario(tmp_path):
    """One CSV trace registered under the same name in both registries,
    removed from both afterwards."""
    rng = np.random.default_rng(3)
    n = 400
    submit = np.sort(rng.random(n) * 0.25 * 86400.0)
    rows = ["job_id,submit_s,duration_s,energy_kwh,home_region"]
    rows += [f"{i},{submit[i]:.3f},{60 + 900 * rng.random():.3f},"
             f"{0.01 + 0.2 * rng.random():.5f},{int(rng.integers(0, 9))}"
             for i in range(n)]
    path = tmp_path / "slice.csv"
    path.write_text("\n".join(rows) + "\n")
    name = "csv-slice-parity"
    try:
        yield (scenarios.register_csv_scenario(name, str(path)),
               ref_scenarios.register_csv_scenario(name, str(path)))
    finally:
        scenarios._REGISTRY.pop(name, None)
        ref_scenarios._REGISTRY.pop(name, None)


def test_csv_scenario_matches_reference(csv_scenario):
    sc, ref = csv_scenario
    assert sc.description == ref.description
    assert schema_tuples(sc.params) == schema_tuples(ref.params)
    for seed in (0, 1):
        spec = (f"{sc.name}[days=0.2,seed={seed},jobs_per_day=1000,"
                f"tolerance=0.8]")
        inst, _ = experiments.build_instance(spec)
        ref_inst, _ = ref_experiments.build_instance(spec)
        assert 0 < len(ref_inst.jobs) < 400
        assert_instance_equal(inst, ref_inst)


#: Row columns that are host wall times, not results.
WALL = ("wall_s", "mean_solve_ms")


def _strip_wall(rows):
    return [{k: v for k, v in r.items() if k not in WALL} for r in rows]


def test_run_cell_shim_matches_reference():
    kw = dict(days=0.02, seed=2, jobs_per_day=20000.0, tolerance=1.0)
    row = scenarios.run_cell("forecast-error", "carbon-greedy-opt",
                             device="cpu", **kw)
    ref = ref_scenarios.run_cell("forecast-error", "carbon-greedy-opt", **kw)
    assert _strip_wall([row]) == _strip_wall([ref])
    assert row["scenario_spec"] == ("forecast-error[days=0.02,"
                                    "jobs_per_day=20000.0,seed=2,"
                                    "tolerance=1.0,utilization=0.15,"
                                    "window_s=30.0]")
    row = scenarios.run_cell("nominal", "waterwise", device="cpu",
                             sched_kwargs=dict(lam_h2o=0.8),
                             return_result=True, **kw)
    ref = ref_scenarios.run_cell("nominal", "waterwise",
                                 sched_kwargs=dict(lam_h2o=0.8), **kw)
    assert row["spec"] == ref["spec"] == "waterwise[lam_h2o=0.8]"
    assert row["carbon_kg"] == ref["carbon_kg"]
    assert row["_result"]["unfinished"] == 0


def test_sweep_shim_matches_reference():
    """``sweep`` over two scenarios and three policies on the CPU, serial:
    the reference's rows (savings against ``baseline`` included) with the
    port's backend names, wall time aside."""
    ref_specs = ["baseline", "least-load", "waterwise[backend=jax]"]
    kw = dict(days=0.02, seed=1, jobs_per_day=15000.0, executor="serial")
    rows = scenarios.sweep([port_spec(s) for s in ref_specs],
                           ["nominal", "drought-summer"], device="cpu", **kw)
    ref = ref_scenarios.sweep(ref_specs, ["nominal", "drought-summer"], **kw)
    for r in ref:
        r["spec"] = port_spec(r["spec"])
    assert _strip_wall(rows) == _strip_wall(ref)
    assert rows[2]["spec"] == "waterwise[backend=torch]"
    assert "carbon_savings_pct" in rows[2] and not rows[0]["error"]
    table = scenarios.to_table(rows)
    assert table.splitlines()[0] == ref_scenarios.to_table(ref).splitlines()[0]
