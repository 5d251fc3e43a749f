"""The port's policy surface against the JAX package's: the spec grammar
(round trips and error messages), the registry (names, parameter schemas),
the paper's §5 comparison schedulers and the MILP backends, built from spec
strings and run through both event engines on the same cell.

The one stated difference: the port's solver backends. ``BACKEND_MAP`` is
the reference's name -> the port's name; every parity test here and in
``test_torch_scenarios.py`` / ``test_torch_experiments.py`` maps through it
and nowhere else."""
import copy
import re

import numpy as np
import pytest

from repro import policy as ref_policy
from repro.core import telemetry as ref_telemetry
from repro.core.baselines import make_scheduler as ref_make_scheduler
from repro.forecast import base as ref_fbase
from repro.sim import trace as ref_trace
from repro.sim.engine import EventSimulator as RefSimulator
from repro_torch import policy
from repro_torch.core import solvers, telemetry
from repro_torch.core.baselines import make_scheduler
from repro_torch.forecast import base as fbase
from repro_torch.policy.pipeline import reactive_pipeline
from repro_torch.sim import trace
from repro_torch.sim.engine import EventSimulator

#: The reference's solver-backend name -> the port's.
BACKEND_MAP = {"jax": "torch"}
#: The help text of the ``backend`` parameter, which names the backends.
BACKEND_HELP = {"solver backend (flow / jax / fused / scipy / pulp)":
                "solver backend (flow / torch / fused / scipy / pulp)"}


def port_backend(name: str) -> str:
    return BACKEND_MAP.get(name, name)


def port_spec(text: str) -> str:
    """A reference spec string as the port spells it."""
    return re.sub(r"backend=(\w+)",
                  lambda m: f"backend={port_backend(m.group(1))}", text)


def param_tuple(p, port: bool = False):
    """A Param as plain data; ``port=True`` maps a reference Param's
    backend default and help to the port's names."""
    default, help_ = p.default, p.help
    if port and p.name == "backend":
        default, help_ = port_backend(default), BACKEND_HELP.get(help_,
                                                                 help_)
    return (p.name, p.type, default, help_)


def schema_tuples(schema, port: bool = False):
    return [param_tuple(p, port) for p in schema.values()]


def record_keys(result):
    return [(r.job.job_id, r.region, r.start_s, r.finish_s, r.carbon_g,
             r.water_l, r.embodied_g) for r in result["records"]]


def job_scalings(result):
    return [(r.job.job_id, r.job.planned_start_s, r.job.time_scale,
             r.job.energy_scale) for r in result["records"]]


# ---------------------------------------------------------------------------
# Grammar: parse / format, mirroring tests/test_policy.py
# ---------------------------------------------------------------------------

GOOD = ["waterwise[lam_h2o=0.7,backend=torch]", "  waterwise [ lam_h2o = 0.7 ]  ",
        "waterwise[]", "waterwise", "waterwise-forecast[horizon_slots=4,"
        "record_windows=true]", "ecovisor[window=12]",
        "waterwise[sigma=1e-3,lam_co2=0.25]", "carbon-greedy-opt",
        "waterwise-embodied[lam_embodied=0.3,backend=scipy]"]


@pytest.mark.parametrize("text", GOOD)
def test_parse_format_round_trip_matches_reference(text):
    spec, ref = policy.parse(text), ref_policy.parse(text)
    assert spec.name == ref.name
    assert spec.params == ref.params
    assert [type(v) for v in spec.params.values()] == \
        [type(v) for v in ref.params.values()]
    assert str(spec) == str(ref)
    assert policy.parse(str(spec)) == spec
    assert policy.parse(spec) == spec


def test_parse_accepts_spec_objects_like_reference():
    raw = {"horizon_slots": "4", "record_windows": "true"}
    spec = policy.parse(policy.PolicySpec("waterwise-forecast", raw))
    ref = ref_policy.parse(ref_policy.PolicySpec("waterwise-forecast", raw))
    assert spec.params == ref.params == {"horizon_slots": 4,
                                         "record_windows": True}
    assert str(spec) == str(ref)


BAD = ["waterwize", "no-such-policy", "waterwise[lam_h20=1.0]",
       "round-robin[x=1]", "waterwise-oracle[forecaster=oracle]",
       "waterwise[lam_h2o=abc]", "waterwise-forecast[horizon_slots=2.5]",
       "waterwise[record_windows=maybe]", "waterwise[lam_h2o=1",
       "waterwise[a]", "waterwise[=1]", "waterwise[lam_h2o=]",
       "waterwise[x=1][y=2]", "waterwise[lam_h2o=1,lam_h2o=2]", "[x=1]", "",
       "ecovisor[window=true]", "baseline[window=3]"]


def _error(fn, text):
    with pytest.raises(Exception) as info:
        fn(text)
    return info.value


@pytest.mark.parametrize("text", BAD)
def test_errors_match_reference(text):
    """Typos, ill-typed values and malformed brackets: the same error
    class, the same message (did-you-mean hints included)."""
    err, ref = _error(policy.parse, text), _error(ref_policy.parse, text)
    assert type(err).__name__ == type(ref).__name__
    assert [c.__name__ for c in type(err).__mro__] == \
        [c.__name__ for c in type(ref).__mro__]
    assert str(err) == str(ref)


def test_error_classes_keep_their_identities():
    with pytest.raises(policy.UnknownPolicyError, match="waterwise"):
        policy.parse("waterwize")
    with pytest.raises(KeyError):
        policy.parse("no-such-policy")
    with pytest.raises(policy.UnknownParamError, match="accepts no"):
        policy.parse("round-robin[x=1]")
    with pytest.raises(policy.ParamValueError, match="bool"):
        policy.parse("waterwise[record_windows=maybe]")
    with pytest.raises(policy.SpecSyntaxError):
        policy.parse("waterwise[a]")
    assert issubclass(policy.PolicySpecError, ValueError)


def test_with_params_and_with_defaults_match_reference():
    for mod in (policy, ref_policy):
        spec = mod.parse("waterwise[lam_h2o=0.7]")
        assert spec.with_params(lam_h2o=0.9, backend="flow").params == \
            {"lam_h2o": 0.9, "backend": "flow"}
        assert spec.with_defaults(lam_h2o=0.1, sigma=5.0).params == \
            {"lam_h2o": 0.7, "sigma": 5.0}
    a = _error(lambda t: policy.parse(t).with_params(nope=1), "waterwise")
    b = _error(lambda t: ref_policy.parse(t).with_params(nope=1), "waterwise")
    assert str(a) == str(b)


def test_split_specs_matches_reference():
    text = "baseline, waterwise[lam_co2=0.3,lam_h2o=0.7] ,least-load,,"
    assert policy.split_specs(text) == ref_policy.split_specs(text) == \
        ["baseline", "waterwise[lam_co2=0.3,lam_h2o=0.7]", "least-load"]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_names_and_schemas_match_reference():
    assert policy.list_policies() == ref_policy.list_policies()
    for name in ref_policy.list_policies():
        entry, ref = policy.get_policy(name), ref_policy.get_policy(name)
        assert entry.description == ref.description, name
        assert entry.forecast_driven == ref.forecast_driven, name
        assert entry.stateless == ref.stateless, name
        assert schema_tuples(entry.params) == \
            schema_tuples(ref.params, port=True), name
    # Exactly the stated mapping: the forecast-driven policies default to
    # the reference's "jax", which is the port's "torch".
    fc = policy.get_policy("waterwise-forecast").params["backend"]
    assert fc.default == "torch"
    assert ref_policy.get_policy(
        "waterwise-forecast").params["backend"].default == "jax"


def test_describe_matches_reference_under_backend_map():
    for markdown in (False, True):
        ref = ref_policy.describe(markdown=markdown)
        for a, b in BACKEND_HELP.items():
            ref = ref.replace(a, b)
        # Two more letters: the padded column loses two spaces.
        ref = ref.replace("backend=jax:str  ", "backend=torch:str")
        ref = ref.replace("backend=jax:str", "backend=torch:str")
        assert policy.describe(markdown=markdown) == ref


def test_device_is_not_a_spec_param():
    for name in policy.list_policies():
        assert "device" not in policy.get_policy(name).params
    with pytest.raises(policy.UnknownParamError):
        policy.parse("waterwise[device=cpu]")


def test_forecaster_schemas_match_reference():
    """The same forecasters and constructor schemas; the learned model's
    ``scan_impl`` names the reference's scans (``assoc`` / ``pallas``),
    the port's are ``kernel`` / ``torch`` chosen by device (default None,
    which no spec can spell), so it is the one parameter not shared."""
    assert fbase.list_forecasters() == ref_fbase.list_forecasters()
    for name in ref_fbase.list_forecasters():
        ref = {k: v for k, v in ref_fbase.forecaster_schema(name).items()
               if not (name == "learned" and k == "scan_impl")}
        assert schema_tuples(fbase.forecaster_schema(name)) == \
            schema_tuples(ref), name
    assert fbase.describe_forecasters(markdown=True).count("\n") == \
        ref_fbase.describe_forecasters(markdown=True).count("\n")
    a = _error(fbase.forecaster_schema, "holtwinter")
    b = _error(ref_fbase.forecaster_schema, "holtwinter")
    assert str(a) == str(b) and isinstance(a, KeyError)


@pytest.fixture(scope="module")
def tele():
    return telemetry.generate(days=2, seed=0)


def test_build_passes_device_to_pipelines_only(tele):
    sched = policy.build("waterwise[backend=fused]", tele, device="cpu")
    assert sched.device == "cpu" and sched.backend == "fused"
    fc = policy.build("waterwise-forecast[forecaster=persistence]", tele,
                      device="cpu")
    assert fc.device == "cpu" and fc.backend == "torch"
    emb = policy.build("waterwise-embodied", tele, device="cpu",
                       lam_embodied=0.4)
    assert emb.device == "cpu" and abs(emb.lam_emb - 0.4) < 1e-12
    for name in ("baseline", "round-robin", "least-load",
                 "carbon-greedy-opt", "water-greedy-opt", "ecovisor"):
        rule = policy.build(name, tele, device="cpu")
        assert not hasattr(rule, "device")
        assert rule.name == name
    # The default device is the card: nothing is built on the CPU quietly.
    assert policy.build("waterwise", tele).device is None


def test_backend_jax_fails_at_build_naming_torch(tele):
    spec = policy.parse("waterwise[backend=jax]")      # the grammar takes it
    with pytest.raises(KeyError, match="'torch'"):
        policy.build(spec, tele, device="cpu")
    with pytest.raises(KeyError, match="'torch'"):
        reactive_pipeline(tele, backend="jax")
    with pytest.raises(KeyError, match="have"):
        policy.build("waterwise[backend=nope]", tele, device="cpu")


def test_reactive_pipeline_takes_record_windows(tele):
    """The reference's ``record_windows`` parameter on the port's reactive
    factory and spec: off by default; on, every solved window is kept
    (cost, mask, capacity, overrun, tol, soften) and replays through
    ``solve_many`` to the run's placements."""
    from repro_torch.core import problem
    assert policy.parse("waterwise[record_windows=false]").params == \
        {"record_windows": False}
    off = reactive_pipeline(tele, record_windows=False)
    assert off.backend == "flow" and off.record_windows is False
    jobs = [problem.Job(job_id=i, home_region=i % 5, submit_time_s=0.0,
                        exec_time_s=600.0, energy_kwh=0.05, tolerance=1.0)
            for i in range(12)]
    for pipe in (reactive_pipeline(tele, record_windows=True,
                                   backend="fused", device="cpu"),
                 policy.build("waterwise[record_windows=true]", tele,
                              device="cpu")):
        assert pipe.record_windows is True and pipe.recorded == []
        dec = pipe.schedule(jobs, 0.0, np.full(5, 4))
        assert len(pipe.recorded) == 1
        window = pipe.recorded[0]
        assert window["cost"].shape == window["allowed"].shape
        assert window["cost"].shape[0] == 12
        assert window["soften"] is False
        (replayed,) = pipe.replay_recorded(backend="torch")
        assert replayed.feasible
        assert int((replayed.assign >= 0).sum()) == \
            int((dec.solver.assign >= 0).sum())
    off.schedule(jobs, 0.0, np.full(5, 4))
    assert off.recorded == [] and off.replay_recorded() == []


def test_solve_defaults_to_scipy_like_reference():
    from repro.core import solvers as ref_solvers
    rng = np.random.default_rng(0)
    cost = rng.random((7, 3))
    allowed = rng.random((7, 3)) < 0.8
    allowed[:, 0] = True
    cap = np.array([3, 3, 3])
    res, ref = solvers.solve(cost, allowed, cap), \
        ref_solvers.solve(cost, allowed, cap)
    assert res.backend == ref.backend == "scipy"
    np.testing.assert_array_equal(res.assign, ref.assign)
    assert res.objective == ref.objective and res.status == ref.status
    assert {"flow", "torch", "fused", "scipy"} <= set(
        solvers.available_backends())
    assert ("pulp" in solvers.available_backends()) == \
        ("pulp" in ref_solvers.available_backends())


@pytest.mark.parametrize("soften", [False, True])
def test_scipy_backend_matches_reference(soften):
    from repro.core import solvers as ref_solvers
    rng = np.random.default_rng(11 + soften)
    M, N = 40, 5
    cost = rng.random((M, N))
    allowed = rng.random((M, N)) < 0.5
    overrun = rng.random((M, N)) * 2.0
    tol = np.full(M, 0.5)
    cap = np.full(N, 9)
    kw = dict(soften=soften, overrun=overrun, tol=tol, sigma=3.0)
    res = solvers.solve(cost, allowed, cap, backend="scipy", **kw)
    ref = ref_solvers.solve(cost, allowed, cap, backend="scipy", **kw)
    assert (res.status, res.backend) == (ref.status, ref.backend)
    np.testing.assert_array_equal(res.assign, ref.assign)
    np.testing.assert_array_equal(res.penalties, ref.penalties)
    assert res.objective == ref.objective


def test_historical_names_build_through_registry(tele):
    from repro_torch.core.controller import Controller, ForecastController
    assert Controller is reactive_pipeline
    assert ForecastController(tele, forecaster="persistence",
                              device="cpu").backend == "torch"
    sched = make_scheduler("waterwise[lam_h2o=0.7]", tele, sigma=5.0)
    assert (sched.lam_h2o, sched.lam_co2, sched.sigma) == (0.7, 1.0 - 0.7,
                                                           5.0)
    with pytest.raises(policy.UnknownParamError):
        make_scheduler("baseline", tele, window=3)


# ---------------------------------------------------------------------------
# The schedulers, through both engines on the same cell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_cell():
    """A 0.01-day Borg-like cell at 30% load: 230 jobs, short enough for
    the per-job oracle loops."""
    ref_tele = ref_telemetry.generate(days=2, seed=1)
    tele = telemetry.generate(days=2, seed=1)
    ref_jobs = ref_trace.borg_trace(days=0.01, seed=5, tolerance=1.0)
    jobs = trace.borg_trace(days=0.01, seed=5, tolerance=1.0)
    cap = trace.scale_capacity_for_utilization(jobs, 0.01, 5, 0.3)
    return ref_tele, ref_jobs, tele, jobs, cap


RULES = ["baseline", "round-robin", "least-load", "carbon-greedy-opt",
         "water-greedy-opt", "ecovisor", "ecovisor[window=6]"]


@pytest.mark.parametrize("name", RULES)
def test_rule_schedulers_match_reference(small_cell, name):
    """Built by name through each registry and replayed by each engine
    (the spec path of ``resolve_scheduler``): equal records, equal
    oracle start plans and Ecovisor scalings."""
    ref_tele, ref_jobs, tele, jobs, cap = small_cell
    r_ref = RefSimulator(ref_tele, cap).run(copy.deepcopy(ref_jobs), name)
    r = EventSimulator(tele, cap).run(copy.deepcopy(jobs), name)
    assert r["rounds"] == r_ref["rounds"] and r["unfinished"] == \
        r_ref["unfinished"]
    assert record_keys(r) == record_keys(r_ref)
    assert job_scalings(r) == job_scalings(r_ref)
    assert len(r["records"]) > 0


def test_resolve_scheduler_matches_reference_signature(small_cell):
    """The engine's spec path takes what the reference's takes (a device is
    chosen through ``policy.build``), and passes scheduler objects through."""
    import inspect

    from repro.sim import engine as ref_engine
    from repro_torch.sim import engine
    assert list(inspect.signature(engine.resolve_scheduler).parameters) == \
        list(inspect.signature(ref_engine.resolve_scheduler).parameters)
    tele = small_cell[2]
    built = engine.resolve_scheduler("ecovisor[window=3]", tele)
    assert engine.resolve_scheduler(built, tele) is built


def test_make_scheduler_shims_agree(small_cell):
    ref_tele, ref_jobs, tele, jobs, cap = small_cell
    r_ref = RefSimulator(ref_tele, cap).run(
        copy.deepcopy(ref_jobs), ref_make_scheduler("ecovisor", ref_tele,
                                                    window=3))
    r = EventSimulator(tele, cap).run(
        copy.deepcopy(jobs), make_scheduler("ecovisor", tele, window=3))
    assert record_keys(r) == record_keys(r_ref)


@pytest.fixture(scope="module")
def diurnal_cell():
    """The 665-job diurnal cell of tests/test_torch_e2e.py."""
    ref_jobs = ref_trace.borg_trace(days=0.03, seed=3, tolerance=4.0,
                                    target_jobs_per_day=23000.0)
    jobs = trace.borg_trace(days=0.03, seed=3, tolerance=4.0,
                            target_jobs_per_day=23000.0)
    cap = trace.scale_capacity_for_utilization(jobs, 0.03, 5, 0.15)
    return (ref_telemetry.generate(days=6, seed=0), ref_jobs,
            telemetry.generate(days=6, seed=0), jobs, cap)


@pytest.mark.parametrize("ref_spec", ["waterwise[backend=jax]",
                                      "waterwise[backend=scipy]"])
def test_waterwise_backends_match_reference(diurnal_cell, ref_spec):
    """``waterwise[backend=torch]`` (on the CPU) against the reference's
    ``[backend=jax]``, and the HiGHS backend against itself: equal records
    on the 665-job cell."""
    ref_tele, ref_jobs, tele, jobs, cap = diurnal_cell
    r_ref = RefSimulator(ref_tele, cap).run(
        copy.deepcopy(ref_jobs), ref_policy.build(ref_spec, ref_tele))
    sched = policy.build(port_spec(ref_spec), tele, device="cpu")
    assert sched.backend == port_backend(ref_policy.parse(
        ref_spec).params["backend"])
    r = EventSimulator(tele, cap).run(copy.deepcopy(jobs), sched)
    assert len(jobs) == 665
    assert r["unfinished"] == r_ref["unfinished"] == 0
    assert r["rounds"] == r_ref["rounds"]
    assert record_keys(r) == record_keys(r_ref)
