"""The port's experiment layer against the JAX package's: scenario specs,
plans and their JSON, the ``serial``, ``process`` and ``sharded``
executors' rows, the engine-state handoff of sharded execution, the
error-row and ``CellError`` paths, and the trace report CLI on the same
trace file. The ``device`` executor is in test_torch_device_executor.py."""
import contextlib
import copy
import io
import json

import pytest

import repro_torch.obs as obs
from repro import experiments as ref_experiments
from repro.obs import report as ref_report
from repro_torch import experiments
from repro_torch.obs import report
from test_torch_policy import port_spec, schema_tuples
from test_torch_scenarios import _strip_wall

SCENARIOS = ["nominal[days=0.02,jobs_per_day=15000,seed=4]",
             "capacity-loss[days=0.02,jobs_per_day=15000,seed=5]"]
REF_POLICIES = ["baseline", "waterwise[backend=jax]"]


def test_executor_registry_matches_reference():
    assert experiments.list_executors() == ref_experiments.list_executors()
    for name in ref_experiments.list_executors():
        assert schema_tuples(experiments.executor_schema(name)) == \
            schema_tuples(ref_experiments.executor_schema(name)), name
    ex = experiments.get_executor("process[max_workers=3]")
    assert isinstance(ex, experiments.ProcessExecutor) and \
        ex.max_workers == 3
    assert experiments.get_executor("process", max_workers=None) \
        .max_workers == 0
    for bad in ("proces", "process[workers=2]", "serial[x=1]",
                "process[max_workers=two]"):
        with pytest.raises(Exception) as err:
            experiments.get_executor(bad)
        with pytest.raises(Exception) as ref:
            ref_experiments.get_executor(bad)
        assert type(err.value).__name__ == type(ref.value).__name__
        assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("text", [
    "diurnal[days=10,jobs_per_day=1e6]", "nominal", "burst-storm[seed=3]",
    "regime-shift[onset_frac=0.25,trace=alibaba]",
    "nominal[days=0.5,window_s=60,tolerance=2]"])
def test_scenario_spec_round_trip_matches_reference(text):
    spec, ref = experiments.parse_scenario(text), \
        ref_experiments.parse_scenario(text)
    assert (spec.name, spec.params, str(spec)) == \
        (ref.name, ref.params, str(ref))
    assert experiments.parse_scenario(str(spec)) == spec
    assert spec.cell_kwargs() == ref.cell_kwargs()
    assert spec.build_kwargs() == ref.build_kwargs()


@pytest.mark.parametrize("text", [
    "diurnl", "nominal[dayz=1]", "nominal[days=soon]", "nominal[seed=1.5]",
    "decarbonization[onset_frac=0.2]", "nominal[days=1", "workflow-burst[x=1]"])
def test_scenario_spec_errors_match_reference(text):
    with pytest.raises(Exception) as err:
        experiments.parse_scenario(text)
    with pytest.raises(Exception) as ref:
        ref_experiments.parse_scenario(text)
    assert type(err.value).__name__ == type(ref.value).__name__
    assert str(err.value) == str(ref.value)


def test_plan_json_matches_reference(tmp_path):
    kw = dict(scenarios=SCENARIOS + ["drought-summer"],
              policies=["baseline", "waterwise[lam_h2o=0.7,backend=flow]",
                        "ecovisor[window=12]"], seeds=[0, 3])
    plan, ref = experiments.ExperimentPlan.build(**kw), \
        ref_experiments.ExperimentPlan.build(**kw)
    assert plan.to_json() == ref.to_json()
    assert [c.label() for c in plan.cells()] == \
        [c.label() for c in ref.cells()]
    path = tmp_path / "plan.json"
    plan.save(str(path))
    assert experiments.ExperimentPlan.load(str(path)) == plan
    with pytest.raises(ValueError, match="unknown ExperimentPlan keys"):
        experiments.ExperimentPlan.from_json('{"scenarios": [], "x": 1}')
    assert "device" not in plan.to_json()


@pytest.fixture(scope="module")
def serial_rows():
    plan = experiments.ExperimentPlan.build(
        SCENARIOS, [port_spec(p) for p in REF_POLICIES])
    return plan, plan.run("serial", device="cpu")


def test_serial_plan_matches_reference(serial_rows):
    """2 scenarios × (``baseline``, ``waterwise[backend=torch]``): the
    reference's rows under ``[backend=jax]``, savings included, apart from
    the wall times and the backend's name."""
    _, rows = serial_rows
    ref = ref_experiments.ExperimentPlan.build(SCENARIOS, REF_POLICIES) \
        .run("serial")
    for r in ref:
        r["spec"] = port_spec(r["spec"])
    assert _strip_wall(rows) == _strip_wall(ref)
    assert [r["spec"] for r in rows] == ["baseline",
                                        "waterwise[backend=torch]"] * 2
    assert all(r["error"] == "" and r["unfinished"] == 0 for r in rows)
    assert all("water_savings_pct" in r for r in rows)
    assert experiments.to_table(rows).splitlines()[0] == \
        ref_experiments.to_table(ref).splitlines()[0]


def test_process_rows_equal_serial_rows(serial_rows):
    """Spawned workers, the device passed to them as a string: the serial
    rows on every column but the wall times."""
    plan, rows = serial_rows
    proc = plan.run("process[max_workers=2]", device="cpu")
    assert _strip_wall(proc) == _strip_wall(rows)


@pytest.fixture
def raising_scenario():
    """A scenario registered in this process only, whose builder raises:
    the failing cell of the error-row tests."""
    from repro_torch.sim import scenarios
    name = "raises-on-build"

    @scenarios.register(name, "a cell that fails at build (tests only)")
    def build(days, seed, jobs_per_day, utilization):
        raise NotImplementedError(f"scenario {name!r} fails at build")
    yield name
    del scenarios._REGISTRY[name]


def test_process_workers_are_spawned(monkeypatch, raising_scenario):
    """The workers start by ``spawn``, from a fresh import: a scenario
    registered in this process only is unknown there (a forked worker
    would inherit it and fail in its builder), and each cell comes back as
    an error row naming it."""
    seen = {}
    real = experiments.executor.concurrent.futures.ProcessPoolExecutor

    def pool(workers, mp_context=None):
        seen["method"] = mp_context.get_start_method()
        return real(workers, mp_context=mp_context)
    monkeypatch.setattr(experiments.executor.concurrent.futures,
                        "ProcessPoolExecutor", pool)
    cells = experiments.ExperimentPlan.build(
        [f"{raising_scenario}[days=0.01]"], ["baseline", "least-load"]).cells()
    rows = experiments.ProcessExecutor(2).run(cells, device="cpu")
    assert seen["method"] == "spawn"
    assert [r["error"].split(":")[0] for r in rows] == \
        ["UnknownNameError"] * 2
    assert all(raising_scenario in r["error"] for r in rows)


def test_auto_sized_pool_is_capped_on_the_card(monkeypatch):
    """``max_workers=0`` (and ``sweep``'s default) opens at most
    ``CARD_WORKERS`` CUDA contexts on the card, and ``min(cpu_count,
    cells)`` workers on the CPU. No card is touched: the pool is a fake."""
    from repro_torch.sim import scenarios
    ex = experiments.executor
    monkeypatch.setattr(ex.os, "cpu_count", lambda: 64)
    assert ex.CARD_WORKERS == 3
    assert [ex.auto_workers(10, d) for d in (None, "cuda", "cuda:0",
                                             "cpu")] == [3, 3, 3, 10]
    assert ex.auto_workers(2, None) == 2

    seen = {}

    class Pool:
        def __init__(self, workers, mp_context=None):
            seen["workers"] = workers

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def submit(self, fn, cell, device):
            seen["device"] = device
            fut = ex.concurrent.futures.Future()
            fut.set_result({"spec": str(cell.policy)})
            return fut
    monkeypatch.setattr(ex.concurrent.futures, "ProcessPoolExecutor", Pool)
    cells = experiments.ExperimentPlan.build(
        SCENARIOS, ["baseline", "least-load", "round-robin"]).cells()
    rows = experiments.ProcessExecutor().run(cells)
    assert (seen, len(rows)) == ({"workers": 3, "device": "cuda"}, 6)
    experiments.ProcessExecutor().run(cells, device="cpu")
    assert seen == {"workers": 6, "device": "cpu"}

    runs = []
    monkeypatch.setattr(experiments.ExperimentPlan, "run",
                        lambda self, **kw: runs.append(kw) or [])
    for device in (None, "cpu"):
        scenarios.sweep(["baseline", "least-load"], ["nominal", "burst-storm"],
                        device=device)
    assert [(r["executor"], r["max_workers"], r["device"]) for r in runs] \
        == [("process", 3, None), ("process", 4, "cpu")]


def test_error_rows_and_cell_error(raising_scenario):
    """A crashed cell leaves an error row and the others finish; strict
    runs raise ``CellError`` naming the cell, with every row attached."""
    failing = f"{raising_scenario}[days=0.01]"
    plan = experiments.ExperimentPlan.build([SCENARIOS[0], failing],
                                            ["baseline"])
    rows = plan.run("serial", device="cpu")
    assert rows[0]["error"] == "" and rows[0]["jobs"] > 0
    assert rows[1]["error"].startswith("NotImplementedError: scenario "
                                       f"'{raising_scenario}'")
    assert rows[1]["scenario_spec"] == failing
    assert "carbon_kg" not in rows[1]
    with pytest.raises(experiments.CellError) as err:
        plan.run("serial", strict=True, device="cpu")
    assert err.value.scenario == failing
    assert err.value.spec == "baseline" and len(err.value.rows) == 2
    ref_err = ref_experiments.CellError("s", "p", "boom")
    assert str(experiments.CellError("s", "p", "boom")) == str(ref_err)
    # A policy that fails at build (the reference's backend name) is an
    # error row too, naming the port's counterpart.
    bad = experiments.ExperimentPlan.build(
        [SCENARIOS[0]], ["waterwise[backend=jax]"]).run("serial",
                                                        device="cpu")
    assert "'torch'" in bad[0]["error"]


def test_seed_aggregation_matches_reference():
    plan = experiments.ExperimentPlan.build(
        ["nominal[days=0.01,jobs_per_day=15000]"], ["baseline", "least-load"],
        seeds=[1, 2])
    rows = plan.run("serial", device="cpu")
    ref = ref_experiments.ExperimentPlan.build(
        ["nominal[days=0.01,jobs_per_day=15000]"], ["baseline", "least-load"],
        seeds=[1, 2]).run("serial")
    agg, ref_agg = experiments.aggregate_seeds(_strip_wall(rows)), \
        ref_experiments.aggregate_seeds(_strip_wall(ref))
    assert agg == ref_agg and agg[0]["n_seeds"] == 2


# ---------------------------------------------------------------------------
# The trace report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Two traces of the port's engine: a reactive cell through the fused
    solver on the CPU (spans with solver args, sim-time series) and a rule
    scheduler."""
    out = tmp_path_factory.mktemp("traces")
    paths = []
    for i, spec in enumerate(["waterwise[backend=fused]", "least-load"]):
        path = str(out / f"run{i}.trace.jsonl")
        with obs.capture(trace_path=path):
            experiments.run_cell(experiments.Cell(
                experiments.parse_scenario(SCENARIOS[0]),
                experiments.ExperimentPlan.build([], [spec]).policies[0]),
                device="cpu")
        paths.append(path)
    return paths


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("args", [["{0}"], ["{0}", "--json"],
                                  ["--validate", "{0}", "{1}"],
                                  ["--diff", "{0}", "{1}"]])
def test_report_matches_reference_on_same_trace(traces, args):
    argv = [a.format(*traces) for a in args]
    rc, out = _cli(report.main, argv)
    ref_rc, ref_out = _cli(ref_report.main, argv)
    assert (rc, out) == (ref_rc, ref_out)
    assert rc == 0
    assert ("diff" if "--diff" in args else "events") in out
    if "--json" in args:
        stages = json.loads(out)["stages"]
        assert {"cell.run", "engine.round", "solver.solve"} <= set(stages)


def test_report_validate_flags_bad_events(tmp_path):
    path = tmp_path / "bad.trace.jsonl"
    path.write_text('[\n{"ph": "X", "name": "a"},\n'
                    '{"ph": "X", "name": "b", "ts": 1, "pid": 1, "tid": 1, '
                    '"dur": -2}\n]\n')
    rc, out = _cli(report.main, ["--validate", str(path)])
    assert (rc, out) == _cli(ref_report.main, ["--validate", str(path)])
    assert rc == 1 and "schema violation" in out


# ---------------------------------------------------------------------------
# Sharded execution: engine-state handoff and the sharded executor
# ---------------------------------------------------------------------------

def _record_sig(res):
    return [(r.job.job_id, r.region, r.start_s, r.finish_s, r.carbon_g,
             r.water_l) for r in res["records"]]


@pytest.mark.parametrize("spec", ["round-robin",
                                  "waterwise-forecast[warmup_hours=4]"])
def test_chained_handoff_matches_single_run_bitwise(spec):
    """Stateful schedulers shard exactly through the engine-state handoff:
    stopping/exporting at boundaries and resuming with the same scheduler
    object reproduces the single run's records bit-for-bit."""
    from repro_torch import policy
    from repro_torch.sim import scenarios
    from repro_torch.sim.engine import EventSimulator
    from repro_torch.sim.trace import pick_shard_boundaries, slice_by_arrival
    inst = scenarios.get_scenario("nominal").build(0.05, 0, 23000.0, 0.15)
    single = EventSimulator(inst.tele, inst.capacity).run(
        copy.deepcopy(inst.jobs), policy.build(spec, inst.tele,
                                               device="cpu"))
    jobs = copy.deepcopy(inst.jobs)
    boundaries = pick_shard_boundaries(jobs, 3)
    slices = slice_by_arrival(jobs, boundaries)
    sched = policy.build(spec, inst.tele, device="cpu")
    sim = EventSimulator(inst.tele, inst.capacity)
    state, merged = None, []
    for k, sl in enumerate(slices):
        stop = boundaries[k] if k < len(boundaries) else None
        res = sim.run(sl, sched, state=state, stop_at=stop,
                      export_state=stop is not None)
        state = res.get("state")
        merged += _record_sig(res)
    assert len(slices) == 3 and merged == _record_sig(single)


SHARD_CELL = "diurnal[days=0.1,jobs_per_day=20000.0,tolerance=0.5]"
# Timing columns; merged utilization is recomposed from per-slice
# integrals (equal in value, float association differs): 1e-9 relative,
# as the reference's own executor test holds it.
_NONDET_COLS = ("wall_s", "mean_solve_ms", "utilization")


def _assert_rows_match(a, b):
    assert set(a) - {"_result"} == set(b) - {"_result"}
    for key in a:
        if key in _NONDET_COLS or key.startswith("_"):
            continue
        assert a[key] == b[key], f"column {key!r}: {a[key]} != {b[key]}"
    assert a["utilization"] == pytest.approx(b["utilization"], rel=1e-9)


@pytest.fixture(scope="module")
def sharded_rows():
    plan = experiments.ExperimentPlan.build(
        [SHARD_CELL], ["baseline", "waterwise[backend=flow]"])
    return (plan.run("serial", device="cpu"),
            plan.run("process[max_workers=2]", device="cpu"),
            plan.run("sharded[shards=2]", device="cpu"))


def test_serial_process_sharded_backends_produce_identical_rows(
        sharded_rows):
    """The three executors are interchangeable — identical rows,
    carbon/water/violation totals bit-identical — on a 2-shard diurnal
    cell for a stateless policy (speculative parallel path, spawned
    workers) and a stateful one (chained handoff)."""
    serial, process, sharded = sharded_rows
    assert len(serial) == len(process) == len(sharded) == 2
    for s, p, sh in zip(serial, process, sharded):
        assert not s["error"] and not sh["error"], sh["error"]
        _assert_rows_match(s, p)
        _assert_rows_match(s, sh)
        assert s["carbon_kg"] == p["carbon_kg"] == sh["carbon_kg"]
        assert s["water_kl"] == p["water_kl"] == sh["water_kl"]
        assert s["violation_pct"] == p["violation_pct"] == sh["violation_pct"]


def test_sharded_rows_match_reference(sharded_rows):
    """The reference's sharded rows of the same plan, on every column the
    reference's executor test holds."""
    _, _, sharded = sharded_rows
    ref = ref_experiments.ExperimentPlan.build(
        [SHARD_CELL], ["baseline", "waterwise[backend=flow]"]) \
        .run("sharded[shards=2,max_workers=1]")
    for r, sh in zip(ref, sharded):
        _assert_rows_match(r, sh)


def test_sharded_rows_reparse_and_seed_axis():
    plan = experiments.ExperimentPlan.build(
        scenarios=["diurnal[days=0.05]"], policies=["baseline"],
        seeds=[0, 1])
    rows = plan.run("sharded[shards=2]", device="cpu")
    assert [r["seed"] for r in rows] == [0, 1]
    assert rows[0]["carbon_kg"] != rows[1]["carbon_kg"]   # seeds differ
    for row in rows:
        sc = experiments.parse_scenario(row["scenario_spec"])
        assert sc.params["seed"] == row["seed"]
        assert row["spec"] == "baseline" and row["error"] == ""


def test_more_shards_than_arrivals_degrades_gracefully():
    """Degenerate shard counts yield fewer boundaries instead of crashing
    (and the sharded executor still produces the exact row)."""
    from repro_torch.sim.trace import borg_trace, pick_shard_boundaries
    jobs = borg_trace(days=0.01, seed=0, tolerance=0.5)[:4]
    assert len(pick_shard_boundaries(jobs, 10)) <= 3
    plan = experiments.ExperimentPlan.build(
        scenarios=["diurnal[days=0.01]"], policies=["baseline"])
    rows = plan.run("sharded[shards=64,max_workers=1]", device="cpu")
    serial = plan.run("serial", device="cpu")
    assert rows[0]["error"] == "" and rows[0]["jobs"] > 0
    _assert_rows_match(serial[0], rows[0])


def test_sharded_workers_are_spawned_with_the_device(monkeypatch):
    """The speculative path's pool is spawned (a forked child cannot use
    the card its parent opened), auto-sized by ``auto_workers``, and each
    shard gets the device as a string; no card is touched (fake pool)."""
    from repro_torch.experiments import shard
    seen = {}

    class Pool:
        def __init__(self, workers, mp_context=None):
            seen.update(workers=workers,
                        method=mp_context.get_start_method())

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def submit(self, fn, *args):
            seen.setdefault("devices", []).append(args[-1])
            fut = shard.concurrent.futures.Future()
            fut.set_result(fn(*args[:-1], "cpu"))
            return fut
    monkeypatch.setattr(shard.concurrent.futures, "ProcessPoolExecutor",
                        Pool)
    monkeypatch.setattr(experiments.executor.os, "cpu_count", lambda: 64)
    cell = experiments.ExperimentPlan.build(["diurnal[days=0.02]"],
                                            ["baseline"]).cells()[0]
    row = shard.run_sharded_cell(cell, shards=4)     # device None: the card
    assert seen == {"workers": experiments.executor.CARD_WORKERS,
                    "method": "spawn", "devices": ["cuda"] * 4}
    assert row["error"] == ""
    seen.clear()
    shard.run_sharded_cell(cell, shards=4, device="cpu")
    assert seen == {"workers": 4, "method": "spawn", "devices": ["cpu"] * 4}
