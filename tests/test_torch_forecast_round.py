"""The forecast-driven WaterWise round end to end: the port's
``EventSimulator`` + ``forecast_pipeline`` against the JAX package's on the
same cell, for the oracle, Holt-Winters and the learned forecaster (JAX
init carried across), with and without re-planning."""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.core import telemetry as ref_telemetry
from repro.forecast import learned as ref_learned
from repro.policy.pipeline import forecast_pipeline as ref_forecast_pipeline
from repro.sim import metrics as ref_metrics
from repro.sim import trace as ref_trace
from repro.sim.engine import EventSimulator as RefSimulator
from repro.sim.engine import SimConfig as RefConfig
from repro_torch import convert
from repro_torch.core import problem
from repro_torch.forecast import learned
from repro_torch.policy.pipeline import forecast_pipeline
from repro_torch.sim import metrics
from repro_torch.sim.engine import EventSimulator, SimConfig

# Forecast MAPE of a run: the forecasts are float32 filters in two
# libraries (see tests/test_torch_forecast.py), averaged over the run.
MAPE_RTOL = 1e-5
# The learned forecaster's MAPE: 300 float32 AdamW steps from the same init
# amplify the two libraries' last-bit differences (measured 1.8e-4).
LEARNED_MAPE_RTOL = 1e-3
# Totals where a logged near-tie flips a decision (ROADMAP queue 3): the
# bound chip_smoke.py holds the card to against the CPU.
TOTALS_RTOL = 5e-3


@pytest.fixture(scope="module")
def teles():
    ref = ref_telemetry.generate(days=6, seed=0)
    return ref, convert.telemetry_from_reference(ref)


# ---------------------------------------------------------------------------
# The forecast-driven round end to end
# ---------------------------------------------------------------------------

DAYS = 0.125                    # 3 simulated hours: 3 forecaster fits
SIM = dict(window_s=120.0)


@pytest.fixture(scope="module")
def cell():
    """A diurnal Borg-like cell of 810 jobs over 3 hours at 15 % load,
    tolerance 4 (so jobs can be held for later slots)."""
    ref_jobs = ref_trace.borg_trace(days=DAYS, seed=3, tolerance=4.0,
                                    target_jobs_per_day=6000.0)
    cap = ref_trace.scale_capacity_for_utilization(ref_jobs, DAYS, 5, 0.15)
    return ref_jobs, convert.jobs_from_reference(ref_jobs), cap


def _key(r):
    return (r.job.job_id, r.region, r.start_s, r.finish_s, r.carbon_g,
            r.water_l)


def _run_both(teles, cell, ref_kw, port_kw):
    ref_tele, tele = teles
    ref_jobs, jobs, cap = cell
    ref_pipe = ref_forecast_pipeline(ref_tele, **ref_kw)
    r_ref = RefSimulator(ref_tele, cap, RefConfig(**SIM)).run(
        copy.deepcopy(ref_jobs), ref_pipe)
    pipe = forecast_pipeline(tele, device="cpu", **port_kw)
    r = EventSimulator(tele, cap, SimConfig(**SIM)).run(
        copy.deepcopy(jobs), pipe)
    return (r_ref, ref_pipe), (r, pipe)


def _assert_same_run(ref, port, mape_rtol=MAPE_RTOL):
    (r_ref, ref_pipe), (r, pipe) = ref, port
    assert r_ref["unfinished"] == r["unfinished"] == 0
    assert r_ref["rounds"] == r["rounds"]
    assert [_key(x) for x in r_ref["records"]] \
        == [_key(x) for x in r["records"]]
    s_ref, s = ref_metrics.summarize(r_ref), metrics.summarize(r)
    for k in ("mean_solve_ms",):        # wall time, not a result
        del s_ref[k], s[k]
    assert s == s_ref
    assert pipe.deferred_jobs == ref_pipe.deferred_jobs
    assert pipe.mean_defer_s == ref_pipe.mean_defer_s
    assert pipe.forecast_mape == pytest.approx(ref_pipe.forecast_mape,
                                               rel=mape_rtol)


@pytest.mark.parametrize("forecaster", ["oracle", "holtwinters"])
@pytest.mark.parametrize("backends", [("fused", "fused"), ("jax", "torch")])
def test_forecast_round_records_match_reference(teles, cell, forecaster,
                                                backends):
    """Equal records, totals, deferrals and forecast MAPE through both
    engines, for the port's ``fused``/``torch`` against the reference's
    ``fused``/``jax``."""
    ref_backend, backend = backends
    ref, port = _run_both(teles, cell,
                          dict(forecaster=forecaster, backend=ref_backend),
                          dict(forecaster=forecaster, backend=backend))
    _assert_same_run(ref, port)
    if forecaster == "holtwinters":
        assert port[1].forecast_mape > 0 and port[1].deferred_jobs > 0


@pytest.mark.parametrize("backends", [("jax", "torch"), ("fused", "fused")])
def test_replanning_round_matches_reference(teles, cell, backends):
    """Receding-horizon re-planning (``ReplanQueueDeferral``) on the same
    cell: the same re-plan bookkeeping; equal records through the unfused
    backends. Through the fused ones two held jobs swap slots on a logged
    near-tie (ROADMAP queue 3: the re-derived float32 costs differ in the
    last bits), so records are compared there up to that swap and the
    totals to TOTALS_RTOL."""
    ref_backend, backend = backends
    kw = dict(forecaster="oracle", replan=True)
    ref, port = _run_both(teles, cell, dict(kw, backend=ref_backend),
                          dict(kw, backend=backend))
    for k in ("replans", "replan_runs", "replan_vetoes"):
        assert getattr(port[1].deferral, k) == getattr(ref[1].deferral, k)
    if backend == "torch":
        _assert_same_run(ref, port)
        return
    (r_ref, _), (r, _) = ref, port
    assert r_ref["unfinished"] == r["unfinished"] == 0
    by_id = {x[0]: x for x in map(_key, r["records"])}
    differ = {x[0] for x in map(_key, r_ref["records"]) if by_id[x[0]] != x}
    assert len(by_id) == len(r_ref["records"]) and differ <= {540, 544}
    s_ref, s = ref_metrics.summarize(r_ref), metrics.summarize(r)
    for k in ("carbon_kg", "water_kl"):
        assert s[k] == pytest.approx(s_ref[k], rel=TOTALS_RTOL), k


def test_learned_round_matches_reference(teles, cell, monkeypatch):
    """The learned forecaster (trained in the first round on the warmup
    archive, re-conditioned every hour) with the reference's JAX init
    carried across: equal records through the fused backends."""
    def init(seed, d_model, horizon, device=None):
        tree = ref_learned.init_params(jax.random.PRNGKey(seed), d_model,
                                       horizon)
        return convert.learned_params_from_reference(
            jax.tree.map(np.asarray, tree), device or "cpu")
    monkeypatch.setattr(learned, "init_params", init)
    ref, port = _run_both(teles, cell,
                          dict(forecaster="learned", backend="fused"),
                          dict(forecaster="learned", backend="fused"))
    _assert_same_run(ref, port, mape_rtol=LEARNED_MAPE_RTOL)
    f = port[1].pricer._forecaster_obj
    assert f.train_count == 1 and f.scan_impl == "torch"


def test_unported_options_raise(teles):
    _, tele = teles
    with pytest.raises(NotImplementedError, match="warm"):
        forecast_pipeline(tele, warm=True, device="cpu")
    with pytest.raises(NotImplementedError, match="record_windows"):
        forecast_pipeline(tele, record_windows=True, device="cpu")


def test_forecast_pipeline_needs_a_device_for_device_models(teles,
                                                            monkeypatch):
    """No card and no ``device``: the device forecasters and backends
    raise; the numpy forecasters and the host backend take no device."""
    _, tele = teles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [problem.Job(job_id=i, home_region=i % 5, submit_time_s=0.0,
                        exec_time_s=600.0, energy_kwh=0.05, tolerance=4.0)
            for i in range(4)]
    cap = np.full(5, 2)
    with pytest.raises(RuntimeError, match="device"):
        forecast_pipeline(tele, backend="flow").schedule(jobs, 0.0, cap)
    dec = forecast_pipeline(tele, forecaster="seasonal-naive",
                            backend="flow").schedule(jobs, 0.0, cap)
    assert len(dec.scheduled) + len(dec.deferred) == 4
    dec = forecast_pipeline(tele, backend="fused", device="cpu").schedule(
        jobs, 0.0, cap)
    assert dec.solver.backend == "fused"
