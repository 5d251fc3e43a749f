"""The live service in the port against the JAX package's: the warm-started
fused round, arrival streams, bounded admission, the decision loop (batch
parity and the reference's service runs), and elastic restart on torch
state. Inputs are drawn from numpy seeds; everything runs on the CPU."""
import copy
import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import footprint as ref_footprint
from repro.core import problem as ref_problem
from repro.core import telemetry as ref_telemetry
from repro.core.round import SinkhornWarmStart as RefWarmStart
from repro.core.round import fused_temporal_round as ref_temporal_round
from repro.policy.pipeline import forecast_pipeline as ref_forecast_pipeline
from repro.serve import AdmissionQueue as RefAdmissionQueue
from repro.serve import DecisionLoop as RefDecisionLoop
from repro.serve import PoissonBurstArrivals as RefPoissonBurstArrivals
from repro.serve import ServeConfig as RefServeConfig
from repro.sim.engine import EventSimulator as RefSimulator
from repro.sim.engine import SimConfig as RefConfig
from repro.sim.trace import \
    scale_capacity_for_utilization as ref_scale_capacity
from repro_torch.core import footprint, problem, telemetry
from repro_torch.core.round import SinkhornWarmStart, fused_temporal_round
from repro_torch.kernels.sinkhorn import sinkhorn
from repro_torch.policy.pipeline import forecast_pipeline
from repro_torch.serve import (DROP_OLDEST, REJECT_NEW, AdmissionQueue,
                               DecisionLoop, FileTailArrivals,
                               PoissonBurstArrivals, ReplayArrivals,
                               ServeConfig, ServeReport)
from repro_torch.sim.engine import EventSimulator, SimConfig
from repro_torch.sim.trace import (borg_trace,
                                   scale_capacity_for_utilization)


@pytest.fixture(scope="module")
def teles():
    return ref_telemetry.generate(days=2, seed=0), \
        telemetry.generate(days=2, seed=0)


def _job(i, submit=0.0, region=0, exec_s=600.0, tol=4.0, ref=False):
    mod = ref_problem if ref else problem
    return mod.Job(job_id=i, home_region=region, submit_time_s=submit,
                   exec_time_s=exec_s, energy_kwh=0.05, tolerance=tol)


def _key(r):
    return (r.job.job_id, r.region, r.start_s, r.finish_s, r.carbon_g,
            r.water_l, r.embodied_g)


def _sig(jobs):
    return [(j.job_id, j.submit_time_s, j.home_region, j.exec_time_s,
             j.energy_kwh, j.package_bytes, j.tolerance) for j in jobs]


# ---------------------------------------------------------------------------
# The warm-started fused round
# ---------------------------------------------------------------------------

def _warm_instance(teles, M=32, S=8, R=5):
    """The reference's TestWarmStart instance in both packages: M jobs, a
    random (ci, ewif, wue) forecast grid and its 3 %-drifted copy."""
    ref_tele, tele = teles
    rng = np.random.default_rng(0)
    ci = rng.random((M, S, R)) * 300 + 50
    ewif = rng.random((M, S, R)) * 2 + 0.5
    wue = rng.random((M, S, R)) * 1 + 0.2
    drifted = ci * (1 + 0.03 * rng.standard_normal((M, S, R)))
    cap = np.full(R, max(2, M // R + 1))
    out = []
    for mod, fp, te, ref in ((problem, footprint, tele, False),
                             (ref_problem, ref_footprint, ref_tele, True)):
        jobs = [_job(i, region=i % R, exec_s=600.0 + 10 * i, ref=ref)
                for i in range(M)]
        snap = te.at(0.0)
        inst = mod.build(jobs, te, 0.0, cap, fp.m5_metal(), snap=snap)
        out.append((inst, snap, fp.m5_metal()))
    return out, (ci, ewif, wue, drifted, np.arange(S) * 1800.0)


def _solve(fn, inst, snap, server, grid, ci, ws, **kw):
    _, ewif, wue, _, offsets = grid
    return fn(inst, 0.0, ci, ewif, wue, snap["pue"], snap["wsf"], offsets,
              server, 0.5, 0.5, warm_start=ws, **kw)[3]


def test_warm_round_fewer_iters_same_plan(teles):
    """The reference's ``TestWarmStart`` on the port: a warm re-pricing
    round takes fewer iterations than the cold solve of the same instance
    and lands on the same decision."""
    (port, _), grid = _warm_instance(teles)
    ci, drifted = grid[0], grid[3]
    kw = dict(device="cpu")
    ws = SinkhornWarmStart()
    _solve(fused_temporal_round, *port, grid, ci, ws, **kw)   # cold seed
    warm = _solve(fused_temporal_round, *port, grid, drifted, ws, **kw)
    ref = SinkhornWarmStart()
    cold = _solve(fused_temporal_round, *port, grid, drifted, ref, **kw)
    assert ws.cold_iters and ws.warm_iters and ref.cold_iters
    assert ws.warm_iters[0] < ref.cold_iters[0]
    assert ws.warm_iters[0] < ws.cold_iters[0]
    assert (warm.assign == cold.assign).all()
    assert warm.status == cold.status
    assert ws.mean_warm_iters == ws.warm_iters[0]
    ws.reset()
    assert ws.g is None


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_warm_round_matches_reference(teles, impl):
    """Port against reference on the same instances, cold then warm then a
    fresh cold solve of the drifted round: equal assignments and statuses,
    equal cold and warm iteration lists, carried potentials within the
    parity contract's 1e-4. ``kernel`` is the adaptive kernel's plain loop
    on the CPU, which launches nothing."""
    (port, ref), grid = _warm_instance(teles)
    ci, drifted = grid[0], grid[3]
    before = sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES
    ws, ws_ref = SinkhornWarmStart(), RefWarmStart()
    for c in (ci, drifted, drifted):
        got = _solve(fused_temporal_round, *port, grid, c, ws, device="cpu",
                     sinkhorn_impl=impl)
        want = _solve(ref_temporal_round, *ref, grid, c, ws_ref)
        np.testing.assert_array_equal(got.assign, want.assign)
        assert got.status == want.status and got.backend == "fused"
        np.testing.assert_allclose(ws.g, ws_ref.g, atol=1e-4)
    assert ws.cold_iters == ws_ref.cold_iters
    assert ws.warm_iters == ws_ref.warm_iters
    assert len(ws.cold_iters) == 1 and len(ws.warm_iters) == 2
    assert sinkhorn.ANNEAL_ADAPTIVE_LAUNCHES == before


def test_warm_start_refuses_want_plan(teles):
    (port, _), grid = _warm_instance(teles)
    with pytest.raises(AssertionError, match="mutually exclusive"):
        _solve(fused_temporal_round, *port, grid, grid[0],
               SinkhornWarmStart(), device="cpu", want_plan=True)


def test_warm_pipeline_builds_and_warns_unfused(teles):
    """``waterwise-forecast[warm=true,replan=true,backend=fused]`` builds
    through the port's registry and carries the potentials; an unfused
    backend warns once (``policy.warm_ignored``) and keeps no carry, as in
    the reference."""
    from repro_torch import policy
    _, tele = teles
    jobs = [_job(i, region=i % 5) for i in range(6)]
    pipe = policy.build("waterwise-forecast[warm=true,replan=true,"
                        "backend=fused]", tele, device="cpu")
    assert pipe.pricer.warm and pipe.sinkhorn_cold_iters == []
    pipe.schedule(jobs, 0.0, np.full(5, 2))
    pipe.schedule(jobs, 30.0, np.full(5, 2))
    assert len(pipe.sinkhorn_cold_iters) == 1
    assert len(pipe.sinkhorn_warm_iters) == 1
    unfused = forecast_pipeline(tele, warm=True, backend="torch",
                                device="cpu")
    with pytest.warns(RuntimeWarning) as seen:
        unfused.schedule(jobs, 0.0, np.full(5, 2))
        unfused.schedule(jobs, 30.0, np.full(5, 2))
    assert sum("policy.warm_ignored" in str(w.message) for w in seen) == 1
    assert unfused.sinkhorn_cold_iters == unfused.sinkhorn_warm_iters == []


# ---------------------------------------------------------------------------
# Arrival sources
# ---------------------------------------------------------------------------

def test_replay_chunked_equals_whole():
    jobs = [_job(i, submit=float(i * 7 % 100)) for i in range(40)]
    whole = ReplayArrivals(jobs).poll(1e9)
    chunked, src = [], ReplayArrivals(jobs)
    for t in np.arange(0.0, 120.0, 11.0):
        chunked.extend(src.poll(float(t)))
    chunked.extend(src.poll(1e9))
    assert [j.job_id for j in chunked] == [j.job_id for j in whole]
    assert src.exhausted and src.next_arrival_s() is None


@pytest.mark.parametrize("seed,rate,burst,chunk_s,horizon_s", [
    (7, 0.2, 1.0, 3600.0, 900.0), (0, 1.0, 0.0, 600.0, 4000.0),
    (3, 11.57, 1.0, 3600.0, 4320.0), (5, 0.05, 0.5, 1800.0, None)])
def test_poisson_burst_matches_reference(seed, rate, burst, chunk_s,
                                         horizon_s):
    """The same jobs as the reference's stream for equal (seed, chunk,
    horizon), bit for bit, polled at any cadence."""
    kw = dict(seed=seed, burst=burst, chunk_s=chunk_s, horizon_s=horizon_s,
              tolerance=4.0)
    until = 7200.0 if horizon_s is None else horizon_s
    ref = RefPoissonBurstArrivals(rate, **kw).poll(until)
    one = PoissonBurstArrivals(rate, **kw).poll(until)
    fine, src = [], PoissonBurstArrivals(rate, **kw)
    for t in np.arange(37.0, until + 37.0, 37.0):
        fine.extend(src.poll(float(min(t, until))))
    assert len(one) > 0
    assert _sig(one) == _sig(ref) == _sig(fine)
    assert [j.job_id for j in one] == list(range(len(one)))
    if horizon_s is not None:
        assert src.exhausted


def test_file_tail_consumes_complete_lines_only(tmp_path):
    def line(i, t):
        return json.dumps(dict(job_id=i, home_region=0, submit_s=t,
                               exec_s=60.0, energy_kwh=0.01)) + "\n"
    path = tmp_path / "jobs.jsonl"
    src = FileTailArrivals(str(path))
    assert src.poll(1e9) == []              # no file yet: no jobs
    partial = line(1, 10.0)
    path.write_text(line(0, 5.0) + partial[:20])
    assert [j.job_id for j in src.poll(1e9)] == [0]
    with open(path, "a") as fh:             # the writer finishes the line
        fh.write(partial[20:])
    got = src.poll(1e9)
    assert [j.job_id for j in got] == [1] and got[0].tolerance == 0.25
    assert not src.exhausted
    src.close()
    assert src.exhausted


# ---------------------------------------------------------------------------
# Bounded admission, held against the reference's queue
# ---------------------------------------------------------------------------

def _storm(queue_cls, batches, takes, bound, policy, ref=False):
    q = queue_cls(bound, policy)
    next_id, taken, depths = 0, [], []
    for k, n in enumerate(batches):
        jobs = [_job(next_id + i, submit=float(k), ref=ref)
                for i in range(n)]
        next_id += n
        q.offer(jobs, float(k))
        assert len(q) <= bound
        depths.append(len(q))
        if takes:
            taken.extend(q.take(takes[k % len(takes)]))
    taken.extend(q.take())
    return q, [j.job_id for j in taken], depths, next_id


def _check_against_reference(batches, takes, bound, policy):
    q, taken, depths, offered = _storm(AdmissionQueue, batches, takes, bound,
                                       policy)
    r, taken_r, depths_r, _ = _storm(RefAdmissionQueue, batches, takes,
                                     bound, policy, ref=True)
    assert (taken, depths, q.shed_ids) == (taken_r, depths_r, r.shed_ids)
    assert (q.offered, q.admitted, q.shed, q.peak_depth) == \
        (r.offered, r.admitted, r.shed, r.peak_depth)
    assert q.offered == offered and q.admitted + q.shed == q.offered
    assert len(taken) + q.shed == q.offered
    assert taken == sorted(taken) and set(taken).isdisjoint(q.shed_ids)
    assert q.peak_depth <= q.bound
    return q


@pytest.mark.parametrize("policy", [REJECT_NEW, DROP_OLDEST])
def test_adversarial_burst_train_matches_reference(policy):
    q = _check_against_reference([1, 9, 30, 0, 17, 50, 2, 41], [3, 0, 1], 8,
                                 policy)
    assert q.shed > 0


@given(batches=st.lists(st.integers(0, 25), min_size=1, max_size=25),
       takes=st.lists(st.integers(0, 8), max_size=8),
       bound=st.integers(1, 15),
       policy=st.sampled_from([REJECT_NEW, DROP_OLDEST]))
@settings(max_examples=60, deadline=None)
def test_admission_invariants_property(batches, takes, bound, policy):
    _check_against_reference(batches, takes, bound, policy)


def test_unknown_shed_policy_raises():
    with pytest.raises(ValueError, match="shed policy"):
        AdmissionQueue(4, "drop-newest")


# ---------------------------------------------------------------------------
# The decision loop
# ---------------------------------------------------------------------------

# ServeReport fields that are host wall times, not results.
WALL_FIELDS = ("p50_round_ms", "p99_round_ms", "budget_overruns")


def _serve(tele, src_cls, loop_cls, sim_cls, cfg_cls, cfg, pipe_fn,
           scale, bound, policy, duration, rate):
    kw = dict(seed=1, num_regions=tele.num_regions, tolerance=4.0,
              burst=1.0, horizon_s=duration)
    cap = scale(src_cls(rate, **kw).poll(duration), duration / 86400.0,
                tele.num_regions, 0.15)
    loop = loop_cls(sim_cls(tele, cap, cfg()), pipe_fn(), src_cls(rate, **kw),
                    cfg_cls(round_s=30.0, queue_bound=bound,
                            shed_policy=policy))
    return loop, loop.run(duration)


@pytest.mark.parametrize("bound,policy,duration,rate", [
    (10_000, REJECT_NEW, 240.0, 0.5), (5, DROP_OLDEST, 120.0, 1.0)])
def test_service_report_matches_reference(teles, bound, policy, duration,
                                          rate):
    """The reference's ``TestDecisionLoop`` services (the clean one and the
    storm at bound 5 with drop-oldest), oracle forecaster with the warm
    carry, through both packages: every report field equal but the wall
    times, and the reference's own assertions on the port's report."""
    ref_tele, tele = teles
    kw = dict(forecaster="oracle", risk=0.0, defer_eps=1e-4,
              backend="fused", warm=True)
    loop, rep = _serve(tele, PoissonBurstArrivals, DecisionLoop,
                       EventSimulator, ServeConfig, SimConfig,
                       lambda: forecast_pipeline(tele, device="cpu", **kw),
                       scale_capacity_for_utilization, bound, policy,
                       duration, rate)
    _, ref = _serve(ref_tele, RefPoissonBurstArrivals, RefDecisionLoop,
                    RefSimulator, RefServeConfig, RefConfig,
                    lambda: ref_forecast_pipeline(ref_tele, **kw),
                    ref_scale_capacity, bound, policy, duration, rate)
    got, want = rep.to_dict(), dataclasses.asdict(ref)
    assert got.keys() == want.keys()
    for k in WALL_FIELDS:
        del got[k], want[k]
    assert got == want
    assert rep.jobs_in == rep.admitted + rep.shed
    assert rep.placed == rep.admitted
    assert rep.deadline_misses == rep.violations + rep.shed
    assert rep.p99_round_ms >= rep.p50_round_ms > 0
    assert rep.sinkhorn_cold_iters > 0
    if bound == 5:
        assert rep.shed > 0 and rep.max_admission_depth <= 5
        assert sorted(loop.admission.shed_ids) == loop.admission.shed_ids
    else:
        assert rep.shed == 0 and rep.deadline_misses == 0
        assert rep.rounds == 8 and rep.engine_rounds >= rep.rounds


def test_stream_records_equal_batch(teles):
    """A ``DecisionLoop`` over ``ReplayArrivals`` with no admission pressure
    reproduces ``EventSimulator.run`` of the same trace bit for bit (the
    reference's ``TestStreamBatchParity`` cell, on the port alone)."""
    _, tele = teles
    days = 0.03
    jobs = borg_trace(days=days, seed=3, tolerance=4.0,
                      target_jobs_per_day=23000.0)
    cap = scale_capacity_for_utilization(jobs, days, tele.num_regions, 0.15)

    def pipeline():
        return forecast_pipeline(tele, forecaster="oracle", risk=0.0,
                                 defer_eps=1e-4, backend="fused",
                                 device="cpu")
    batch = EventSimulator(tele, cap, SimConfig()).run(copy.deepcopy(jobs),
                                                       pipeline())
    loop = DecisionLoop(EventSimulator(tele, cap, SimConfig()), pipeline(),
                        ReplayArrivals(copy.deepcopy(jobs)),
                        ServeConfig(round_s=300.0, queue_bound=1 << 30))
    rep = loop.run(days * 86400.0)
    stream = loop.stepper.result()
    assert isinstance(rep, ServeReport)
    assert rep.shed == 0 and rep.jobs_in == len(jobs) == rep.placed
    assert [_key(r) for r in stream["records"]] \
        == [_key(r) for r in batch["records"]]


def test_decision_loop_without_device_raises_without_a_card(teles,
                                                            monkeypatch):
    """A pipeline built without ``device`` runs on the card: with no card
    the service's first round raises; with ``device="cpu"`` it serves."""
    _, tele = teles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [_job(i, submit=float(i), region=i % 5) for i in range(6)]
    cap = np.full(5, 2)
    loop = DecisionLoop(EventSimulator(tele, cap),
                        forecast_pipeline(tele, backend="fused", warm=True),
                        ReplayArrivals(copy.deepcopy(jobs)))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        loop.run(60.0)
    rep = DecisionLoop(EventSimulator(tele, cap),
                       forecast_pipeline(tele, backend="fused", warm=True,
                                         device="cpu"),
                       ReplayArrivals(copy.deepcopy(jobs))).run(60.0)
    assert rep.placed == 6 and rep.sinkhorn_cold_iters > 0


# ---------------------------------------------------------------------------
# Elastic restart on torch state
# ---------------------------------------------------------------------------

def _state():
    return dict(w=torch.zeros(8, 4), step=torch.zeros((), dtype=torch.int32))


def test_checkpoint_bytes_and_async_checkpointer(tmp_path):
    from repro_torch.checkpoint import (AsyncCheckpointer, checkpoint_bytes,
                                        latest_step, restore_checkpoint)
    st_ = _state()
    assert checkpoint_bytes(st_) == 8 * 4 * 4 + 4
    ck = AsyncCheckpointer(str(tmp_path), every=2)
    assert not ck.maybe_save(1, st_)
    assert ck.maybe_save(2, st_)
    st_["w"] += 1.0                         # the snapshot was taken already
    ck.wait()
    assert latest_step(str(tmp_path)) == 2 and ck.saved_steps == [2]
    back = restore_checkpoint(str(tmp_path), 2, _state())
    np.testing.assert_array_equal(back["w"], np.zeros((8, 4), np.float32))


def test_elastic_restart_exactly_recovers(tmp_path):
    """Training with injected failures ends in exactly the state of an
    uninterrupted run, with torch tensors restored as tensors (the
    reference's ``test_elastic_restart_exactly_recovers``)."""
    from repro_torch.runtime import elastic

    def step_fn(state, batch, step):
        return dict(w=state["w"] + batch, step=state["step"] + 1)

    def batch_fn(step):
        return torch.tensor(step + 1, dtype=torch.float32)

    clean = elastic.run_elastic(_state(), step_fn, batch_fn, num_steps=12,
                                ckpt_dir=str(tmp_path / "a"), ckpt_every=3)
    faulty = elastic.run_elastic(
        _state(), step_fn, batch_fn, num_steps=12,
        ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
        injector=elastic.FailureInjector(fail_after_steps=(5, 9)))
    assert clean["restarts"] == 0 and faulty["restarts"] == 2
    # The crash after step 5 restores step 3 (steps 4-5 run again); the
    # one after step 9 restores the checkpoint just taken at step 9.
    assert faulty["steps_run"] == 12 + 2
    for k in ("w", "step"):
        assert isinstance(faulty["state"][k], torch.Tensor)
        assert torch.equal(clean["state"][k], faulty["state"][k])
    assert float(clean["state"]["w"][0, 0]) == 78.0


def test_watchdog_flags_stragglers():
    from repro_torch.runtime import elastic
    wd = elastic.StepWatchdog(deadline_s=0.1)
    assert not wd.observe(0.05)
    assert wd.observe(0.5)
    assert wd.p50 == 0.5
