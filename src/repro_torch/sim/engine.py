"""Discrete-event simulation engine — replays a trace through a scheduler
(port of ``repro/sim/engine.py``'s event engine).

Schedulers are anything satisfying the uniform ``Scheduler`` protocol of
``repro_torch.policy`` — ``schedule(jobs, now_s, capacity) -> Decision`` —
which every registry policy (rule baselines, the reactive pipeline, the
forecast pipeline) implements. ``run()`` also accepts a declarative policy
spec (``"waterwise[lam_h2o=0.7,backend=torch]"`` or a
``repro_torch.policy.PolicySpec``) and builds it against the engine's
telemetry, on the CUDA card; build it with ``policy.build(spec, tele,
device=...)`` to run it elsewhere.

``EventSimulator`` holds a completion heap plus a sorted arrival cursor and
only materializes the instants where something can happen — a scheduling
round with pending jobs, a completion, a capacity event, the next arrival.
Idle stretches are skipped in O(1), per-job footprint accounting is batched
into one vectorized closed-form telemetry integration at the end of the run,
and time-varying capacity (scenario outages) is supported. ``EngineStepper``
is the same loop held open between ``step`` calls (the live-serving seam).

``WindowedSimulator`` is the original fixed-window loop, kept verbatim as
the fidelity oracle: it ticks every ``window_s`` whether or not anything
happens and prices each job with per-job sub-sampled integration. The
golden parity test (tests/test_torch_workflows.py, on the reference's
small cell) pins its records to the reference's.

Rounds happen on a ``window_s`` grid (re-anchored at each fully-idle
fast-forward): arrivals within ``window_s`` are presented to the scheduler
together (the paper's controller also "co-optimizes jobs that are invoked
together or nearby in time"). Footprints are *accounted* with the true
hourly telemetry integrated over each job's actual execution window — the
scheduler itself only ever sees the current snapshot (no future info).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import repro_torch.obs as obs
from repro_torch.core import footprint, telemetry
from repro_torch.core.problem import Job
from repro_torch.sim.cluster import Cluster


@dataclasses.dataclass
class SimConfig:
    # Scheduling-round period. Small enough that queue wait consumes little
    # of a short job's TOL budget, large enough to batch co-arriving jobs
    # (the MILP co-optimizes whole windows).
    window_s: float = 30.0
    server: footprint.ServerSpec = dataclasses.field(
        default_factory=footprint.m5_metal)
    # Account footprint with hourly integration (True) or at-start snapshot.
    integrate: bool = True


@dataclasses.dataclass
class JobRecord:
    job: Job
    region: int
    start_s: float
    finish_s: float
    carbon_g: float
    water_l: float
    # Per-region-amortized embodied carbon — a separate accounting column
    # (``carbon_g`` keeps its original operational+lifetime-share definition
    # so every pre-existing parity pin holds unchanged).
    embodied_g: float = 0.0

    @property
    def service_s(self) -> float:
        return self.finish_s - self.job.submit_time_s

    @property
    def service_ratio(self) -> float:
        return self.service_s / max(self.job.exec_time_s, 1e-9)

    @property
    def violated(self) -> bool:
        if self.job.deadline_override_s is not None:
            # Workflow task: the binding deadline is the critical-path one.
            return self.finish_s > self.job.deadline_override_s + 1e-6
        return (self.service_s >
                (1.0 + self.job.tolerance) * self.job.exec_time_s + 1e-6)


# Capacity event: at time t_s the fleet's per-region capacity becomes `cap`.
# The payload is either an absolute per-region vector, or a *relative* profile
# ``("scale", fracs)`` applied to the run's base capacity — ``fracs`` may be a
# scalar ("-30% everywhere at peak heat" == 0.7) or a per-region array.
CapacityEvent = Tuple[float, object]


@dataclasses.dataclass
class EngineState:
    """Everything a follow-on ``EventSimulator.run`` needs to continue a
    run mid-flight — the boundary-stitching handoff of sharded execution
    (``repro.experiments.shard``).

    Exported by ``run(..., stop_at=B, export_state=True)`` at the first
    loop instant at-or-past ``B`` and consumed by the next slice's
    ``run(slice_jobs, sched, state=...)``. A chained sequence of runs over
    an arrival-time partition of a trace reproduces the single unsharded
    run *exactly* — same rounds at the same instants, same placements,
    same per-job footprints — provided the scheduler object itself is
    carried across the chain (the state here covers only the engine:
    clock, grid phase, pending queue, in-flight completions, capacity and
    its event cursor, and the utilization integrals). Everything is
    plain data (floats, ``Job`` dataclasses, small arrays), so the state
    also crosses process boundaries via pickle.
    """
    now: float                      # engine clock == current grid instant
    pending: List[Job]              # arrived but not yet placed, queue order
    applied_events: int             # capacity-event cursor
    cluster: Dict                   # Cluster.export_state() payload
    rounds: int = 0                 # cumulative scheduler rounds so far
    # Workflow (DAG) carry-over. ``blocked`` holds arrived tasks whose
    # predecessors have not all finished; ``finished`` maps job_id ->
    # finish_s for every dispatched job (in-flight finishes included — the
    # release check compares against the clock, so a finish beyond ``now``
    # never releases early). Defaults keep pre-DAG states loadable.
    blocked: List[Job] = dataclasses.field(default_factory=list)
    finished: Dict[int, float] = dataclasses.field(default_factory=dict)


def resolve_scheduler(scheduler, tele):
    """Materialize ``scheduler`` against ``tele``: policy-spec strings and
    ``PolicySpec`` objects are built through the port's registry (on the
    CUDA card; build with ``policy.build(spec, tele, device=...)`` to run
    elsewhere); anything already satisfying the ``schedule()`` protocol
    passes through untouched."""
    from repro_torch import policy
    if isinstance(scheduler, (str, policy.PolicySpec)):
        return policy.build(scheduler, tele)
    return scheduler


def resolve_capacity(payload, base: np.ndarray) -> np.ndarray:
    """Materialize a capacity-event payload against the base capacity."""
    if isinstance(payload, tuple) and len(payload) == 2 \
            and payload[0] == "scale":
        frac = np.asarray(payload[1], np.float64)
        return np.maximum(np.round(base * frac), 0).astype(np.int64)
    return np.asarray(payload, np.int64)


class EventSimulator:
    """Event-driven engine (see module docstring)."""

    def __init__(self, tele: telemetry.Telemetry, capacity: np.ndarray,
                 config: Optional[SimConfig] = None,
                 capacity_events: Optional[Sequence[CapacityEvent]] = None):
        self.tele = tele
        self.capacity = np.asarray(capacity, np.int64)
        self.cfg = config or SimConfig()
        self.capacity_events = sorted(capacity_events or [],
                                      key=lambda e: e[0])

    # -- batched footprint accounting ---------------------------------------

    def _account_all(self, placed: List[Tuple[Job, int, float, float]]
                     ) -> Tuple[List[JobRecord], Dict[str, np.ndarray]]:
        """One vectorized accounting pass over every placed job.

        Returns the per-job records plus a columnar *frame* of the same
        data (placement order preserved): metrics aggregation
        (``sim.metrics.summarize``, stress-weighted water) runs on the
        arrays instead of looping over 100k+ record objects, and sharded
        workers ship the frame across process boundaries instead of
        pickling record lists. Frames from an arrival-time-sharded run
        concatenate into exactly the serial run's frame, so array
        reductions over them are bit-identical.
        """
        n = len(placed)
        if not placed:
            return [], {k: np.zeros(0) for k in
                        ("job_id", "region", "home_region", "start_s",
                         "finish_s", "submit_s", "exec_s", "tolerance",
                         "carbon_g", "water_l", "embodied_g", "deadline_s")}
        te = self.tele
        region = np.fromiter((p[1] for p in placed), np.int64, n)
        start = np.fromiter((p[2] for p in placed), np.float64, n)
        t_eff = np.fromiter(
            (p[0].exec_time_s * p[0].time_scale for p in placed),
            np.float64, n)
        e_eff = np.fromiter(
            (p[0].energy_kwh * p[0].energy_scale for p in placed),
            np.float64, n)
        if self.cfg.integrate:
            m = te.mean_over(start, start + t_eff)
        else:
            m = te.at_many(start)
        rows = np.arange(n)
        ci = m["ci"][rows, region]
        ewif = m["ewif"][rows, region]
        wue = m["wue"][rows, region]
        server = self.cfg.server
        carbon = footprint.job_carbon(e_eff, t_eff, ci, server)
        water = footprint.job_water(e_eff, t_eff, te.pue[region], ewif, wue,
                                    te.wsf[region], server)
        servers = np.fromiter((p[0].servers for p in placed), np.float64, n)
        embodied = footprint.job_embodied(
            t_eff, server,
            region_scale=footprint.region_embodied_scale(te.num_regions)[
                region],
            servers=servers)
        frame = dict(
            job_id=np.fromiter((p[0].job_id for p in placed), np.int64, n),
            region=region,
            home_region=np.fromiter((p[0].home_region for p in placed),
                                    np.int64, n),
            start_s=start,
            finish_s=np.fromiter((p[3] for p in placed), np.float64, n),
            submit_s=np.fromiter((p[0].submit_time_s for p in placed),
                                 np.float64, n),
            exec_s=np.fromiter((p[0].exec_time_s for p in placed),
                               np.float64, n),
            tolerance=np.fromiter((p[0].tolerance for p in placed),
                                  np.float64, n),
            carbon_g=np.asarray(carbon, np.float64),
            water_l=np.asarray(water, np.float64),
            embodied_g=np.asarray(embodied, np.float64),
            # Critical-path deadline (NaN for plain jobs) — lets metrics
            # compute override-aware violation rates on the frame alone.
            deadline_s=np.fromiter(
                (np.nan if p[0].deadline_override_s is None
                 else p[0].deadline_override_s for p in placed),
                np.float64, n))
        records = [JobRecord(job, int(nn), float(s), float(f), float(c),
                             float(w), float(g))
                   for (job, nn, s, f), c, w, g in zip(placed, carbon, water,
                                                       embodied)]
        return records, frame

    # -- trace series --------------------------------------------------------

    def _emit_series(self, tr, frame: Dict[str, np.ndarray],
                     horizon: float) -> None:
        """Retroactive simulated-time counter tracks: hourly per-region
        carbon/water (accounted footprints bucketed by start hour) plus the
        WUE truth series — rendered by ``repro.obs.report`` and shown on
        their own Perfetto track (``pid = obs.SIM_PID``, sim-hours as the
        time axis)."""
        H = int(np.ceil(horizon / telemetry.HOUR))
        if H <= 0 or not len(frame["start_s"]):
            return
        R = self.tele.num_regions
        hr = np.minimum((frame["start_s"] // telemetry.HOUR).astype(np.int64),
                        H - 1)
        region = frame["region"].astype(np.int64)
        carbon = np.zeros((H, R))
        water = np.zeros((H, R))
        np.add.at(carbon, (hr, region), frame["carbon_g"])
        np.add.at(water, (hr, region), frame["water_l"])
        labels = [f"R{j}" for j in range(R)]
        for h in range(H):
            ts = h * telemetry.HOUR * 1e6
            wue = self.tele.at(h * telemetry.HOUR)["wue"]
            tr.counter("sim/carbon_g",
                       {lb: float(v) for lb, v in zip(labels, carbon[h])},
                       ts_us=ts, pid=obs.SIM_PID)
            tr.counter("sim/water_L",
                       {lb: float(v) for lb, v in zip(labels, water[h])},
                       ts_us=ts, pid=obs.SIM_PID)
            tr.counter("sim/wue",
                       {lb: float(v) for lb, v in zip(labels, wue)},
                       ts_us=ts, pid=obs.SIM_PID)

    # -- main loop -----------------------------------------------------------

    def stepper(self, scheduler, jobs: Sequence[Job] = (), *,
                state: Optional[EngineState] = None,
                hold_grid: bool = False) -> "EngineStepper":
        """A stepable handle on this engine: the same loop as ``run()`` held
        open between ``step(until_s)`` calls, with ``inject()`` feeding live
        arrivals. See :class:`EngineStepper`."""
        return EngineStepper(self, scheduler, jobs, state=state,
                             hold_grid=hold_grid)

    def run(self, jobs: Sequence[Job], scheduler, *,
            state: Optional[EngineState] = None,
            stop_at: Optional[float] = None,
            export_state: bool = False,
            hold_grid: bool = False) -> Dict:
        """Replay ``jobs`` through ``scheduler``.

        ``state`` resumes a previous run's exported ``EngineState`` (the
        sharded-execution handoff); ``stop_at=B`` halts the loop at the
        first instant at-or-past ``B`` — pretending further arrivals exist
        beyond ``B`` rather than draining/stalling, so a later resumed run
        observes exactly the engine a single uninterrupted run would have
        had there; ``export_state=True`` attaches the boundary state as
        ``result["state"]``. Chained ``run(slice, ..., state=prev)`` calls
        over an arrival-time partition reproduce the unsharded run
        bit-for-bit (pinned in tests/test_experiments.py).

        ``hold_grid=True`` ticks the round grid through idle stretches
        instead of re-anchoring at the next arrival. A *speculative*
        warm-up run (sharded execution) starts from an empty fleet that
        the real run would have had busy; holding the grid keeps its round
        instants bit-aligned with the real run's ``now += w``
        accumulation, so the warm-up can converge to the exact engine
        state of the unsharded run at the shard boundary.

        Implemented on top of :class:`EngineStepper` — one ``step(stop_at)``
        to the boundary (or to drain) plus the accounting pass — so batch
        replay and live serving share the loop verbatim.
        """
        st = self.stepper(scheduler, jobs, state=state, hold_grid=hold_grid)
        st.step(stop_at)
        return st.result(export_state=export_state)


class EngineStepper:
    """The event-engine loop as a stepable object (live-serving seam).

    Holds every loop variable of the classic ``EventSimulator.run`` —
    clock, grid phase, arrival cursor, pending queue, cluster, capacity-
    event cursor — between calls, so the same engine powers both execution
    modes:

      * **batch replay**: construct with the whole trace, ``step(None)``
        runs to drain — ``EventSimulator.run`` is exactly this plus the
        accounting pass, so parity is by construction;
      * **live serving** (``repro.serve``): ``inject(new_jobs)`` then
        ``step(t_round)`` per decision round. ``step(until_s)`` uses the
        ``stop_at`` boundary semantics proven bit-exact by the sharded
        chained-handoff tests: the engine behaves as if further arrivals
        exist beyond ``until_s``, so a stream fed chunk-by-chunk at round
        boundaries reproduces the batch replay of the same arrivals
        bit-for-bit (pinned in tests/test_serve.py).

    ``step`` may be called after the loop went idle (everything drained);
    a later ``inject`` + ``step`` resumes exactly like a chained
    ``run(state=...)`` handoff would.
    """

    def __init__(self, sim: "EventSimulator", scheduler,
                 jobs: Sequence[Job] = (), *,
                 state: Optional[EngineState] = None,
                 hold_grid: bool = False):
        self.sim = sim
        self.scheduler = resolve_scheduler(scheduler, sim.tele)
        self.hold_grid = hold_grid
        self.jobs: List[Job] = sorted(jobs, key=lambda j: j.submit_time_s)
        self._submit: List[float] = [j.submit_time_s for j in self.jobs]
        self.cluster = Cluster(sim.capacity)
        self.placed: List[Tuple[Job, int, float, float]] = []
        self.pending: List[Job] = []
        self.blocked: List[Job] = []        # arrived, predecessors unfinished
        self._finish: Dict[int, float] = {}  # job_id -> finish_s at dispatch
        self.i = 0          # arrival cursor
        self.ce = 0         # capacity-event cursor
        self.now = 0.0
        self.prior_rounds = 0
        if state is not None:
            self.cluster.restore_state(state.cluster)
            self.pending = list(state.pending)
            self.blocked = list(state.blocked)
            self._finish = dict(state.finished)
            self.ce = int(state.applied_events)
            self.now = float(state.now)
            self.prior_rounds = int(state.rounds)
        self.rounds = 0
        self.stalls = 0

    def inject(self, jobs: Sequence[Job]) -> int:
        """Feed live arrivals into the un-consumed tail of the trace.

        The tail is re-sorted by submit time (stable), so time-ordered
        chunks — every arrival source in ``repro.serve`` polls in submit
        order — leave the consumption order identical to a single up-front
        sort of the whole trace. Returns the number of injected jobs.
        """
        new = list(jobs)
        if not new:
            return 0
        tail = self.jobs[self.i:] + new
        tail.sort(key=lambda j: j.submit_time_s)
        del self.jobs[self.i:]
        self.jobs.extend(tail)
        del self._submit[self.i:]
        self._submit.extend(j.submit_time_s for j in tail)
        return len(new)

    def next_arrival_s(self) -> Optional[float]:
        """Submit time of the next un-consumed arrival, if any."""
        if self.i < len(self.jobs):
            return self.jobs[self.i].submit_time_s
        return None

    def step(self, until_s: Optional[float] = None) -> float:
        """Advance the engine to the first loop instant at-or-past
        ``until_s`` (the ``stop_at`` boundary semantics), or to full drain
        when ``until_s`` is ``None``. Returns the engine clock."""
        sim = self.sim
        stop_at = until_s
        w = sim.cfg.window_s
        scheduler = self.scheduler
        jobs = self.jobs
        cluster = self.cluster
        cap_events = sim.capacity_events
        placed = self.placed
        pending = self.pending
        blocked = self.blocked
        finished = self._finish
        i = self.i
        ce = self.ce
        now = self.now
        rounds = self.rounds
        stalls = self.stalls
        hold_grid = self.hold_grid
        n_jobs = len(jobs)
        submit = self._submit
        while i < n_jobs or pending or blocked or cluster.busy_any():
            if stop_at is not None and now >= stop_at:
                break
            while ce < len(cap_events) and cap_events[ce][0] <= now:
                t_event, payload = cap_events[ce]
                # Settle busy/provisioned integrals up to the event instant
                # so the capacity change is not billed retroactively.
                cluster.advance(t_event)
                cluster.set_capacity(resolve_capacity(payload, sim.capacity))
                ce += 1
            cluster.advance(now)
            while i < n_jobs and submit[i] <= now:
                # Precedence routing: a DAG task is not *schedulable* until
                # every predecessor has finished — it arrives into ``blocked``
                # and the release pass below moves it to ``pending``. Plain
                # jobs keep their exact pre-DAG path.
                (blocked if jobs[i].deps else pending).append(jobs[i])
                i += 1
            if blocked:
                # Release pass: a task becomes schedulable at the first loop
                # instant at-or-past its last predecessor's finish. Stable
                # order; identical in batch replay and streaming (same code,
                # same instants), so DAG parity holds by construction.
                still: List[Job] = []
                for job in blocked:
                    fins = [finished.get(d) for d in job.deps]
                    if all(f is not None and f <= now + 1e-9 for f in fins):
                        pending.append(job)
                    else:
                        still.append(job)
                blocked = still
            progressed = False
            if pending:
                with obs.span("engine.round", now_s=now,
                              pending=len(pending)) as sp:
                    dec = scheduler.schedule(pending, now, cluster.free())
                    progressed = bool(dec.scheduled)
                    for job, n in zip(dec.scheduled, dec.assign):
                        n = int(n)
                        lat = sim.tele.transfer_latency_s(job.package_bytes,
                                                          job.home_region, n)
                        start = now + lat
                        if job.planned_start_s is not None:
                            start = max(start, job.planned_start_s)
                        finish = start + job.exec_time_s * job.time_scale
                        cluster.dispatch(n, finish)
                        job.start_time_s, job.finish_time_s = start, finish
                        finished[job.job_id] = finish
                        placed.append((job, n, start, finish))
                    sp.set(scheduled=len(dec.scheduled),
                           deferred=len(dec.deferred))
                    pending = list(dec.deferred)
                    rounds += 1
                if obs.enabled():
                    tr = obs.tracer()
                    if tr is not None:
                        tr.counter("engine/queue", {
                            "pending": len(pending),
                            "scheduled": len(dec.scheduled)})
            # Deadlock guard: pending jobs that no scheduler round can place
            # and no running job will ever release capacity for. A future
            # capacity event may still unblock them (outage restoration), and
            # a temporal-shifting scheduler may be holding them *on purpose*
            # (Decision.wake_s names its planned release) — fast-forward to
            # the earlier of the two rather than stalling out. With a
            # ``stop_at`` boundary, later slices hold more arrivals, so a
            # single uninterrupted run would never take this branch here
            # (its arrival cursor is not exhausted) — skip it and keep
            # rounds marching toward the boundary instead.
            if stop_at is None and pending and not progressed \
                    and not cluster.busy_any() and i >= n_jobs:
                wake = getattr(dec, "wake_s", None)
                targets = []
                if ce < len(cap_events):
                    targets.append(max(cap_events[ce][0], now))
                if wake is not None and wake > now + 1e-9:
                    targets.append(wake)
                if targets:
                    stalls = 0
                    now = min(targets)
                    continue
                stalls += 1
                if stalls > 2:
                    break
            else:
                stalls = 0
            # ---- jump to the next instant anything can happen -------------
            if pending:
                now += w                      # next round on the grid
            elif blocked and cluster.busy_any():
                # A completion may release a blocked task; releases happen on
                # the grid, so tick one window (same float accumulation in
                # batch and stream — parity by construction).
                now += w
            elif i < n_jobs:
                nxt = submit[i]
                if cluster.busy_any():
                    # Tick the grid forward (same float accumulation as the
                    # windowed engine) until either the next arrival falls
                    # inside a window or the fleet drains — draining first
                    # re-anchors the grid at the arrival, exactly like the
                    # windowed engine's idle fast-forward.
                    drain = cluster.drain_time()
                    t = now + w
                    while t < nxt and drain > t:
                        t += w
                    now = t if t >= nxt else nxt
                elif hold_grid:
                    # Speculative warm-up: the real fleet would be busy
                    # here, so keep accumulating the grid instead of
                    # re-anchoring at the arrival.
                    t = now + w
                    while t < nxt:
                        t += w
                    now = t
                else:
                    now = nxt                 # fully idle: fast-forward
            elif cluster.busy_any():
                if stop_at is None:
                    now = cluster.drain_time()   # no more work: drain, stop
                else:
                    # Next arrivals live beyond the handoff boundary: tick
                    # the grid toward it exactly as the single run would
                    # tick toward that (>= stop_at) arrival, preserving the
                    # float-accumulated grid phase across the handoff.
                    drain = cluster.drain_time()
                    t = now + w
                    while t < stop_at and drain > t:
                        t += w
                    now = t
            else:
                break
        self.pending = pending
        self.blocked = blocked
        self.i = i
        self.ce = ce
        self.now = now
        self.rounds = rounds
        self.stalls = stalls
        return now

    def result(self, export_state: bool = False) -> Dict:
        """Settle the utilization integrals at the current clock, run the
        batched accounting pass over everything placed so far, and build the
        engine result dict (same shape as ``EventSimulator.run``'s)."""
        sim = self.sim
        cluster = self.cluster
        pending = self.pending
        now = self.now
        cluster.advance(now)
        horizon = max(now, cluster.drain_time(), 1.0)
        records, frame = sim._account_all(self.placed)
        if obs.enabled():
            obs.observe("engine.pending_depth", float(len(pending)))
            tr = obs.tracer()
            if tr is not None:
                sim._emit_series(tr, frame, horizon)
        rounds = self.prior_rounds + self.rounds
        result = dict(records=records, frame=frame,
                      windows=rounds,
                      rounds=rounds,
                      solve_times=np.asarray(getattr(self.scheduler,
                                                     "solve_times", [])),
                      utilization=cluster.utilization(horizon),
                      peak_busy=cluster.peak_busy.copy(),
                      horizon_s=horizon,
                      drain_s=cluster.drain_time(),
                      busy_integral_s=cluster.busy_integral_s,
                      cap_integral_s=cluster.cap_integral_s,
                      unfinished=(len(pending) + len(self.blocked)
                                  + (len(self.jobs) - self.i)))
        if export_state:
            # Arrivals the loop never consumed (all below ``stop_at`` by
            # slicing) join the carried queues in submit order — exactly the
            # order the single run would have appended them in. DAG-tail
            # tasks join ``blocked`` (the single run's arrival pop routes
            # dep-carrying jobs there, and its release pass — which runs
            # *after* the pop — appends the ready ones to pending after the
            # plain arrivals), so the restored run reproduces the single
            # run's queue order exactly.
            tail = self.jobs[self.i:]
            result["state"] = EngineState(
                now=now,
                pending=pending + [j for j in tail if not j.deps],
                applied_events=self.ce,
                cluster=cluster.export_state(),
                rounds=rounds,
                blocked=self.blocked + [j for j in tail if j.deps],
                finished=dict(self._finish))
        return result


class WindowedSimulator:
    """The original fixed-window engine — kept as the golden-parity oracle.

    Spins the ``window_s`` grid through idle time and prices each job with
    per-job sub-sampled integration (``Telemetry.mean_between``). Quadratic
    in trace span; use only for small fidelity checks.
    """

    def __init__(self, tele: telemetry.Telemetry, capacity: np.ndarray,
                 config: Optional[SimConfig] = None):
        self.tele = tele
        self.capacity = np.asarray(capacity, np.int64)
        self.cfg = config or SimConfig()

    # -- footprint accounting ------------------------------------------------

    def _account(self, job: Job, region: int, start_s: float):
        t_eff = job.exec_time_s * job.time_scale
        e_eff = job.energy_kwh * job.energy_scale
        te = self.tele
        if self.cfg.integrate:
            m = te.mean_between(start_s, start_s + t_eff)
            ci = float(m["ci"][region])
            ewif = float(m["ewif"][region])
            wue = float(m["wue"][region])
        else:
            snap = te.at(start_s)
            ci, ewif, wue = (snap["ci"][region], snap["ewif"][region],
                             snap["wue"][region])
        server = self.cfg.server
        carbon = float(footprint.job_carbon(e_eff, t_eff, ci, server))
        water = float(footprint.job_water(e_eff, t_eff, te.pue[region], ewif,
                                          wue, te.wsf[region], server))
        embodied = float(footprint.job_embodied(
            t_eff, server,
            region_scale=float(
                footprint.region_embodied_scale(te.num_regions)[region]),
            servers=job.servers))
        return carbon, water, embodied

    # -- main loop -----------------------------------------------------------

    def run(self, jobs: Sequence[Job], scheduler) -> Dict:
        scheduler = resolve_scheduler(scheduler, self.tele)
        jobs = sorted(jobs, key=lambda j: j.submit_time_s)
        cluster = Cluster(self.capacity)
        records: List[JobRecord] = []
        pending: List[Job] = []
        i = 0
        now = 0.0
        windows = 0
        rounds = 0
        stalls = 0
        while i < len(jobs) or pending or cluster.busy.any():
            cluster.advance(now)
            while i < len(jobs) and jobs[i].submit_time_s <= now:
                pending.append(jobs[i])
                i += 1
            progressed = False
            if pending:
                dec = scheduler.schedule(pending, now, cluster.free())
                progressed = bool(dec.scheduled)
                for job, n in zip(dec.scheduled, dec.assign):
                    n = int(n)
                    lat = self.tele.transfer_latency_s(job.package_bytes,
                                                       job.home_region, n)
                    start = now + lat
                    if job.planned_start_s is not None:
                        start = max(start, job.planned_start_s)
                    finish = start + job.exec_time_s * job.time_scale
                    cluster.dispatch(n, finish)
                    job.start_time_s, job.finish_time_s = start, finish
                    carbon, water, embodied = self._account(job, n, start)
                    records.append(JobRecord(job, n, start, finish, carbon,
                                             water, embodied))
                pending = list(dec.deferred)
                rounds += 1
            windows += 1
            if i < len(jobs) and not pending and not cluster.busy.any():
                now = jobs[i].submit_time_s      # fast-forward idle gaps
            else:
                now += self.cfg.window_s
            # Deadlock guard: pending jobs that no scheduler round can place
            # and no running job will ever release capacity for. A scheduler
            # holding jobs on purpose (Decision.wake_s) keeps ticking — the
            # windowed engine spins the grid rather than jumping.
            if pending and not progressed and not cluster.busy.any() \
                    and i >= len(jobs):
                wake = getattr(dec, "wake_s", None)
                if wake is not None and wake > now:
                    stalls = 0
                else:
                    stalls += 1
                    if stalls > 2:
                        break
            else:
                stalls = 0
        return dict(records=records, windows=windows, rounds=rounds,
                    solve_times=np.asarray(getattr(scheduler, "solve_times",
                                                   [])),
                    utilization=cluster.utilization(max(now, 1.0)),
                    peak_busy=cluster.peak_busy.copy(),
                    horizon_s=max(now, 1.0),
                    unfinished=len(pending))


# The event-driven engine is the default.
Simulator = EventSimulator
