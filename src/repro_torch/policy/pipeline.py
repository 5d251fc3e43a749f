"""One composable scheduling pipeline — paper §4 Algorithm 1, decomposed
(the reactive part of ``repro/policy/pipeline.py``, ported).

A ``PolicyPipeline`` is assembled from composable stages:

  ``Pricer``          turns a scheduling round into a priced, arc-masked
                      assignment plan.  ``SnapshotPricer`` prices every job
                      at the live telemetry snapshot and offers one virtual
                      defer arc at the trailing-mean cost (the paper's
                      myopic controller).
  ``DeferralPolicy``  owns jobs the solver decided to hold.
                      ``NextRoundDeferral`` simply re-offers them next round
                      (reactive defer arc).
  solver backend      any ``repro_torch.core.solvers`` backend name; hard
                      solve with soft (Eqs 12-13) fallback is pipeline
                      logic. The pipeline's ``device`` reaches the device
                      backends (``torch``, ``fused``).

All stages speak one protocol — ``schedule(jobs, now_s, capacity) ->
Decision``. The forecast-driven stages (``ForecastPricer``,
``QueueDeferral``, ``ReplanQueueDeferral``, ``forecast_pipeline``) and
offline window replay are not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

import repro_torch.obs as obs
from repro_torch.core import footprint, problem, slack, solvers, telemetry


@dataclasses.dataclass
class Decision:
    """One scheduling-round outcome (the uniform scheduler protocol's
    return value — rule baselines, the reactive pipeline, and the forecast
    pipeline all produce exactly this)."""
    scheduled: List[problem.Job]       # jobs with .region set by this round
    assign: np.ndarray                 # [len(scheduled)] region index
    deferred: List[problem.Job]        # jobs pushed to the next round
    solver: Optional[solvers.SolveResult]
    softened: bool
    # Earliest instant the scheduler plans to act on a held job. The engine
    # fast-forwards to it instead of stalling out when the fleet is idle and
    # no arrivals remain (temporal shifting holds jobs *on purpose*).
    wake_s: Optional[float] = None


@runtime_checkable
class Scheduler(Protocol):
    """What the simulation engines drive: one round, one ``Decision``."""

    def schedule(self, jobs: Sequence[problem.Job], now_s: float,
                 capacity: np.ndarray) -> Decision: ...


class HistoryLearner:
    """Trailing-window mean of regional carbon/water intensity.

    Two uses: (a) the normalized CO2_ref / H2O_ref of Eq (8) — regions that
    have *recently* been dirty/thirsty are discouraged even if momentarily
    attractive; (b) the raw trailing means price the *defer* arc — the
    expected cost of waiting for a more typical hour (window=10, λ_ref=0.1
    per §5)."""

    def __init__(self, num_regions: int, window: int = 10,
                 raw_window: int = 240):
        self.window = window
        self.ci = collections.deque(maxlen=window)
        self.wi = collections.deque(maxlen=window)
        # "Typical conditions" need a longer horizon than the Eq-8 ref term:
        # 240 rounds ≈ 2 h at the default 30 s scheduling period. Stored as a
        # ring buffer ([raw_window, 3, R]) — the per-round mean is one
        # vectorized reduction instead of rebuilding arrays from a deque of
        # dicts (this is on the simulator's per-round hot path).
        self.raw_window = raw_window
        self._raw = np.zeros((raw_window, 3, num_regions))
        self._raw_n = 0          # total observations so far
        self.num_regions = num_regions

    def observe(self, snap) -> None:
        ci, wi = snap["ci"], snap["water_intensity"]
        self.ci.append(ci / max(ci.max(), 1e-9))
        self.wi.append(wi / max(wi.max(), 1e-9))
        self._raw[self._raw_n % self.raw_window, 0] = ci
        self._raw[self._raw_n % self.raw_window, 1] = snap["ewif"]
        self._raw[self._raw_n % self.raw_window, 2] = snap["wue"]
        self._raw_n += 1

    @property
    def co2_ref(self) -> Optional[np.ndarray]:
        return np.mean(self.ci, axis=0) if self.ci else None

    @property
    def h2o_ref(self) -> Optional[np.ndarray]:
        return np.mean(self.wi, axis=0) if self.wi else None

    def mean_raw(self) -> Optional[dict]:
        if self._raw_n < 2:
            return None
        m = self._raw[:min(self._raw_n, self.raw_window)].mean(axis=0)
        return dict(ci=m[0], ewif=m[1], wue=m[2])


# ---------------------------------------------------------------------------
# Priced plans
# ---------------------------------------------------------------------------

# Decode actions: what one solver column means for a job.
RUN, HOLD, DEFER = "run", "hold", "defer"


@dataclasses.dataclass
class PricedPlan:
    """One round's priced, arc-masked assignment instance.

    Columns are whatever the pricer decided to offer — N regions, N regions
    plus a virtual defer arc, or N·S (region, slot) cells. ``overrun`` is
    carried per column so the soft-violation bookkeeping and window
    recording stay uniform across pricers.
    """
    cost: np.ndarray               # [M, C]
    allowed: np.ndarray            # [M, C]
    capacity: np.ndarray           # [C]
    overrun: np.ndarray            # [M, C]
    num_regions: int
    num_slots: int = 1
    slot_offsets: Optional[np.ndarray] = None   # [S] (forecast pricer only)
    # Slot-0 objective matrix when the pricer already computed it (reused by
    # the soft fallback instead of re-deriving from the instance).
    base_cost: Optional[np.ndarray] = None
    # Hard-solve result when the pricer already ran the solver as part of a
    # fused pricing+solving device program (``repro.core.round``); the
    # pipeline uses it instead of dispatching ``solvers.solve`` again.
    presolved: Optional[solvers.SolveResult] = None


class Pricer:
    """Stage 1: price one scheduling round into a ``PricedPlan``."""

    def bind(self, pipeline: "PolicyPipeline") -> None:
        self.pipe = pipeline

    def price(self, jobs: Sequence[problem.Job], now_s: float,
              inst: problem.ProblemInstance, snap: dict) -> PricedPlan:
        raise NotImplementedError

    def decode(self, plan: PricedPlan, col: int, now_s: float
               ) -> Tuple[str, Optional[float]]:
        """Column index -> (action, payload): (RUN, region), (HOLD,
        release_s) or (DEFER, None)."""
        raise NotImplementedError


class SnapshotPricer(Pricer):
    """Reactive pricing (the paper's myopic controller): every job is priced
    at the *current* telemetry snapshot, plus one virtual defer column priced
    at the trailing-mean cost + a margin (the delay-tolerance exploitation of
    paper Fig 5). The solver sends a job there exactly when *now* is a
    worse-than-typical hour everywhere it could run — it then waits for the
    next round. Arc-filtered by remaining slack so tolerance is never
    risked."""

    def __init__(self, defer_margin: float = 0.02,
                 defer_slack_s: float = 120.0):
        # Defer arc: waiting is priced at the trailing-mean cost plus a
        # margin; only jobs with > defer_slack_s of remaining TOL budget may
        # take it (they must still fit a later round + transfer).
        self.defer_margin = defer_margin
        self.defer_slack_s = defer_slack_s

    def price(self, jobs, now_s, inst, snap) -> PricedPlan:
        pipe = self.pipe
        history = pipe.history
        cost = inst.objective_matrix(pipe.lam_co2, pipe.lam_h2o, pipe.lam_ref,
                                     history.co2_ref, history.h2o_ref,
                                     lam_emb=pipe.lam_emb)
        capacity = np.asarray(inst.capacity)
        hist = history.mean_raw()
        if hist is None:
            return PricedPlan(cost=cost, allowed=inst.allowed,
                              capacity=capacity, overrun=inst.overrun,
                              num_regions=inst.shape[1], base_cost=cost)
        h_co2 = footprint.job_carbon(
            np.array([j.energy_kwh for j in jobs])[:, None],
            np.array([j.exec_time_s for j in jobs])[:, None],
            hist["ci"][None, :], pipe.server)
        h_h2o = footprint.job_water(
            np.array([j.energy_kwh for j in jobs])[:, None],
            np.array([j.exec_time_s for j in jobs])[:, None],
            snap["pue"][None, :], hist["ewif"][None, :],
            hist["wue"][None, :], snap["wsf"][None, :], pipe.server)
        h_obj = (pipe.lam_co2 * h_co2 / inst.co2_max[:, None]
                 + pipe.lam_h2o * h_h2o / inst.h2o_max[:, None])
        if pipe.lam_emb and inst.emb is not None:
            # Embodied amortization is time-invariant: waiting does not make
            # the fleet's embodied carbon cheaper, so the defer arc carries
            # the same per-region embodied term as the real arcs.
            h_obj = h_obj + pipe.lam_emb * inst.emb / inst.emb_max[:, None]
        # Same λ_ref history term as the real arcs — the defer arc must be
        # compared apples-to-apples or it is uniformly cheaper and every job
        # waits unconditionally (no temporal signal).
        if history.co2_ref is not None:
            h_obj = h_obj + pipe.lam_ref * (
                pipe.lam_co2 * history.co2_ref
                + pipe.lam_h2o * history.h2o_ref)[None, :]
        defer_cost = h_obj.min(axis=1) + self.defer_margin
        # ONE vectorized slack expression (problem.slack_budget) shared with
        # core.slack and the temporal planner — bit-identical to the former
        # per-job method loop; this runs every scheduling round.
        slack_left = problem.slack_budget(jobs, now_s)
        can_wait = slack_left > self.defer_slack_s
        return PricedPlan(
            cost=np.concatenate([cost, defer_cost[:, None]], axis=1),
            allowed=np.concatenate([inst.allowed, can_wait[:, None]], axis=1),
            capacity=np.concatenate([capacity, [len(jobs)]]),
            overrun=np.concatenate(
                [inst.overrun, np.zeros((len(jobs), 1))], axis=1),
            num_regions=inst.shape[1], base_cost=cost)

    def decode(self, plan, col, now_s):
        if col < plan.num_regions:
            return RUN, col
        return DEFER, None           # the virtual defer arc: retry next round


# ---------------------------------------------------------------------------
# Deferral policies
# ---------------------------------------------------------------------------

class DeferralPolicy:
    """Stage 3: what happens to jobs the solver decided not to run now."""

    def bind(self, pipeline: "PolicyPipeline") -> None:
        self.pipe = pipeline

    def admit(self, jobs: Sequence[problem.Job], now_s: float,
              capacity: Optional[int] = None
              ) -> Tuple[List[problem.Job], List[problem.Job]]:
        """Split the pending set into (due now, still intentionally held).
        ``capacity`` is the round's total free seats — policies that add
        rows (re-planning) use it to never displace genuinely due jobs."""
        return list(jobs), []

    def hold(self, job: problem.Job, release_s: float, now_s: float) -> None:
        """Record an intentional hold until ``release_s`` (HOLD decode)."""
        raise NotImplementedError

    def revise(self, job: problem.Job, action: str, payload, plan: PricedPlan,
               row: int, col: int, now_s: float) -> Tuple[str, Optional[float]]:
        """Last look at a decoded (action, payload) before it is applied —
        the hook where re-planning policies veto churn (see
        ``ReplanQueueDeferral``). Default: pass through."""
        return action, payload

    def wake_s(self) -> Optional[float]:
        """Earliest planned release (``Decision.wake_s``), if any."""
        return None


class NextRoundDeferral(DeferralPolicy):
    """Reactive deferral: a deferred job simply returns with the next
    round's pending set — no planned release, no engine wake-up."""


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

class PolicyPipeline:
    """Algorithm 1 over pluggable stages; ``schedule()`` is one invocation."""

    def __init__(self, tele: telemetry.Telemetry, pricer: Pricer,
                 deferral: Optional[DeferralPolicy] = None, *,
                 server: footprint.ServerSpec = None,
                 lam_co2: float = 0.5, lam_h2o: float = 0.5,
                 lam_ref: float = 0.1, window: int = 10,
                 sigma: float = 10.0, backend: str = "flow",
                 lam_emb: float = 0.0, device=None):
        assert abs(lam_co2 + lam_h2o + lam_emb - 1.0) < 1e-9, \
            "footprint weights must sum to 1"
        self.tele = tele
        self.server = server or footprint.m5_metal()
        self.lam_co2, self.lam_h2o, self.lam_ref = lam_co2, lam_h2o, lam_ref
        self.lam_emb = lam_emb
        self.sigma = sigma
        self.backend = backend
        # Device of the device backends: None is the CUDA card (and raises
        # without one); "cpu" runs them on the host.
        self.device = device
        self.history = HistoryLearner(tele.num_regions, window)
        self.solve_times: List[float] = []
        self.pricer = pricer
        self.deferral = deferral or NextRoundDeferral()
        self.pricer.bind(self)
        self.deferral.bind(self)

    def __getattr__(self, name: str):
        # Stage-specific surface (forecast_mape, queue, mean_defer_s, ...)
        # is reachable on the pipeline itself, so consumers can probe
        # capabilities with hasattr() regardless of configuration.
        if name.startswith("__"):
            raise AttributeError(name)
        for stage_attr in ("pricer", "deferral"):
            stage = self.__dict__.get(stage_attr)
            if stage is not None and hasattr(stage, name):
                return getattr(stage, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    # -- Algorithm 1 ---------------------------------------------------------

    def schedule(self, jobs: Sequence[problem.Job], now_s: float,
                 capacity: np.ndarray) -> Decision:
        jobs = list(jobs)                                    # J_all (line 3)
        if not jobs:
            return Decision([], np.zeros(0, np.int64), [], None, False)

        with obs.span("policy.admit", pending=len(jobs)):
            due, held = self.deferral.admit(jobs, now_s,
                                            capacity=int(capacity.sum()))
            if not due:
                return Decision([], np.zeros(0, np.int64), held, None, False,
                                wake_s=self.deferral.wake_s())

            total_cap = int(capacity.sum())
            deferred: List[problem.Job] = []
            if len(due) > total_cap:                         # lines 5-7
                due, deferred = slack.pick_most_urgent(
                    due, now_s, total_cap, bw_gbps=self.tele.wan_bw_gbps,
                    rtt_s=self.tele.wan_rtt_s)
            if not due:
                return Decision([], np.zeros(0, np.int64), deferred + held,
                                None, False, wake_s=self.deferral.wake_s())

        with obs.span("policy.build", jobs=len(due)):
            snap = self.tele.at(now_s)
            self.history.observe(snap)
            inst = problem.build(due, self.tele, now_s, capacity, self.server,
                                 snap=snap)
            tol = np.array([j.tolerance for j in due])
        with obs.span("policy.price", jobs=len(due)):
            plan = self.pricer.price(due, now_s, inst, snap)

        softened = False
        with obs.span("policy.solve", jobs=len(due),
                      presolved=plan.presolved is not None):
            if plan.presolved is not None:
                res = plan.presolved
            else:
                res = solvers.solve(plan.cost, plan.allowed, plan.capacity,
                                    backend=self.backend, soften=False,
                                    overrun=plan.overrun, tol=tol,
                                    sigma=self.sigma, device=self.device)
            if not res.feasible:                             # lines 10-11
                # Soft fallback is slot-0 only: a job that must overrun its
                # tolerance should pay the Eq 12-13 penalty and run *now*,
                # not hide in a future slot or behind the defer arc.
                softened = True
                cost0 = plan.base_cost
                if cost0 is None:
                    cost0 = inst.objective_matrix(self.lam_co2, self.lam_h2o,
                                                  self.lam_ref,
                                                  self.history.co2_ref,
                                                  self.history.h2o_ref,
                                                  lam_emb=self.lam_emb)
                res = solvers.solve(cost0, inst.allowed, capacity,
                                    backend=self.backend, soften=True,
                                    overrun=inst.overrun, tol=tol,
                                    sigma=self.sigma, device=self.device)
            obs.annotate(softened=softened, status=res.status)
        self.solve_times.append(res.solve_time_s)

        scheduled: List[problem.Job] = []
        assign: List[int] = []
        with obs.span("policy.extract", jobs=len(due)):
            for row, (j, col) in enumerate(zip(due, res.assign)):
                col = int(col)
                if col < 0:
                    deferred.append(j)
                    continue
                if softened:
                    # Soft fallback is slot-0 only: run, no revision.
                    action, payload = RUN, col
                else:
                    action, payload = self.pricer.decode(plan, col, now_s)
                    action, payload = self.deferral.revise(
                        j, action, payload, plan, row, col, now_s)
                if action == RUN:
                    j.region = int(payload)
                    scheduled.append(j)
                    assign.append(int(payload))
                elif action == HOLD:
                    self.deferral.hold(j, float(payload), now_s)
                    deferred.append(j)
                else:                                        # DEFER
                    deferred.append(j)
            deferred += held
        if obs.enabled():
            q = getattr(getattr(self.deferral, "queue", None), "__len__",
                        None)
            if q is not None:
                obs.gauge("deferral.queue_depth", float(q()))
        return Decision(scheduled, np.asarray(assign, np.int64), deferred,
                        res, softened, wake_s=self.deferral.wake_s())


# ---------------------------------------------------------------------------
# Canonical configurations
# ---------------------------------------------------------------------------

def reactive_pipeline(tele: telemetry.Telemetry, *,
                      server: footprint.ServerSpec = None,
                      lam_co2: float = 0.5, lam_h2o: float = 0.5,
                      lam_ref: float = 0.1, window: int = 10,
                      sigma: float = 10.0, backend: str = "flow",
                      defer_margin: float = 0.02,
                      defer_slack_s: float = 120.0,
                      lam_emb: float = 0.0, device=None) -> PolicyPipeline:
    """The paper's myopic co-optimizing controller (Algorithm 1): snapshot
    pricing + virtual defer arc, hard→soft MILP fallback. ``lam_emb`` adds
    the embodied-carbon dimension to the objective (``waterwise-embodied``);
    ``device`` is where the device backends run (None: the CUDA card)."""
    return PolicyPipeline(
        tele, SnapshotPricer(defer_margin, defer_slack_s),
        NextRoundDeferral(), server=server, lam_co2=lam_co2,
        lam_h2o=lam_h2o, lam_ref=lam_ref, window=window, sigma=sigma,
        backend=backend, lam_emb=lam_emb, device=device)
