"""One composable scheduling pipeline — paper §4 Algorithm 1, decomposed
(the reactive part of ``repro/policy/pipeline.py``, ported).

A ``PolicyPipeline`` is assembled from composable stages:

  ``Pricer``          turns a scheduling round into a priced, arc-masked
                      assignment plan.  ``SnapshotPricer`` prices every job
                      at the live telemetry snapshot and offers one virtual
                      defer arc at the trailing-mean cost (the paper's
                      myopic controller); ``ForecastPricer`` widens the plan
                      to jobs × (regions × horizon-slots) priced by a
                      forecast integrated over each execution window.
  ``DeferralPolicy``  owns jobs the solver decided to hold.
                      ``NextRoundDeferral`` simply re-offers them next round
                      (reactive defer arc); ``QueueDeferral`` wraps the
                      slack-guarded ``forecast.DeferralQueue`` with planned
                      release times and engine wake-ups;
                      ``ReplanQueueDeferral`` re-prices held jobs.
  solver backend      any ``repro_torch.core.solvers`` backend name; hard
                      solve with soft (Eqs 12-13) fallback is pipeline
                      logic. The pipeline's ``device`` reaches the device
                      backends (``torch``, ``fused``).

All stages speak one protocol — ``schedule(jobs, now_s, capacity) ->
Decision``. ``record_windows=True`` captures every solved window for
offline replay through ``solvers.solve_many`` (``replay_recorded``).
``ForecastPricer(warm=True)`` carries the Sinkhorn column potentials between
fused rounds (``core.round.SinkhornWarmStart``).
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


class ForecastPricer(Pricer):
    """Forecast-integrated pricing (beyond-paper subsystem).

    Replaces the reactive defer *arc* with a forecast-priced defer *grid*:
    every round prices ``jobs × (regions × horizon-slots)`` where slot 0 is
    "run now" at the live snapshot and slots 1..S−1 are "hold until t+s·Δ"
    priced at a forecast of (ci, ewif, wue) — Holt–Winters by default, the
    true-future ``oracle`` for upper-bound studies. Deadline feasibility is
    masked, never penalized, so deferral cannot cause a tolerance miss (see
    ``forecast.planner``). Forecasters that run on a torch device
    (``holtwinters``, ``learned``) get the pipeline's ``device``.

    ``risk`` shades future-slot prices toward the upper quantile band
    (risk-averse deferral under forecast uncertainty); ``forecast_bias`` /
    ``forecast_noise`` inject systematic error for the ``forecast-error``
    scenario regime.
    """

    def __init__(self, *, forecaster: str = "holtwinters",
                 horizon_slots: int = 8, slot_s: float = 1800.0,
                 risk: float = 0.25, defer_eps: float = 1e-3,
                 guard_s: float = 240.0, warmup_hours: int = 96,
                 forecast_bias: float = 1.0, forecast_noise: float = 0.0,
                 forecast_seed: int = 0, warm: bool = False):
        # ``forecaster`` names any registered model ("holtwinters",
        # "seasonal-naive", "persistence", "learned", ...) or "oracle".
        from repro_torch import forecast as fcast
        self._fcast = fcast
        self.forecaster_name = forecaster
        self.horizon_slots = int(horizon_slots)
        self.slot_s = float(slot_s)
        self.risk = float(risk)
        self.defer_eps = float(defer_eps)
        self.guard_s = float(guard_s)
        # Pre-run telemetry archive: production forecasters are warm-started
        # on months of history, but a simulation starts at t=0. The synthetic
        # telemetry is the single period of a periodic environment
        # (``Telemetry.at`` wraps), so its cyclic extension *is* the
        # environment's past — the archive at simulated hour h is the
        # ``warmup_hours`` wrapped hours ending at h. Set 0 for a cold start.
        self.warmup_hours = int(warmup_hours)
        self.forecast_bias = float(forecast_bias)
        self.forecast_noise = float(forecast_noise)
        self.forecast_seed = int(forecast_seed)
        self._truth = None
        self._fit_hour = -1
        self._forecast = None
        self._fitted = None
        # The forecaster object is created once and re-fit every refresh:
        # classical models reset fully on fit() (bit-identical to a fresh
        # instance), while stateful models (the learned forecaster) keep
        # their trained parameters across refits and decide internally when
        # to retrain (``retrain_every``) vs. just re-condition.
        self._forecaster_obj = None
        # Warm-started Sinkhorn: carry the temporal OT's column potentials
        # between rounds (``core.round.SinkhornWarmStart``). Fused backend
        # only — the unfused path ignores it (warned once).
        self.warm = bool(warm)
        self.warm_state = None
        self._warm_warned = False
        # Online forecast-accuracy bookkeeping (the sweep's accuracy column):
        # each refit scores the previous forecast against the hours that have
        # since realized.
        self._ape_sum = 0.0
        self._ape_n = 0

    def bind(self, pipeline) -> None:
        super().bind(pipeline)
        tele = pipeline.tele
        # Ground truth, stacked [T, 3R]: columns [ci | ewif | wue] — one
        # forecaster fit covers all three signals at once.
        self._truth = np.concatenate([tele.ci, tele.ewif, tele.wue], axis=1)

    # -- forecasting ---------------------------------------------------------

    def _make_forecaster(self):
        if self.forecaster_name == "oracle":
            f = self._fcast.Oracle(self._truth)
        else:
            cls = self._fcast.base.model_class(self.forecaster_name)
            f = (cls(device=self.pipe.device) if cls.on_device else cls())
        if self.forecast_bias != 1.0 or self.forecast_noise > 0.0:
            f = self._fcast.Perturbed(f, self.forecast_bias,
                                      self.forecast_noise,
                                      self.forecast_seed)
        return f

    @property
    def forecast_mape(self) -> float:
        """Realized 1..H-hour-ahead MAPE (%) of the forecasts actually used."""
        return 100.0 * self._ape_sum / self._ape_n if self._ape_n else 0.0

    def _refresh_forecast(self, now_s: float) -> None:
        tele = self.pipe.tele
        h = min(int(now_s // telemetry.HOUR), tele.num_hours - 1)
        if h <= self._fit_hour:
            return
        if self._forecast is not None:
            fc = self._forecast
            for k in range(self._fit_hour + 1, h + 1):
                lead = k - fc.issue_hour - 1
                if 0 <= lead < fc.horizon:
                    truth = self._truth[k % self._truth.shape[0]]
                    pred = fc.mean[lead]
                    self._ape_sum += float(np.mean(
                        np.abs(pred - truth)
                        / np.maximum(np.abs(truth), 1e-9)))
                    self._ape_n += 1
        T = self._truth.shape[0]
        if self.forecaster_name == "oracle" or self.warmup_hours <= 0:
            hist = self._truth[:h + 1]       # oracle indexes truth absolutely
        else:
            idx = np.arange(h - self.warmup_hours + 1, h + 1) % T
            hist = self._truth[idx]
        if self._forecaster_obj is None:
            self._forecaster_obj = self._make_forecaster()
        self._fitted = self._forecaster_obj.fit(hist)
        self._fit_hour = h
        horizon_h = int(np.ceil(self.horizon_slots * self.slot_s
                                / telemetry.HOUR)) + 1
        self._forecast = self._predict(horizon_h)

    def _predict(self, horizon_h: int):
        fc = self._fitted.predict(horizon_h)
        if fc.issue_hour != self._fit_hour:
            # Re-anchor from archive-relative to absolute hours (wrapped
            # warm-start histories end at hour ``_fit_hour`` by construction).
            fc = dataclasses.replace(fc, issue_hour=self._fit_hour)
        return fc

    def _ensure_horizon(self, now_s: float, max_exec_s: float,
                        last_offset_s: float) -> None:
        """Grow the cached forecast so every execution window it will price
        — up to [last slot start, + longest exec] — lies inside the horizon
        (beyond it the forecast extrapolates flat, which would silently
        de-calibrate the pricing, oracle included)."""
        t_end = now_s + last_offset_s + max_exec_s
        needed = int(np.ceil(t_end / telemetry.HOUR)) - self._fit_hour + 1
        if needed > self._forecast.horizon:
            self._forecast = self._predict(needed)

    def _slot_signal_tensors(self, jobs: Sequence[problem.Job], now_s: float,
                             offsets: np.ndarray):
        """(ci, ewif, wue) estimates per (job, slot), each [M, S, R].

        Every cell is priced at the forecast's exact time-mean over the
        job's would-be execution window [slot_start, slot_start + exec] —
        the simulator accounts with the integrated telemetry over the same
        window, so "run now" and "run later" are compared on the accounting
        footing (with the oracle forecaster planned and accounted signal
        means coincide exactly). Future slots are shaded toward the upper
        quantile band by ``risk`` — deferring on an uncertain forecast must
        price the uncertainty in.
        """
        R = self.pipe.tele.num_regions
        M, S = len(jobs), len(offsets)
        exec_t = np.array([j.exec_time_s for j in jobs])
        self._ensure_horizon(now_s, float(exec_t.max()), float(offsets[-1]))
        t0 = np.broadcast_to(now_s + offsets[None, :], (M, S)).ravel()
        t1 = (now_s + offsets[None, :] + exec_t[:, None]).ravel()
        rows = self._forecast.mean_many(t0, t1)
        if self.risk > 0.0:
            hi = self._forecast.mean_many(t0, t1, "hi")
            shade = self.risk * (hi - rows)
            shade[np.arange(t0.size) % S == 0] = 0.0      # slot 0 is observed
            rows = rows + shade
        rows = np.maximum(rows, 1e-6)          # physical signals are positive
        rows = rows.reshape(M, S, 3 * R)
        return rows[..., :R], rows[..., R:2 * R], rows[..., 2 * R:]

    # -- pricing -------------------------------------------------------------

    def price(self, jobs, now_s, inst, snap) -> PricedPlan:
        pipe = self.pipe
        with obs.span("policy.forecast"):
            self._refresh_forecast(now_s)
            offsets = np.arange(self.horizon_slots) * self.slot_s
            ci, ewif, wue = self._slot_signal_tensors(jobs, now_s, offsets)
        if pipe.backend == "fused":
            # Pricing, masking, Sinkhorn, and extraction run on the device
            # in one program; the plan comes back already hard-solved.
            from repro_torch.core import round as fused_round
            if self.warm and self.warm_state is None \
                    and not pipe.record_windows:
                self.warm_state = fused_round.SinkhornWarmStart()
            cost, allowed, cap, res = fused_round.fused_temporal_round(
                inst, now_s, ci, ewif, wue, snap["pue"], snap["wsf"],
                offsets, pipe.server, pipe.lam_co2, pipe.lam_h2o,
                pipe.lam_ref, pipe.history.co2_ref, pipe.history.h2o_ref,
                defer_eps=self.defer_eps, guard_s=self.guard_s,
                want_plan=pipe.record_windows, warm_start=self.warm_state,
                device=pipe.device)
            S = len(offsets)
            return PricedPlan(cost=cost, allowed=allowed, capacity=cap,
                              overrun=np.tile(inst.overrun, (1, S)),
                              num_regions=inst.shape[1], num_slots=S,
                              slot_offsets=np.asarray(offsets, np.float64),
                              presolved=res)
        if self.warm and not self._warm_warned:
            self._warm_warned = True
            obs.warn("policy.warm_ignored",
                     "warm-started Sinkhorn requires backend='fused'; "
                     f"backend={pipe.backend!r} prices unfused — ignored")
        plan = self._fcast.build_temporal_plan(
            inst, now_s, ci, ewif, wue, snap["pue"], snap["wsf"], offsets,
            pipe.server, pipe.lam_co2, pipe.lam_h2o, pipe.lam_ref,
            pipe.history.co2_ref, pipe.history.h2o_ref,
            defer_eps=self.defer_eps, guard_s=self.guard_s)
        return PricedPlan(cost=plan.cost, allowed=plan.allowed,
                          capacity=plan.capacity,
                          overrun=np.tile(inst.overrun, (1, plan.num_slots)),
                          num_regions=plan.num_regions,
                          num_slots=plan.num_slots,
                          slot_offsets=plan.slot_offsets)

    def decode(self, plan, col, now_s):
        s, n = col // plan.num_regions, col % plan.num_regions
        if s == 0:
            return RUN, n
        return HOLD, now_s + float(plan.slot_offsets[s])

    @property
    def sinkhorn_cold_iters(self) -> List[int]:
        return self.warm_state.cold_iters if self.warm_state else []

    @property
    def sinkhorn_warm_iters(self) -> List[int]:
        return self.warm_state.warm_iters if self.warm_state else []


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


class QueueDeferral(DeferralPolicy):
    """Planned temporal holds backed by the slack-guarded
    ``forecast.DeferralQueue``: jobs assigned a future slot wait out their
    hold and are re-offered at the planned slot (or early, when their
    remaining tolerance budget drops to the guard)."""

    def __init__(self, guard_s: float = 240.0):
        from repro_torch import forecast as fcast
        self.queue = fcast.DeferralQueue(guard_s)

    def admit(self, jobs, now_s, capacity=None):
        return self.queue.partition(jobs, now_s)

    def hold(self, job, release_s, now_s):
        self.queue.hold(job, release_s, now_s)

    def wake_s(self):
        return self.queue.next_release_s()

    @property
    def mean_defer_s(self) -> float:
        return self.queue.mean_defer_s

    @property
    def deferred_jobs(self) -> int:
        """Distinct jobs ever time-shifted (re-deferrals don't double-count)."""
        return len(self.queue.unique_held)


class ReplanQueueDeferral(QueueDeferral):
    """Receding-horizon re-planning over the deferral queue.

    ``QueueDeferral`` commits a held job to the slot priced at admission
    time; this variant sends held jobs *back into pricing every round*, so
    the plan is re-made against the freshest forecast — the rolling
    spatio-temporal shifting regime of Attenni et al. (arXiv:2512.08725)
    on top of WaterWise's carbon/water co-optimization. The solver may
    confirm the hold (same or new slot — the episode continues, stats
    uncounted), pull the job forward to run now, or push it later.

    The **re-plan guard**: a job within ``replan_guard_s`` of its planned
    release stays committed. Re-pricing that close to release cannot move
    the job materially but doubles solver load and can thrash the plan —
    the guard bounds both, and makes the commit monotone near release.

    The **hysteresis margin**: running is irreversible, holding is not.
    Each re-pricing round is a fresh draw from an approximate (entropic)
    solver on a slot grid re-anchored at *now* — without friction, a held
    job runs the first round the blur happens to favor slot 0, a ratchet
    that erodes planned deferrals (measurably worse footprints). So a
    re-planned "run now" is accepted only when it beats the job's
    committed slot by ``replan_margin`` *in the same cost matrix*;
    otherwise the hold is restored at its original release (``revise``).
    Re-planned holds (slot moves) carry no friction — they stay reversible.
    """

    def __init__(self, guard_s: float = 240.0,
                 replan_guard_s: float = 900.0,
                 replan_margin: float = 0.02):
        super().__init__(guard_s)
        self.replan_guard_s = float(replan_guard_s)
        self.replan_margin = float(replan_margin)
        self.replans = 0            # re-pricing episodes (job-rounds)
        self.replan_runs = 0        # re-plans that ran the job early
        self.replan_vetoes = 0      # early runs vetoed by the margin
        # Episodes opened before the current re-pricing round:
        # job_id -> (original held_at_s, pop round's now_s, committed
        # release_s). Entries are reclaimed by ``hold`` (job re-held:
        # episode continues) or closed at the next round for jobs that
        # left the queue.
        self._carried: dict = {}

    def admit(self, jobs, now_s, capacity=None):
        q = self.queue
        if self._carried:
            # Settle last round's popped-but-not-re-held episodes: a job
            # that ran (gone from pending) ends its episode at the pop
            # instant; one the solver dropped (defer / infeasible row) gets
            # its committed hold restored — re-planning must never *lose* a
            # commitment.
            incoming = {j.job_id: j for j in jobs}
            for jid, (held_at, popped_at, release_s) in self._carried.items():
                j = incoming.get(jid)
                if j is None:
                    q.close_replan(held_at, popped_at)
                else:
                    q.hold(j, release_s, now_s, held_at_s=held_at)
            self._carried.clear()
        due, held = q.partition(jobs, now_s)
        if not held:
            return due, held
        # Re-plan only into *spare* seats: an added row must never displace
        # a genuinely due job (urgent-trim) or tip the round into the soft
        # fallback — under a capacity crunch held jobs stay committed.
        spare = (len(held) if capacity is None
                 else max(int(capacity) - len(due), 0))
        keep: List[problem.Job] = []
        for j in held:
            release_s = q._held[j.job_id].release_s
            if spare > 0 and release_s - now_s > self.replan_guard_s:
                self._carried[j.job_id] = (q.pop_for_replan(j.job_id),
                                           now_s, release_s)
                self.replans += 1
                spare -= 1
                due.append(j)
            else:
                keep.append(j)
        if obs.enabled() and len(keep) < len(held):
            obs.counter("policy.replanned", len(held) - len(keep))
        return due, keep

    def revise(self, job, action, payload, plan, row, col, now_s):
        carried = self._carried.get(job.job_id)
        if carried is None or plan.slot_offsets is None or plan.num_slots < 2:
            return action, payload
        release_s = carried[2]
        S, N = plan.num_slots, plan.num_regions
        slot_s = float(plan.slot_offsets[1] - plan.slot_offsets[0])
        s = int(np.clip(np.rint((release_s - now_s) / slot_s), 1, S - 1))
        if action == HOLD and col // N == s:
            return action, payload          # plan confirmed (slot unchanged)
        ok = plan.allowed[row, s * N:(s + 1) * N]
        if not ok.any():
            return action, payload          # committed slot gone infeasible
        committed = float(np.min(np.where(
            ok, plan.cost[row, s * N:(s + 1) * N], np.inf)))
        if float(plan.cost[row, col]) <= committed - self.replan_margin:
            if action == RUN:
                self.replan_runs += 1
            return action, payload          # genuine improvement: move
        self.replan_vetoes += 1
        return HOLD, release_s              # restore the committed hold

    def hold(self, job, release_s, now_s):
        carried = self._carried.pop(job.job_id, None)
        self.queue.hold(job, release_s, now_s,
                        held_at_s=None if carried is None else carried[0])


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
                 lam_emb: float = 0.0, record_windows: bool = False,
                 device=None):
        assert abs(lam_co2 + lam_h2o + lam_emb - 1.0) < 1e-9, \
            "footprint weights must sum to 1"
        self.tele = tele
        self.server = server or footprint.m5_metal()
        self.lam_co2, self.lam_h2o, self.lam_ref = lam_co2, lam_h2o, lam_ref
        self.lam_emb = lam_emb
        self.sigma = sigma
        solvers.get_solver(backend)      # an unknown backend fails here
        self.backend = backend
        # Device of the device backends: None is the CUDA card (and raises
        # without one); "cpu" runs them on the host.
        self.device = device
        self.history = HistoryLearner(tele.num_regions, window)
        self.solve_times: List[float] = []
        # Offline queued-window replay: when enabled, every solved instance
        # (the one that produced the round's decision) is captured so the
        # whole run can be re-solved in bulk through ``solvers.solve_many``
        # (bucketed, one batched Sinkhorn per bucket).
        self.record_windows = record_windows
        self.recorded: List[dict] = []
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

    # -- offline replay ------------------------------------------------------

    def _record(self, cost, allowed, capacity, overrun, tol, soften) -> None:
        if self.record_windows:
            self.recorded.append(dict(
                cost=np.array(cost), allowed=np.array(allowed),
                capacity=np.array(capacity), overrun=np.array(overrun),
                tol=np.array(tol), soften=bool(soften)))

    def replay_recorded(self, backend: str = "torch"
                        ) -> List[solvers.SolveResult]:
        """Re-solve every recorded scheduling window through the batched
        ``solvers.solve_many`` path, on the pipeline's device; results come
        back in round order.

        Hard and soft rounds are batched separately (``soften`` is a batch-
        level flag); with the default ``torch`` backend each group buckets
        by padded shape and runs one batched Sinkhorn per bucket. The
        reference's default ``jax`` is the port's ``torch``.
        """
        out: List[Optional[solvers.SolveResult]] = [None] * len(self.recorded)
        for soften in (False, True):
            idx = [i for i, w in enumerate(self.recorded)
                   if w["soften"] == soften]
            if not idx:
                continue
            res = solvers.solve_many(
                [self.recorded[i]["cost"] for i in idx],
                [self.recorded[i]["allowed"] for i in idx],
                [self.recorded[i]["capacity"] for i in idx],
                backend=backend, soften=soften,
                overruns=[self.recorded[i]["overrun"] for i in idx],
                tols=[self.recorded[i]["tol"] for i in idx],
                sigma=self.sigma, device=self.device)
            for i, r in zip(idx, res):
                out[i] = r
        return out

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
            if res.feasible:
                self._record(plan.cost, plan.allowed, plan.capacity,
                             plan.overrun, tol, False)
            else:                                            # lines 10-11
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
                self._record(cost0, inst.allowed, capacity, inst.overrun,
                             tol, True)
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
                      lam_emb: float = 0.0, record_windows: bool = False,
                      device=None) -> PolicyPipeline:
    """The paper's myopic co-optimizing controller (Algorithm 1): snapshot
    pricing + virtual defer arc, hard→soft MILP fallback. ``lam_emb`` adds
    the embodied-carbon dimension to the objective (``waterwise-embodied``);
    ``device`` is where the device backends run (None: the CUDA card).
    ``record_windows=True`` keeps every solved window for
    ``replay_recorded``."""
    return PolicyPipeline(
        tele, SnapshotPricer(defer_margin, defer_slack_s),
        NextRoundDeferral(), server=server, lam_co2=lam_co2,
        lam_h2o=lam_h2o, lam_ref=lam_ref, window=window, sigma=sigma,
        backend=backend, lam_emb=lam_emb, record_windows=record_windows,
        device=device)


def forecast_pipeline(tele: telemetry.Telemetry, *,
                      forecaster: str = "holtwinters",
                      horizon_slots: int = 8, slot_s: float = 1800.0,
                      risk: float = 0.25, defer_eps: float = 1e-3,
                      guard_s: float = 240.0, warmup_hours: int = 96,
                      forecast_bias: float = 1.0,
                      forecast_noise: float = 0.0, forecast_seed: int = 0,
                      backend: str = "torch",
                      server: footprint.ServerSpec = None,
                      lam_co2: float = 0.5, lam_h2o: float = 0.5,
                      lam_ref: float = 0.1, window: int = 10,
                      sigma: float = 10.0,
                      warm: bool = False, replan: bool = False,
                      replan_guard_s: float = 900.0,
                      replan_margin: float = 0.02,
                      record_windows: bool = False,
                      device=None) -> PolicyPipeline:
    """Predictive spatio-temporal configuration: forecast-grid pricing +
    slack-guarded deferral queue over the same pipeline.

    ``replan=True`` swaps the commit-at-admission queue for
    receding-horizon re-planning (``ReplanQueueDeferral``) with its
    ``replan_guard_s`` commit window and ``replan_margin`` early-run
    hysteresis. ``device`` is where the device backends and forecasters run
    (None: the CUDA card). The reference's ``backend="jax"`` default is the
    port's ``"torch"``. ``record_windows=True`` keeps every solved window
    for ``replay_recorded``. ``warm=True`` carries Sinkhorn column
    potentials between rounds (fused backend only)."""
    pricer = ForecastPricer(
        forecaster=forecaster, horizon_slots=horizon_slots, slot_s=slot_s,
        risk=risk, defer_eps=defer_eps, guard_s=guard_s,
        warmup_hours=warmup_hours, forecast_bias=forecast_bias,
        forecast_noise=forecast_noise, forecast_seed=forecast_seed,
        warm=warm)
    deferral = (ReplanQueueDeferral(guard_s, replan_guard_s, replan_margin)
                if replan else QueueDeferral(guard_s))
    return PolicyPipeline(
        tele, pricer, deferral, server=server,
        lam_co2=lam_co2, lam_h2o=lam_h2o, lam_ref=lam_ref, window=window,
        sigma=sigma, backend=backend, record_windows=record_windows,
        device=device)
