"""Temporal-shifting planner: spatio-temporal assignment + deferral queue.

The reactive controller solves ``jobs × regions`` at every round. The
forecast-driven planner widens the decision space to
``jobs × (regions × horizon-slots)``: slot 0 is "run now" priced at the live
telemetry snapshot, slots 1..S−1 are "hold and run later" priced at the
forecast (optionally risk-adjusted toward the upper quantile band). The
flattened problem is still a capacitated transportation problem — the same
bucketed/padded Sinkhorn (or any other) backend solves it unchanged.

Deadline feasibility is a *mask*, not a penalty: a (region, slot) cell is
allowed only when the job's remaining tolerance budget covers the wait until
the slot start plus the transfer, with ``guard_s`` of budget left over — so a
deferred job can always still be placed (at minimum at home) when its slot
arrives. No job can miss its deadline by being deferred.

``DeferralQueue`` owns the held jobs between rounds: release at the planned
slot, early release when slack runs low (the guard), FIFO within equal
slack, and an explicit drain for horizon end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import repro_torch.obs as obs
from repro_torch.core import footprint, problem
from repro_torch.core.problem import Job, ProblemInstance


@dataclasses.dataclass
class TemporalPlan:
    """Flattened ``jobs × (regions × slots)`` instance (column = s·N + n)."""
    cost: np.ndarray          # [M, N*S] objective coefficients
    allowed: np.ndarray       # [M, N*S] deadline-feasibility mask
    capacity: np.ndarray      # [N*S]
    slot_offsets: np.ndarray  # [S] seconds from now to each slot start
    num_regions: int
    num_slots: int

    def decode(self, flat: int) -> Tuple[int, int]:
        """Flat column index -> (slot, region)."""
        return flat // self.num_regions, flat % self.num_regions


def build_temporal_plan(inst: ProblemInstance, now_s: float,
                        ci: np.ndarray, ewif: np.ndarray, wue: np.ndarray,
                        pue: np.ndarray, wsf: np.ndarray,
                        slot_offsets: np.ndarray,
                        server: footprint.ServerSpec,
                        lam_co2: float, lam_h2o: float,
                        lam_ref: float = 0.0,
                        co2_ref: Optional[np.ndarray] = None,
                        h2o_ref: Optional[np.ndarray] = None,
                        defer_eps: float = 1e-3,
                        guard_s: float = 240.0) -> TemporalPlan:
    """Extend a slot-0 ``ProblemInstance`` with forecast-priced future slots.

    Args:
      inst: the reactive instance built at ``now_s`` — its latency, overrun
        mask, and capacity are reused; its snapshot costs are *not* (cells
        are re-priced from the signal tensors so "now" and "later" are
        compared on the same footing).
      ci/ewif/wue: [M, S, R] per-(job, slot) signal estimates — typically the
        forecast evaluated at each job's execution-window midpoint, which
        approximates the integrated accounting the simulator applies.
      pue/wsf: [R] static region attributes.
      slot_offsets: [S] seconds from ``now_s`` to each slot start (entry 0
        must be 0).
      defer_eps: per-slot tie-break cost — deferral must *earn* its delay.
      guard_s: tolerance budget that must remain at the slot start for any
        deferred cell (early-release safety margin, see ``DeferralQueue``).

    Eq-7 normalizers are recomputed as the per-job max over *all* cells so
    slot costs are mutually comparable; the λ_ref history term (constant per
    region) is replicated across slots, exactly as in the reactive objective.
    """
    jobs = inst.jobs
    M, N = inst.shape
    S = len(slot_offsets)
    assert slot_offsets[0] == 0.0 and ci.shape == (M, S, N)
    E = np.array([j.energy_kwh for j in jobs])
    t = np.array([j.exec_time_s for j in jobs])

    co2 = footprint.job_carbon(E[:, None, None], t[:, None, None], ci, server)
    h2o = footprint.job_water(E[:, None, None], t[:, None, None],
                              pue[None, None, :], ewif, wue,
                              wsf[None, None, :], server)

    co2_max = np.maximum(co2.max(axis=(1, 2)), 1e-9)
    h2o_max = np.maximum(h2o.max(axis=(1, 2)), 1e-9)
    obj = (lam_co2 * co2 / co2_max[:, None, None]
           + lam_h2o * h2o / h2o_max[:, None, None])
    if co2_ref is not None and h2o_ref is not None:
        obj = obj + lam_ref * (lam_co2 * co2_ref
                               + lam_h2o * h2o_ref)[None, None, :]
    obj = obj + defer_eps * np.arange(S)[None, :, None]

    # Deadline mask: waiting to slot s + transfer must leave ``guard_s`` of
    # tolerance budget (slot 0 keeps the exact Eq-11 mask — no guard — so the
    # planner is never *less* feasible than the reactive controller).
    budget = problem.slack_budget(jobs, now_s)                  # [M]
    need = slot_offsets[None, :, None] + inst.latency[:, None, :]
    allowed = need + guard_s <= budget[:, None, None] + 1e-9
    allowed[:, 0, :] = inst.allowed

    cap = np.tile(np.asarray(inst.capacity, np.int64), S)
    return TemporalPlan(cost=obj.reshape(M, S * N),
                        allowed=allowed.reshape(M, S * N),
                        capacity=cap,
                        slot_offsets=np.asarray(slot_offsets, np.float64),
                        num_regions=N, num_slots=S)


# ---------------------------------------------------------------------------
# Deferral queue
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Held:
    job: Job
    release_s: float      # planned slot start
    held_at_s: float      # when the hold began
    seq: int              # insertion order (FIFO tie-break)


class DeferralQueue:
    """Held jobs between scheduling rounds.

    Invariants (tested):
      * a job is released no later than its planned slot start;
      * a job is force-released early as soon as its remaining tolerance
        budget drops to ``guard_s`` — deferral can never cause a deadline
        miss that immediate placement would have avoided;
      * among jobs due in the same round with equal remaining slack, release
        order is FIFO (insertion order);
      * ``drain()`` empties the queue (horizon end / shutdown).
    """

    def __init__(self, guard_s: float = 240.0):
        self.guard_s = float(guard_s)
        self._held: Dict[int, _Held] = {}
        self._seq = 0
        # Stats for the sweep's deferral columns. ``released`` counts hold
        # *episodes* (a job re-deferred at its slot counts again);
        # ``unique_held`` counts distinct jobs ever time-shifted.
        self.released = 0
        self.total_defer_s = 0.0
        self.unique_held: set = set()

    def __len__(self) -> int:
        return len(self._held)

    def __contains__(self, job_id: int) -> bool:
        return job_id in self._held

    def hold(self, job: Job, release_s: float, now_s: float,
             held_at_s: Optional[float] = None) -> None:
        """Hold ``job`` until ``release_s``. ``held_at_s`` backdates the
        episode start — a re-planned job that gets held again continues its
        original episode instead of opening a new one (receding-horizon
        re-planning, ``policy.ReplanQueueDeferral``)."""
        assert job.job_id not in self._held
        start = now_s if held_at_s is None else held_at_s
        self._held[job.job_id] = _Held(job, release_s, start, self._seq)
        self.unique_held.add(job.job_id)
        self._seq += 1

    def pop_for_replan(self, job_id: int) -> float:
        """Remove a held job so it can re-enter pricing *without* closing
        its hold episode; returns the episode's start time. The caller
        either re-holds it (``hold(..., held_at_s=start)`` — the episode
        continues) or, if the re-plan ran it, closes the episode via
        ``close_replan(start, ran_at_s)``."""
        return self._held.pop(job_id).held_at_s

    def close_replan(self, held_at_s: float, ran_at_s: float) -> None:
        """Close the hold episode of a re-planned job that left the queue
        (the re-pricing round chose to run it, or stopped holding it)."""
        self._note_release(max(ran_at_s - held_at_s, 0.0))

    def next_release_s(self) -> Optional[float]:
        if not self._held:
            return None
        return min(h.release_s for h in self._held.values())

    def partition(self, jobs: Sequence[Job], now_s: float
                  ) -> Tuple[List[Job], List[Job]]:
        """Split a pending set into (due, still-held).

        Due = not held, planned slot reached, or slack ≤ guard. Released jobs
        are ordered by remaining slack ascending, FIFO within equal slack;
        jobs the queue never held keep their incoming order, after releases.
        """
        due_new: List[Job] = []
        released: List[Tuple[float, int, Job]] = []
        held: List[Job] = []
        for j in jobs:
            h = self._held.get(j.job_id)
            if h is None:
                due_new.append(j)
                continue
            slack = j.slack_budget_s(now_s)
            if now_s + 1e-9 >= h.release_s or slack <= self.guard_s:
                self._release(h, now_s)
                released.append((slack, h.seq, j))
            else:
                held.append(j)
        released.sort(key=lambda r: (r[0], r[1]))
        return [r[2] for r in released] + due_new, held

    def drain(self, now_s: float) -> List[Job]:
        """Release everything (FIFO), e.g. at horizon end."""
        out = sorted(self._held.values(), key=lambda h: h.seq)
        for h in out:
            self._release(h, now_s, pop=False)
        self._held.clear()
        return [h.job for h in out]

    def _release(self, h: _Held, now_s: float, pop: bool = True) -> None:
        self._note_release(max(now_s - h.held_at_s, 0.0))
        if pop:
            del self._held[h.job.job_id]

    def _note_release(self, hold_s: float) -> None:
        self.released += 1
        self.total_defer_s += hold_s
        obs.observe("deferral.hold_s", hold_s)   # simulated-time duration

    @property
    def mean_defer_s(self) -> float:
        """Mean total held time per distinct time-shifted job (hold episodes
        of a re-deferred job accumulate)."""
        n = len(self.unique_held)
        return self.total_defer_s / n if n else 0.0
