"""Scheduling-problem construction: jobs, cost matrices, arc filtering.

Builds the inputs of the paper's MILP (Eqs 8-11) for a batch of M jobs over N
regions at decision time T:

  CO2[m, n]   Eq (1) carbon footprint of job m executed in region n *now*
  H2O[m, n]   Eq (5) water footprint (incl. WSF scaling per Eqs 2-3)
  L[m, n]     transfer latency from job m's home region to region n
  allowed[m,n]  Eq (11) arc filter: L[m,n]/t_m + queue-wait <= TOL%·t_m

Key structural observation (exploited by every solver backend): because each
job is assigned to exactly ONE region (Eq 9), the delay-tolerance constraint
Eq (11) — a sum over n of x[m,n]·L[m,n]/t[m,n] — degenerates to a per-arc
bound. The MILP is therefore a capacitated transportation problem with
forbidden arcs, whose constraint matrix is totally unimodular: the LP
relaxation has integral vertices. The soft-constrained variant (Eqs 12-13)
similarly folds the penalty sigma·P[m,n] into the arc cost, because the
optimal P[m,n] is max(0, L/t - TOL) on the chosen arc and 0 elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import footprint, telemetry


@dataclasses.dataclass
class Job:
    """One schedulable unit (paper: a PARSEC/CloudSuite batch job; ours: also
    a JAX train/serve job of an assigned architecture)."""
    job_id: int
    home_region: int
    submit_time_s: float
    exec_time_s: float              # t_j: pure execution time (region-invariant)
    energy_kwh: float               # E_j: mean estimate from previous executions
    package_bytes: float = 2e9      # .tar / checkpoint size to move
    tolerance: float = 0.25         # TOL%: allowed service-time slack fraction
    servers: int = 1                # capacity units consumed
    arch: Optional[str] = None      # workload-side tag (assigned architecture)
    # Mutable bookkeeping (simulator-owned):
    start_time_s: Optional[float] = None
    finish_time_s: Optional[float] = None
    region: Optional[int] = None
    planned_start_s: Optional[float] = None  # oracle-intended delayed start
    time_scale: float = 1.0                  # Ecovisor carbon-scaler effects
    energy_scale: float = 1.0
    # Workflow (DAG) extensions — plain batch jobs leave all three at their
    # defaults and keep their exact pre-DAG semantics (bit-for-bit):
    deps: Tuple[int, ...] = ()               # predecessor job_ids (must finish
    #                                          before this task may start)
    workflow_id: Optional[int] = None        # owning WorkflowSpec, if any
    deadline_override_s: Optional[float] = None  # absolute critical-path
    #                                          deadline (repro.workflows.cpath)

    @property
    def deadline_s(self) -> float:
        """Latest completion compatible with the delay tolerance: the job may
        spend at most (1+TOL)·t_j in the system. Workflow tasks instead carry
        an absolute critical-path deadline (latest finish such that the
        longest remaining path still meets the workflow deadline)."""
        if self.deadline_override_s is not None:
            return self.deadline_override_s
        return self.submit_time_s + (1.0 + self.tolerance) * self.exec_time_s

    def slack_budget_s(self, now_s: float) -> float:
        """Remaining tolerance budget at ``now_s``: TOL·t_j minus the queue
        wait already burnt. The single definition shared by the slack
        manager, the deferral queue, and the temporal feasibility mask —
        they must agree or deferral could cause a deadline miss. For
        workflow tasks the budget derives from the critical-path deadline:
        how long the task can still wait and start no later than
        deadline − t_j."""
        if self.deadline_override_s is not None:
            return self.deadline_override_s - now_s - self.exec_time_s
        return (self.tolerance * self.exec_time_s
                - max(now_s - self.submit_time_s, 0.0))


def slack_budget(jobs: Sequence[Job], now_s: float) -> np.ndarray:
    """Vectorized ``Job.slack_budget_s`` over a batch — ONE array expression
    instead of a per-job Python loop on the hot per-round path.

    Bit-identical to the scalar method: the non-override lane evaluates the
    exact same elementwise expression (``tol·t − max(now − submit, 0)``), so
    pinned decisions cannot drift. The pricers, the temporal planner, and
    the fused round all price slack through this one definition.
    """
    n = len(jobs)
    if n == 0:
        return np.zeros(0)
    tol = np.fromiter((j.tolerance for j in jobs), float, n)
    t = np.fromiter((j.exec_time_s for j in jobs), float, n)
    submit = np.fromiter((j.submit_time_s for j in jobs), float, n)
    override = np.fromiter(
        (np.nan if j.deadline_override_s is None else j.deadline_override_s
         for j in jobs), float, n)
    plain = tol * t - np.maximum(now_s - submit, 0.0)
    return np.where(np.isnan(override), plain, override - now_s - t)


@dataclasses.dataclass
class ProblemInstance:
    """Cost matrices + constraints for one solver invocation."""
    co2: np.ndarray          # [M, N] gCO2
    h2o: np.ndarray          # [M, N] effective liters
    latency: np.ndarray      # [M, N] transfer latency seconds
    overrun: np.ndarray      # [M, N] L/t - already-waited slack, as TOL fraction
    allowed: np.ndarray      # [M, N] bool, Eq (11) arc filter
    capacity: np.ndarray     # [N] free capacity units
    jobs: Sequence[Job]
    co2_max: np.ndarray      # [M] normalizers (paper Eq 7)
    h2o_max: np.ndarray      # [M]
    emb: Optional[np.ndarray] = None      # [M, N] embodied gCO2e (amortized)
    emb_max: Optional[np.ndarray] = None  # [M] embodied normalizers

    @property
    def shape(self):
        return self.co2.shape

    def objective_matrix(self, lam_co2: float = 0.5, lam_h2o: float = 0.5,
                         lam_ref: float = 0.1,
                         co2_ref: Optional[np.ndarray] = None,
                         h2o_ref: Optional[np.ndarray] = None,
                         lam_emb: float = 0.0) -> np.ndarray:
        """Per-arc objective coefficients of Eq (8):
        lam_co2·CO2/CO2_max + lam_h2o·H2O/H2O_max + lam_ref·history term,
        optionally extended with a third (embodied-carbon) footprint
        dimension — ``lam_emb·EMB/EMB_max`` — the axis the source paper
        does not cover."""
        obj = (lam_co2 * self.co2 / self.co2_max[:, None]
               + lam_h2o * self.h2o / self.h2o_max[:, None])
        if lam_emb and self.emb is not None:
            obj = obj + lam_emb * self.emb / self.emb_max[:, None]
        if co2_ref is not None and h2o_ref is not None:
            obj = obj + lam_ref * (lam_co2 * co2_ref + lam_h2o * h2o_ref)[None, :]
        return obj


def latency_matrix(home: np.ndarray, size_bytes: np.ndarray,
                   bw_gbps: Optional[np.ndarray] = None,
                   rtt_s: Optional[np.ndarray] = None) -> np.ndarray:
    """[M, N] transfer latency from each job's home to every region.

    Vectorized equivalent of ``telemetry.transfer_latency_s`` over a job
    batch (zero on the home arc). Shared by the cost-matrix builder, the
    slack manager, and the temporal planner. Callers holding a
    ``Telemetry`` should pass its identity-mapped ``wan_bw_gbps`` /
    ``wan_rtt_s`` tables; the defaults are the full global tables.
    """
    if bw_gbps is None:
        bw_gbps = telemetry.WAN_BW_GBPS
    if rtt_s is None:
        rtt_s = telemetry.WAN_RTT_S
    home = np.asarray(home)
    bw = np.maximum(bw_gbps[home] * 1e9, 1.0)               # [M, N]
    lat = 2.0 + rtt_s[home] + np.asarray(size_bytes)[:, None] / bw
    lat[np.arange(len(home)), home] = 0.0
    return lat


def build(jobs: Sequence[Job], tele: telemetry.Telemetry, now_s: float,
          capacity: np.ndarray, server: footprint.ServerSpec,
          bw_gbps: Optional[np.ndarray] = None,
          snap: Optional[dict] = None) -> ProblemInstance:
    """Construct the cost matrices for ``jobs`` at decision time ``now_s``.

    The scheduler sees only *current* intensities (paper §4: "the scheduler
    cannot have futuristic information") — footprints are priced at time
    ``now_s`` even though execution extends beyond it. Callers that already
    hold the ``tele.at(now_s)`` snapshot may pass it to avoid recomputing.
    """
    if snap is None:
        snap = tele.at(now_s)
    M, N = len(jobs), tele.num_regions

    E = np.array([j.energy_kwh for j in jobs])          # [M]
    t = np.array([j.exec_time_s for j in jobs])         # [M]
    home = np.array([j.home_region for j in jobs])      # [M]
    size = np.array([j.package_bytes for j in jobs])    # [M]
    tol = np.array([j.tolerance for j in jobs])         # [M]
    srv = np.array([j.servers for j in jobs])           # [M]
    waited = np.maximum(now_s - np.array([j.submit_time_s for j in jobs]), 0.0)
    # Workflow tasks carry an absolute critical-path deadline; express their
    # burnt slack in the same TOL-fraction space so Eq (11) and the soft
    # penalty flow through one formula. For plain jobs ``tol·t − slack``
    # equals ``waited`` mathematically but not bitwise — the np.where keeps
    # the original expression on the plain lane (pinned decisions).
    override = np.fromiter(
        (np.nan if j.deadline_override_s is None else 1.0 for j in jobs),
        float, M)
    if not np.isnan(override).all():
        slack = slack_budget(jobs, now_s)
        waited = np.where(np.isnan(override), waited, tol * t - slack)

    co2 = footprint.job_carbon(E[:, None], t[:, None], snap["ci"][None, :],
                               server)
    h2o = footprint.job_water(E[:, None], t[:, None], snap["pue"][None, :],
                              snap["ewif"][None, :], snap["wue"][None, :],
                              snap["wsf"][None, :], server)

    lat = latency_matrix(home, size,
                         bw_gbps if bw_gbps is not None else tele.wan_bw_gbps,
                         tele.wan_rtt_s)

    # Eq (11) with slack accounting: the fraction of tolerance already burnt
    # by queue-waiting plus what the transfer would burn.
    overrun = (lat + waited[:, None]) / np.maximum(t[:, None], 1e-9)
    allowed = overrun <= tol[:, None] + 1e-12

    # Embodied-carbon amortization (gCO2e per server-second, scaled by the
    # per-region fleet factor) — the third accounting dimension.
    emb = footprint.job_embodied(t[:, None], server,
                                 region_scale=footprint.region_embodied_scale(
                                     N)[None, :],
                                 servers=srv[:, None])

    # Normalizers (Eq 7): footprint in the worst (highest-intensity) region.
    co2_max = np.maximum(co2.max(axis=1), 1e-9)
    h2o_max = np.maximum(h2o.max(axis=1), 1e-9)
    emb_max = np.maximum(emb.max(axis=1), 1e-9)

    return ProblemInstance(co2=co2, h2o=h2o, latency=lat, overrun=overrun,
                           allowed=allowed, capacity=np.asarray(capacity),
                           jobs=jobs, co2_max=co2_max, h2o_max=h2o_max,
                           emb=emb, emb_max=emb_max)
