"""Exact min-cost-flow backend — our own solver, numpy only.

The WaterWise MILP (Eqs 8-10 with the Eq 11 arc filter) is a capacitated
assignment problem: unit-supply jobs, capacity-bounded regions, forbidden
arcs. Its LP relaxation lives on a transportation polytope whose constraint
matrix is totally unimodular, so the LP optimum is integral — an exact MILP
solution is obtainable with successive-shortest-path (SSP) min-cost flow.

Structure exploited: region count N is tiny (5 in the paper; ≤ dozens in any
geo-distributed fleet), so the residual graph collapses to N region nodes.
A residual "reroute" arc n→n' costs  min_{j matched to n, allowed (j,n')}
(c[j,n'] − c[j,n])  — moving the cheapest-to-move job. Each augmentation is
then a Bellman-Ford over N nodes (N³ ≪ anything) plus an O(M·N) group-min to
build the arc matrix. SSP invariant (flow is min-cost at every prefix) ⇒ the
residual graph never contains a negative cycle ⇒ Bellman-Ford is exact.

Complexity: O(M·(M·N + N³)) worst case — ~10⁷ flops for M=2000 windows, well
under the paper's Fig 13 overhead budget. The ``soften=True`` variant folds
the Eq 12-13 penalty into arc costs via ``solvers.soft_cost`` (the fold is
exact — proven in tests against the literal MILP formulation).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import solvers

_INF = np.inf


def _reroute_arcs(c: np.ndarray, mask: np.ndarray, assign: np.ndarray,
                  N: int):
    """Build the N×N residual arc matrix R and the argmin job per arc.

    R[n, n2] = min over jobs j currently on n (and allowed on n2) of
    c[j, n2] - c[j, n]; job_pick[n, n2] = that argmin job (or -1).
    """
    R = np.full((N, N), _INF)
    job_pick = np.full((N, N), -1, dtype=np.int64)
    for n in range(N):
        js = np.nonzero(assign == n)[0]
        if js.size == 0:
            continue
        delta = np.where(mask[js], c[js] - c[js, n][:, None], _INF)  # [J, N]
        k = np.argmin(delta, axis=0)
        best = delta[k, np.arange(N)]
        has = np.isfinite(best)
        R[n, has] = best[has]
        job_pick[n, has] = js[k[has]]
        R[n, n] = _INF
    return R, job_pick


def _ssp_assign(cost: np.ndarray, mask: np.ndarray,
                capacity: np.ndarray) -> np.ndarray:
    """Successive-shortest-path assignment over the collapsed region graph.

    Returns assign[M] with region index, or -1 where no augmenting path
    exists (infeasible job under the hard constraints).
    """
    M, N = cost.shape
    c = np.where(mask, cost, _INF)

    # Fast path: when every job's unconstrained argmin column fits within
    # capacity (the common case in a low-utilization fleet, and the case the
    # event-driven engine hits tens of thousands of times per trace), the
    # greedy per-job minimum is a per-job lower bound that is jointly
    # feasible — hence exactly optimal. One vectorized shot, no SSP.
    if M > 0:
        best = np.argmin(c, axis=1)
        if np.isfinite(c[np.arange(M), best]).all():
            counts = np.bincount(best, minlength=N)
            if (counts <= capacity).all():
                return best

    assign = np.full(M, -1, dtype=np.int64)
    used = np.zeros(N, dtype=np.int64)

    # Cheapest-first source order speeds convergence (not needed for
    # correctness — SSP is exact under any source order).
    best_c = np.where(mask, cost, np.nan)
    order = np.argsort(np.nanmin(np.where(mask.any(axis=1)[:, None],
                                          best_c, np.inf), axis=1))
    for m in order:
        if not mask[m].any():
            continue
        dist = c[m].copy()                       # source job m -> each region
        prev = np.full(N, -1, dtype=np.int64)    # predecessor region (-1=src)
        R, job_pick = _reroute_arcs(c, mask, assign, N)
        # Bellman-Ford: N-1 rounds of full relaxation over the N×N arcs.
        for _ in range(N - 1):
            cand = dist[:, None] + R             # via-n cost to each n2
            via = np.argmin(cand, axis=0)
            better = cand[via, np.arange(N)] < dist - 1e-15
            if not better.any():
                break
            dist = np.where(better, cand[via, np.arange(N)], dist)
            prev = np.where(better, via, prev)

        free = used < capacity
        if not (free & np.isfinite(dist)).any():
            continue                              # no augmenting path
        tgt = int(np.argmin(np.where(free, dist, _INF)))

        # Retrace: reroute the picked job along every edge, then place m.
        # Guard against zero-cost cycles in the predecessor pointers (possible
        # only under exact float ties): fall back to direct placement.
        n2, hops, moves = tgt, 0, []
        while prev[n2] >= 0 and hops <= N:
            n1 = int(prev[n2])
            moves.append((int(job_pick[n1, n2]), n2))
            n2, hops = n1, hops + 1
        if hops > N:
            assign[m] = tgt
        else:
            for j, dst in moves:
                assign[j] = dst
            assign[m] = n2
        used[tgt] += 1
    return assign


@solvers.register("flow")
def solve(cost: np.ndarray, allowed: np.ndarray, capacity: np.ndarray, *,
          soften: bool = False, overrun: Optional[np.ndarray] = None,
          tol: Optional[np.ndarray] = None,
          sigma: float = 10.0) -> solvers.SolveResult:
    def run() -> solvers.SolveResult:
        M, N = cost.shape
        if soften:
            assert overrun is not None and tol is not None
            c_eff = solvers.soft_cost(cost, allowed, overrun, tol, sigma)
            mask = np.ones_like(allowed, dtype=bool)
        else:
            c_eff = cost.astype(np.float64)
            mask = allowed.astype(bool)

        assign = _ssp_assign(np.asarray(c_eff, np.float64), mask,
                             capacity.astype(np.int64))
        penalties = np.zeros(M)
        if (assign < 0).any():
            status = "infeasible"
            obj = float("inf")
        else:
            status = "optimal"
            obj = float(c_eff[np.arange(M), assign].sum())
            if soften:
                excess = np.maximum(overrun - tol[:, None], 0.0)
                penalties = excess[np.arange(M), assign]
        return solvers.SolveResult(assign=assign, objective=obj,
                                   status=status, solve_time_s=0.0,
                                   penalties=penalties, backend="flow")
    return solvers._timed(run)
