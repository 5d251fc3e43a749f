"""Paper-faithful MILP backend: PuLP + CBC (paper §4 "MILP Optimization";
the port of ``repro/core/solvers/pulp_solver.py``).

Implements Eq (8) objective with Eq (9) assignment, Eq (10) capacity and
Eq (11) delay-tolerance constraints as a *literal* MILP over binary x[m,n];
``soften=True`` adds the Eq (12)-(13) penalty variables P[m,n] >= 0 exactly
as published (not the folded-cost shortcut — that equivalence is *tested*
against this literal formulation in tests/test_solvers.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

try:  # optional dependency, registered only where it is installed
    import pulp
    PULP_AVAILABLE = True
except ImportError:  # pragma: no cover - environment dependent
    pulp = None
    PULP_AVAILABLE = False

from repro_torch.core import solvers


def _register(fn):
    return solvers.register("pulp")(fn) if PULP_AVAILABLE else fn


@_register
def solve(cost: np.ndarray, allowed: np.ndarray, capacity: np.ndarray, *,
          soften: bool = False, overrun: Optional[np.ndarray] = None,
          tol: Optional[np.ndarray] = None,
          sigma: float = 10.0) -> solvers.SolveResult:
    def run() -> solvers.SolveResult:
        M, N = cost.shape
        prob = pulp.LpProblem("waterwise", pulp.LpMinimize)
        x = {}
        for m in range(M):
            for n in range(N):
                if allowed[m, n] or soften:
                    x[m, n] = pulp.LpVariable(f"x_{m}_{n}", cat="Binary")

        terms = [cost[m, n] * v for (m, n), v in x.items()]
        p = {}
        if soften:
            # Eq (12)-(13): relaxed constraint sum_n x·(L/t) <= TOL + P,
            # with sigma·sum P added to the objective. P only needs to exist
            # where the arc can actually overrun.
            assert overrun is not None and tol is not None
            for m in range(M):
                for n in range(N):
                    if overrun[m, n] > tol[m]:
                        p[m, n] = pulp.LpVariable(f"p_{m}_{n}", lowBound=0.0)
            terms += [sigma * v for v in p.values()]
            for m in range(M):
                # sum_n x[m,n]·overrun[m,n] <= TOL% + sum_n P[m,n]  (Eq 13)
                lhs = pulp.lpSum(overrun[m, n] * x[m, n] for n in range(N)
                                 if (m, n) in x)
                rhs = tol[m] + pulp.lpSum(p[m, n] for n in range(N)
                                          if (m, n) in p)
                prob += lhs <= rhs
        prob += pulp.lpSum(terms)

        for m in range(M):                                   # Eq (9)
            prob += pulp.lpSum(x[m, n] for n in range(N) if (m, n) in x) == 1
        for n in range(N):                                   # Eq (10)
            arcs = [x[m, n] for m in range(M) if (m, n) in x]
            if arcs:
                prob += pulp.lpSum(arcs) <= float(capacity[n])

        status = prob.solve(pulp.PULP_CBC_CMD(msg=False))
        assign = np.full(M, -1, dtype=np.int64)
        penalties = np.zeros(M)
        if pulp.LpStatus[status] == "Optimal":
            for (m, n), v in x.items():
                if v.value() is not None and v.value() > 0.5:
                    assign[m] = n
            for (m, n), v in p.items():
                if assign[m] == n and v.value() is not None:
                    penalties[m] = v.value()
            obj = float(pulp.value(prob.objective))
            st = "optimal"
        else:
            obj = float("inf")
            st = "infeasible"
        return solvers.SolveResult(assign=assign, objective=obj, status=st,
                                   solve_time_s=0.0, penalties=penalties,
                                   backend="pulp")
    return solvers._timed(run)
