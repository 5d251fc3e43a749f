"""HiGHS MILP backend via scipy.optimize.milp (sparse formulation; the
port of ``repro/core/solvers/scipy_solver.py``, host numpy as there).

Same mathematical problem as pulp_solver, built as sparse LP data. The soft
variant uses the folded-cost reduction (see solvers.soft_cost): optimal
penalties are recovered per-arc afterwards. Exactness of the fold vs the
literal Eq 12-13 formulation is asserted in the JAX package's solver
tests.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.optimize as sopt
import scipy.sparse as sp

from repro_torch.core import solvers


@solvers.register("scipy")
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
            c_eff = cost
            mask = allowed

        mm, nn = np.nonzero(mask)
        A = len(mm)
        if A == 0 or np.unique(mm).size < M:
            return solvers.SolveResult(
                assign=np.full(M, -1), objective=float("inf"),
                status="infeasible", solve_time_s=0.0,
                penalties=np.zeros(M), backend="scipy")

        c = c_eff[mm, nn]
        # Rows 0..M-1: assignment (== 1). Rows M..M+N-1: capacity (<= cap).
        rows = np.concatenate([mm, M + nn])
        cols = np.concatenate([np.arange(A), np.arange(A)])
        vals = np.ones(2 * A)
        Acon = sp.csr_matrix((vals, (rows, cols)), shape=(M + N, A))
        lb = np.concatenate([np.ones(M), np.zeros(N)])
        ub = np.concatenate([np.ones(M), capacity.astype(np.float64)])
        constraints = sopt.LinearConstraint(Acon, lb, ub)
        res = sopt.milp(c=c, constraints=constraints,
                        integrality=np.ones(A),
                        bounds=sopt.Bounds(0, 1))

        assign = np.full(M, -1, dtype=np.int64)
        penalties = np.zeros(M)
        if res.success:
            chosen = res.x > 0.5
            assign[mm[chosen]] = nn[chosen]
            if soften:
                excess = np.maximum(overrun - tol[:, None], 0.0)
                sel = assign >= 0
                penalties[sel] = excess[np.nonzero(sel)[0], assign[sel]]
            return solvers.SolveResult(assign=assign, objective=float(res.fun),
                                       status="optimal", solve_time_s=0.0,
                                       penalties=penalties, backend="scipy")
        return solvers.SolveResult(assign=assign, objective=float("inf"),
                                   status="infeasible", solve_time_s=0.0,
                                   penalties=penalties, backend="scipy")
    return solvers._timed(run)
