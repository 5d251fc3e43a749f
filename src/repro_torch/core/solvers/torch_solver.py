"""Entropic-OT solver on a torch device — backend ``torch``, the port of the
reference ``repro/core/solvers/jax_solver.py``.

The paper solves Eq 8-11 with CBC branch-and-cut on a CPU head node. Here,
as in the reference, the same transportation polytope is solved as
entropic-regularized optimal transport:

    min <C, X> - eps*H(X)   s.t.  X*1 = a,  X^T*1 = b

with forbidden arcs priced at +BIG and one dummy supply row (supply =
sum(cap) - M, zero cost) turning capacity inequalities into equalities.
Log-domain Sinkhorn with eps-annealing drives X toward a vertex; the host
then rounds it to an integral assignment (greedy, SSP repair, 2-swap).

The Sinkhorn loop here is eager PyTorch in the reference's XLA order
(g <- f, then f <- g) and float32 throughout. The numpy host stages are
copies of the reference's, so equal plans round to equal assignments.
Warm-started adaptive Sinkhorn and the batched ``solve_many`` are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import solvers
from repro_torch.runtime import platform

BIG = 1e4          # forbidden-arc cost after normalization to ~unit scale
_NEG = -1e9        # log-domain mask value / zero-mass row marginal

# Row-count buckets: cost matrices are padded up to the next bucket (with
# zero-mass rows), so a whole simulation sees a handful of shapes instead of
# one per distinct M. Kept equal to the reference's table (pinned in tests).
BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)

# The annealed-Sinkhorn schedule; solver spans annotate these so traces
# record the effective iteration budget (iters x anneal_stages) per solve.
SINKHORN_EPS0 = 0.5
SINKHORN_ITERS = 60
SINKHORN_STAGES = 6


# Ad-hoc overflow bucket sizes already warned about: the overflow warning
# fires once per *size*, not once per solve.
_OVERFLOW_WARNED: set = set()


def bucket_for(rows: int) -> int:
    """Smallest bucket >= rows (next power of two beyond the table)."""
    for b in BUCKETS:
        if rows <= b:
            return b
    b = BUCKETS[-1]
    while b < rows:
        b *= 2
    if b not in _OVERFLOW_WARNED:
        _OVERFLOW_WARNED.add(b)
        obs.warn("solver.bucket_overflow",
                 f"instance with {rows} rows exceeds the largest padded "
                 f"bucket {BUCKETS[-1]}; falling back to ad-hoc bucket {b}")
    return b


def eps_schedule(eps0: float, eps_min: float, anneal_stages: int,
                 device=None) -> torch.Tensor:
    """The geometric eps schedule, computed in float32 as the reference's
    ``eps0 * decay ** arange(stages)`` is."""
    decay = (eps_min / eps0) ** (1.0 / max(anneal_stages - 1, 1))
    k = torch.arange(anneal_stages, dtype=torch.float32, device=device)
    return eps0 * torch.tensor(decay, dtype=torch.float32,
                               device=device) ** k


def _sinkhorn_log_impl(C: torch.Tensor, log_a: torch.Tensor,
                       log_b: torch.Tensor, eps0: float = 0.5,
                       eps_min: float = 0.01, iters: int = 60,
                       anneal_stages: int = 6):
    """Log-stabilized Sinkhorn with geometric eps-annealing, eager.

    Args:
      C: [M, N] cost (forbidden arcs already priced at BIG).
      log_a: [M] log row marginals; log_b: [N] log col marginals. Rows with
        log_a ~ _NEG carry no mass — padding rows are exact no-ops.
    Returns:
      (f, g, eps): dual potentials and the final eps (a 0-d tensor). The
      primal plan is X = exp((f[:,None] + g[None,:] - C) / eps).
    """
    eps_sched = eps_schedule(eps0, eps_min, anneal_stages, C.device)
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_b)
    for eps in eps_sched:
        for _ in range(iters):
            g = eps * (log_b - torch.logsumexp((f[:, None] - C) / eps, dim=0))
            f = eps * (log_a - torch.logsumexp((g[None, :] - C) / eps, dim=1))
    return f, g, eps_sched[-1]


def plan_from_duals(C, f, g, eps):
    return torch.exp((f[:, None] + g[None, :] - C) / eps)


def _round_to_vertex(X: np.ndarray, cost: np.ndarray, mask: np.ndarray,
                     capacity: np.ndarray) -> np.ndarray:
    """Greedy confidence rounding + cheapest-feasible repair.

    Jobs are committed in decreasing order of plan confidence (max row prob);
    each takes its argmax column if capacity remains, else its cheapest
    allowed column with spare capacity.
    """
    M, N = cost.shape
    assign = np.full(M, -1, dtype=np.int64)
    left = capacity.astype(np.int64).copy()
    Xm = np.where(mask, X, -np.inf)
    conf = Xm.max(axis=1)
    for m in np.argsort(-conf):
        if not mask[m].any():
            continue
        prefs = np.argsort(np.where(mask[m], cost[m] - 2.0 * BIG * Xm[m],
                                    np.inf))
        for n in prefs:
            if mask[m, n] and left[n] > 0:
                assign[m] = n
                left[n] -= 1
                break
    return assign


def _improve_2swap(assign: np.ndarray, cost: np.ndarray, mask: np.ndarray,
                   capacity: np.ndarray, rounds: int = 3) -> np.ndarray:
    """Local search: single-job moves + pairwise swaps until no improvement.

    Polishes the rounded vertex; with the Sinkhorn duals already near-optimal
    this usually closes the (small) remaining gap to the exact optimum.
    """
    M, N = cost.shape
    used = np.bincount(assign[assign >= 0], minlength=N)
    for _ in range(rounds):
        improved = False
        # Single moves into spare capacity.
        for m in range(M):
            if assign[m] < 0:
                continue
            cur = assign[m]
            deltas = np.where(mask[m] & (used < capacity),
                              cost[m] - cost[m, cur], np.inf)
            deltas[cur] = np.inf
            n = int(np.argmin(deltas))
            if deltas[n] < -1e-12:
                used[cur] -= 1
                used[n] += 1
                assign[m] = n
                improved = True
        # Pairwise swaps (vectorized over the job×job delta matrix).
        a = assign
        ok = a >= 0
        cm = cost[np.arange(M), np.where(ok, a, 0)]
        # delta of swapping m1<->m2: c[m1,a2]+c[m2,a1]-c[m1,a1]-c[m2,a2]
        c_m1_a2 = np.where(mask[:, a] & ok[None, :], cost[:, a], np.inf)
        delta = c_m1_a2 + c_m1_a2.T - cm[:, None] - cm[None, :]
        delta[~ok] = np.inf
        delta[:, ~ok] = np.inf
        np.fill_diagonal(delta, np.inf)
        m1, m2 = np.unravel_index(np.argmin(delta), delta.shape)
        if delta[m1, m2] < -1e-12:
            assign[m1], assign[m2] = assign[m2], assign[m1]
            improved = True
        if not improved:
            break
    return assign


def _effective(cost, allowed, soften, overrun, tol, sigma):
    if soften:
        assert overrun is not None and tol is not None
        c_eff = solvers.soft_cost(cost, allowed, overrun, tol, sigma)
        mask = np.ones_like(allowed, dtype=bool)
    else:
        c_eff = cost.astype(np.float64)
        mask = allowed.astype(bool)
    return c_eff, mask


def _infeasible(M):
    return solvers.SolveResult(assign=np.full(M, -1), objective=float("inf"),
                               status="infeasible", solve_time_s=0.0,
                               penalties=np.zeros(M), backend="torch")


def _prepare(c_eff, mask, cap, pad_rows: int):
    """Padded OT inputs: [M real rows | dummy slack row | pad_rows zero-mass
    rows]. Zero-mass rows (log marginal = _NEG) are exact no-ops in the
    log-domain updates, so padding changes nothing but the compiled shape."""
    M, N = c_eff.shape
    # Normalize costs to ~unit scale so ε has a universal meaning.
    scale = max(float(np.abs(c_eff[mask]).max()), 1e-9)
    Cn = np.where(mask, c_eff / scale, BIG)
    slack = int(cap.sum()) - M
    # Dummy row absorbs spare capacity (zero cost everywhere).
    C = np.vstack([Cn, np.zeros((1 + pad_rows, N))]).astype(np.float32)
    a = np.concatenate([np.ones(M), [max(slack, 1e-9)]])
    total = a.sum()
    log_a = np.concatenate([np.log(a / total),
                            np.full(pad_rows, _NEG)]).astype(np.float32)
    log_b = np.log(np.maximum(cap.astype(np.float64), 1e-12)
                   / total).astype(np.float32)
    return C, log_a, log_b, Cn


def _finalize(X, Cn, c_eff, mask, cap, soften, overrun, tol):
    """Round the (real-row) plan to an integral vertex + polish + price."""
    M = Cn.shape[0]
    X = X / np.maximum(X.sum(axis=1, keepdims=True), 1e-30)
    assign = _round_to_vertex(X, Cn, mask, cap)
    if (assign < 0).any():
        # Greedy rounding stranded a job (capacity-tight instance): repair
        # with the exact successive-shortest-path solver on the same
        # normalized costs. Only genuinely infeasible instances survive this.
        from repro_torch.core.solvers import flow_solver
        assign = flow_solver._ssp_assign(Cn, mask, cap)
    if (assign >= 0).all():
        assign = _improve_2swap(assign, Cn, mask, cap)
    penalties = np.zeros(M)
    if (assign < 0).any():
        return solvers.SolveResult(assign=assign, objective=float("inf"),
                                   status="infeasible", solve_time_s=0.0,
                                   penalties=penalties, backend="torch")
    obj = float(c_eff[np.arange(M), assign].sum())
    if soften:
        excess = np.maximum(overrun - tol[:, None], 0.0)
        penalties = excess[np.arange(M), assign]
    return solvers.SolveResult(assign=assign, objective=obj,
                               status="rounded", solve_time_s=0.0,
                               penalties=penalties, backend="torch")


@solvers.register("torch", on_device=True)
def solve(cost: np.ndarray, allowed: np.ndarray, capacity: np.ndarray, *,
          soften: bool = False, overrun: Optional[np.ndarray] = None,
          tol: Optional[np.ndarray] = None, sigma: float = 10.0,
          eps_min: float = 0.005, device=None) -> solvers.SolveResult:
    dev = platform.device(device)

    def run() -> solvers.SolveResult:
        M, N = cost.shape
        c_eff, mask = _effective(cost, allowed, soften, overrun, tol, sigma)
        cap = capacity.astype(np.int64)
        if int(cap.sum()) < M or not mask.any(axis=1).all():
            return _infeasible(M)
        rows = M + 1
        pad = bucket_for(rows) - rows
        C, log_a, log_b, Cn = _prepare(c_eff, mask, cap, pad)
        C = torch.from_numpy(C).to(dev)
        f, g, eps = _sinkhorn_log_impl(
            C, torch.from_numpy(log_a).to(dev),
            torch.from_numpy(log_b).to(dev), SINKHORN_EPS0, eps_min,
            SINKHORN_ITERS, SINKHORN_STAGES)
        X = plan_from_duals(C, f, g, eps)[:M].cpu().numpy()
        if obs.enabled():
            # row-marginal residual: each real row targets mass 1/sum(cap)
            total = max(float(cap.sum()), 1e-9)
            residual = float(np.abs(X.sum(axis=1) * total - 1.0).max())
            obs.annotate(bucket=rows + pad, pad=pad,
                         occupancy=rows / (rows + pad),
                         sinkhorn_iters=SINKHORN_ITERS * SINKHORN_STAGES,
                         eps0=SINKHORN_EPS0, eps_min=eps_min,
                         anneal_stages=SINKHORN_STAGES, residual=residual,
                         device=str(dev))
        return _finalize(X, Cn, c_eff, mask, cap, soften, overrun, tol)
    return solvers._timed(run)
