"""Solver backends for the WaterWise MILP (paper Eqs 8-13) — the port's own
registry (counterpart of ``repro/core/solvers/__init__.py``).

Interchangeable backends behind one interface:

  ``pulp``   paper-faithful PuLP + CBC branch-and-cut, literal Eq 8-13
             formulation with explicit binary x[m,n] and penalty P[m,n].
             Registered only when PuLP (an optional dependency) is
             importable; without it the literal-MILP cross-checks use
             ``scipy``.
  ``scipy``  HiGHS via scipy.optimize.milp, same formulation in sparse form
             (the default of ``solve``).
  ``flow``   exact successive-shortest-path min-cost flow on the host
             (numpy), specialized to the capacitated assignment structure.
  ``torch``  entropic OT (log-space Sinkhorn, eager PyTorch on a device) +
             host vertex rounding — the port of the reference ``jax``
             backend.
  ``fused``  the ``torch`` backend with every device stage (soft-cost fold,
             masking, normalization, OT padding, annealed Sinkhorn, plan
             extraction) run on the device with one upload and one
             transfer back per round; on a CUDA device its Sinkhorn inner
             loop is the hand-written kernel (see ``repro_torch.core.round``).

All backends consume a cost matrix + arc filter + capacities and return a
``SolveResult``. ``soften=True`` activates the paper's penalty method
(Eqs 12-13): forbidden arcs become allowed at cost ``+ sigma * overrun_excess``.
Device backends also take ``device``: ``None`` means the CUDA card (and
raises without one), ``"cpu"`` runs them on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional, Set

import numpy as np

import repro_torch.obs as obs

BIG = 1e6  # cost of structurally-forbidden arcs in re-derived cost matrices


@dataclasses.dataclass
class SolveResult:
    assign: np.ndarray          # [M] region index, or -1 if unassigned
    objective: float
    status: str                 # "optimal" | "infeasible" | "rounded"
    solve_time_s: float
    penalties: np.ndarray       # [M] tolerance-overrun P value on chosen arc
    backend: str

    @property
    def feasible(self) -> bool:
        return self.status in ("optimal", "rounded") and (self.assign >= 0).all()


def soft_cost(cost: np.ndarray, allowed: np.ndarray, overrun: np.ndarray,
              tol: np.ndarray, sigma: float) -> np.ndarray:
    """Fold the Eq 12-13 penalty into per-arc costs.

    Because each job takes exactly one arc, the optimal penalty variable is
    P[m,n] = max(0, overrun[m,n] - tol[m]) on the chosen arc — so the soft
    MILP is exactly the hard transportation problem with modified costs.
    """
    excess = np.maximum(overrun - tol[:, None], 0.0)
    del allowed  # every arc becomes allowed under the soft relaxation
    return cost + sigma * excess


def _timed(fn: Callable[[], SolveResult],
           name: str = "solver.solve") -> SolveResult:
    """Time one backend solve via an obs span. ``solve_time_s`` is the
    span's wall time — identical semantics (one perf_counter pair) to
    the old inline timing whether obs is enabled or not."""
    with obs.timed(name) as t:
        res = fn()
        obs.annotate(backend=res.backend, status=res.status,
                     jobs=int(res.assign.shape[0]))
    res.solve_time_s = t.elapsed_s
    return res


_REGISTRY: Dict[str, Callable] = {}
# Backends that run on a torch device and take ``device=``.
_ON_DEVICE: Set[str] = set()


def register(name: str, *, on_device: bool = False):
    def deco(fn):
        _REGISTRY[name] = fn
        if on_device:
            _ON_DEVICE.add(name)
        return fn
    return deco


def get_solver(name: str) -> Callable:
    if name not in _REGISTRY:
        # Import side-effect registration. PuLP is optional; its module
        # import is a no-op when it is unavailable.
        from repro_torch.core.solvers import (  # noqa: F401
            flow_solver, pulp_solver, scipy_solver, torch_solver)
        from repro_torch.core import round  # noqa: F401  (registers "fused")
    if name not in _REGISTRY:
        hint = (" (the JAX package's backend; the port's counterpart is "
                "'torch')" if name == "jax" else "")
        raise KeyError(f"solver backend {name!r} unavailable{hint}; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends() -> list:
    get_solver("flow")  # trigger registration
    return sorted(_REGISTRY)


# Thread-local solve interception: a batching driver (the ``device``
# executor) installs a per-thread hook around a cell's whole run; every
# ``solve()`` the cell issues is offered to the hook first, which may
# return a SolveResult computed elsewhere (a batch shared with other cells'
# threads) or ``None`` to decline — declined solves run the normal backend
# in-thread. Thread-local by design: cells running concurrently each carry
# their own hook, and code outside an ``intercepted`` block is never
# affected.
_LOCAL = threading.local()


@contextlib.contextmanager
def intercepted(hook: Callable):
    """Install ``hook(cost, allowed, capacity, *, backend, soften, overrun,
    tol, sigma, device) -> Optional[SolveResult]`` for ``solve()`` calls on
    the current thread. Nests: the innermost hook wins; ``None``
    restores."""
    prev = getattr(_LOCAL, "hook", None)
    _LOCAL.hook = hook
    try:
        yield
    finally:
        _LOCAL.hook = prev


def solve(cost: np.ndarray, allowed: np.ndarray, capacity: np.ndarray,
          *, backend: str = "scipy", soften: bool = False,
          overrun: Optional[np.ndarray] = None,
          tol: Optional[np.ndarray] = None, sigma: float = 10.0,
          device=None) -> SolveResult:
    """Unified entry point. See module docstring; ``device`` reaches the
    device backends only (and the current thread's hook, if any)."""
    cost = np.asarray(cost, dtype=np.float64)
    allowed = np.asarray(allowed, bool)
    capacity = np.asarray(capacity)
    overrun = None if overrun is None else np.asarray(overrun)
    tol = None if tol is None else np.asarray(tol)
    hook = getattr(_LOCAL, "hook", None)
    if hook is not None:
        res = hook(cost, allowed, capacity, backend=backend, soften=soften,
                   overrun=overrun, tol=tol, sigma=sigma, device=device)
        if res is not None:
            return res
    fn = get_solver(backend)
    kw = dict(device=device) if backend in _ON_DEVICE else {}
    return fn(cost, allowed, capacity, soften=soften, overrun=overrun,
              tol=tol, sigma=sigma, **kw)


def solve_many(costs, alloweds, capacities, *, backend: str = "torch",
               soften: bool = False, overruns=None, tols=None,
               sigma: float = 10.0, device=None) -> list:
    """Solve K independent instances; returns SolveResults in input order.

    The ``torch`` backend buckets instances by padded shape and runs each
    bucket's Sinkhorn once over a leading instance axis (see
    ``torch_solver.solve_many``) — the amortized path for queued scheduling
    windows. Every other backend falls back to a per-instance loop. The
    reference's default ``jax`` is the port's ``torch``.
    """
    get_solver(backend)  # trigger registration / validate name
    if backend == "torch":
        from repro_torch.core.solvers import torch_solver
        return torch_solver.solve_many(costs, alloweds, capacities,
                                       soften=soften, overruns=overruns,
                                       tols=tols, sigma=sigma, device=device)
    K = len(costs)
    overruns = overruns if overruns is not None else [None] * K
    tols = tols if tols is not None else [None] * K
    return [solve(costs[k], alloweds[k], capacities[k], backend=backend,
                  soften=soften, overrun=overruns[k], tol=tols[k],
                  sigma=sigma, device=device)
            for k in range(K)]
