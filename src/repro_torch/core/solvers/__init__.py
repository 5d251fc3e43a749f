"""Solver backends for the WaterWise MILP (paper Eqs 8-13) — the port's own
registry (counterpart of ``repro/core/solvers/__init__.py``).

Interchangeable backends behind one interface:

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

import dataclasses
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
        # Import side-effect registration.
        from repro_torch.core.solvers import (  # noqa: F401
            flow_solver, torch_solver)
        from repro_torch.core import round  # noqa: F401  (registers "fused")
    if name not in _REGISTRY:
        raise KeyError(f"solver backend {name!r} unavailable; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends() -> list:
    get_solver("flow")  # trigger registration
    return sorted(_REGISTRY)


def solve(cost: np.ndarray, allowed: np.ndarray, capacity: np.ndarray,
          *, backend: str = "flow", soften: bool = False,
          overrun: Optional[np.ndarray] = None,
          tol: Optional[np.ndarray] = None, sigma: float = 10.0,
          device=None) -> SolveResult:
    """Unified entry point. See module docstring; ``device`` reaches the
    device backends only."""
    cost = np.asarray(cost, dtype=np.float64)
    allowed = np.asarray(allowed, bool)
    capacity = np.asarray(capacity)
    overrun = None if overrun is None else np.asarray(overrun)
    tol = None if tol is None else np.asarray(tol)
    fn = get_solver(backend)
    kw = dict(device=device) if backend in _ON_DEVICE else {}
    return fn(cost, allowed, capacity, soften=soften, overrun=overrun,
              tol=tol, sigma=sigma, **kw)
