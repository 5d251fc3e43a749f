"""Vectorized critical-path slack over a task DAG
(the port of ``repro/workflows/cpath.py``).

The per-task ``tolerance·t`` slack of independent jobs is replaced, for
workflow tasks, by a *workflow-deadline-derived* budget: the workflow as a
whole may take ``(1+TOL)·critical_path`` from its submit, and each task's
latest feasible finish is

    deadline(v) = wf_deadline − (L(v) − t_v)

where ``L(v)`` is the longest path from ``v`` to any sink *including* v's
own execution time. A task finishing by ``deadline(v)`` leaves the longest
remaining downstream chain exactly enough room to meet the workflow
deadline; the slack the schedulers mask with is then
``deadline(v) − now − t_v`` (``problem.slack_budget`` — ONE shared
definition feeding the Eq-14 urgency ranking, the deferral queue, and the
Eq-11 temporal feasibility mask; they must agree or deferral cascades into
downstream misses).

All graph passes are vectorized over edge arrays (``np.maximum.at`` per
topological layer), not per-node Python loops — traces carry tens of
thousands of tasks.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class CycleError(ValueError):
    """The task graph is not acyclic (or has dangling dependencies)."""


def _layered_depths(n: int, edges: np.ndarray) -> np.ndarray:
    """Longest-path depth (in hops) of every node from the sources.

    Vectorized Kahn: each layer's outgoing edges are processed with one
    boolean gather + ``np.maximum.at`` / ``np.subtract.at``; every edge is
    touched exactly once across the whole sweep. Raises ``CycleError`` when
    the graph has a directed cycle.
    """
    depth = np.zeros(n, np.int64)
    if n == 0:
        return depth
    indeg = np.zeros(n, np.int64)
    if len(edges):
        np.add.at(indeg, edges[:, 1], 1)
    frontier = np.flatnonzero(indeg == 0)
    seen = 0
    in_frontier = np.zeros(n, bool)
    while frontier.size:
        seen += int(frontier.size)
        if not len(edges):
            break
        in_frontier[:] = False
        in_frontier[frontier] = True
        m = in_frontier[edges[:, 0]]
        src, dst = edges[m, 0], edges[m, 1]
        np.maximum.at(depth, dst, depth[src] + 1)
        np.subtract.at(indeg, dst, 1)
        frontier = np.unique(dst[indeg[dst] == 0])
    if seen < n:
        raise CycleError(
            f"task graph is not a DAG: {n - seen} of {n} tasks lie on a "
            "directed cycle")
    return depth


def topological_order(n: int, edges: np.ndarray) -> np.ndarray:
    """A deterministic topological order (parents before children):
    stable sort by (layer depth, node index). Raises ``CycleError``."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    depth = _layered_depths(n, edges)
    return np.lexsort((np.arange(n), depth))


def longest_path_to_sink(exec_s: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """``L[v]`` = weight of the longest path from ``v`` to any sink,
    *including* ``exec_s[v]`` itself. ``L.max()`` is the critical path.

    Processed sink-up by reversed-graph layers: a node at height ``h`` has
    every child final at heights ``< h``, so each layer is one vectorized
    ``np.maximum.at`` over its outgoing edges.
    """
    exec_s = np.asarray(exec_s, float)
    n = len(exec_s)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    L = exec_s.copy()
    if n == 0 or not len(edges):
        return L
    height = _layered_depths(n, edges[:, ::-1])    # hops up from the sinks
    eh = height[edges[:, 0]]
    for h in range(1, int(height.max()) + 1):
        m = eh == h
        src, dst = edges[m, 0], edges[m, 1]
        np.maximum.at(L, src, exec_s[src] + L[dst])
    return L


def critical_path_s(exec_s: np.ndarray, edges: np.ndarray) -> float:
    """Length (seconds of execution) of the workflow's critical path."""
    L = longest_path_to_sink(exec_s, edges)
    return float(L.max()) if len(L) else 0.0


def assign_deadlines(exec_s: np.ndarray, edges: np.ndarray,
                     submit_s: float, tolerance: float
                     ) -> Tuple[np.ndarray, float]:
    """Per-task absolute deadlines from one workflow-level tolerance.

    Returns ``(deadline[v], wf_deadline)`` with
    ``wf_deadline = submit + (1+tolerance)·critical_path`` and
    ``deadline[v] = wf_deadline − L[v] + t_v``. For a single-task workflow
    this degenerates to the plain-job deadline
    ``submit + (1+TOL)·t`` exactly.
    """
    L = longest_path_to_sink(exec_s, edges)
    cp = float(L.max()) if len(L) else 0.0
    wf_deadline = submit_s + (1.0 + tolerance) * cp
    return wf_deadline - L + np.asarray(exec_s, float), wf_deadline


def edges_from_deps(job_ids: Sequence[int],
                    deps: Sequence[Sequence[int]]) -> np.ndarray:
    """(E, 2) local-index edge array from per-task predecessor job_id lists.
    Raises ``CycleError`` on dependencies outside the task set."""
    index = {jid: i for i, jid in enumerate(job_ids)}
    if len(index) != len(job_ids):
        raise CycleError("duplicate task ids in one workflow")
    out = []
    for i, dd in enumerate(deps):
        for d in dd:
            if d not in index:
                raise CycleError(f"task {job_ids[i]} depends on unknown "
                                 f"task {d}")
            out.append((index[d], i))
    return (np.asarray(out, np.int64).reshape(-1, 2) if out
            else np.zeros((0, 2), np.int64))
