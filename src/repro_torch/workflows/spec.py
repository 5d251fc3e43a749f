"""``WorkflowSpec`` — the validated task-graph model
(the port of ``repro/workflows/spec.py``).

A workflow is a set of ``core.problem.Job`` tasks plus precedence edges
(``Job.deps`` — predecessor job_ids). ``WorkflowSpec.finalize()`` validates
the graph (acyclic, closed, unique ids), computes the vectorized
critical-path deadlines (``cpath.assign_deadlines``), and stamps each task
with ``workflow_id`` / ``deadline_override_s`` — after which the tasks flow
through every existing surface (batch replay, ``repro_torch.serve`` streaming,
the sharded executor) as ordinary jobs with precedence-release semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.core.problem import Job
from repro_torch.workflows import cpath


@dataclasses.dataclass(frozen=True)
class WorkflowSpec:
    """One precedence-constrained workflow: tasks + the DAG over them.

    ``tolerance`` is workflow-level: the whole graph may take
    ``(1+tolerance)·critical_path`` from its submit instant. Task-level
    ``Job.tolerance`` values are kept (they parameterize the shared
    slack/overrun algebra) but the binding deadline is the critical-path
    one.
    """
    workflow_id: int
    tasks: Tuple[Job, ...]
    tolerance: float = 0.5

    def __post_init__(self):
        # Validation is part of construction: an unvalidated spec never
        # exists. Raises cpath.CycleError on cycles/dangling/duplicate ids.
        self.edges()

    def job_ids(self) -> List[int]:
        return [t.job_id for t in self.tasks]

    def edges(self) -> np.ndarray:
        """(E, 2) local-index edge array (parent, child); validates the
        graph is closed over this task set and acyclic."""
        e = cpath.edges_from_deps(self.job_ids(),
                                  [t.deps for t in self.tasks])
        cpath.topological_order(len(self.tasks), e)      # acyclicity check
        return e

    @property
    def submit_s(self) -> float:
        return min(t.submit_time_s for t in self.tasks)

    @property
    def critical_path_s(self) -> float:
        return cpath.critical_path_s(
            np.array([t.exec_time_s for t in self.tasks]), self.edges())

    @property
    def deadline_s(self) -> float:
        return self.submit_s + (1.0 + self.tolerance) * self.critical_path_s

    def topological_tasks(self) -> List[Job]:
        order = cpath.topological_order(len(self.tasks), self.edges())
        return [self.tasks[i] for i in order]

    def finalize(self) -> List[Job]:
        """Stamp critical-path deadlines + workflow_id onto the tasks and
        return them (submit order). This is the handoff point into the
        ordinary trace/scheduling machinery."""
        exec_s = np.array([t.exec_time_s for t in self.tasks])
        deadlines, _ = cpath.assign_deadlines(exec_s, self.edges(),
                                              self.submit_s, self.tolerance)
        out = []
        for t, d in zip(self.tasks, deadlines):
            out.append(dataclasses.replace(
                t, workflow_id=self.workflow_id, deadline_override_s=float(d)))
        out.sort(key=lambda j: j.submit_time_s)
        return out


# ---------------------------------------------------------------------------
# Record-side helpers (metrics / benches / invariant checks)
# ---------------------------------------------------------------------------

def group_records_by_workflow(records: Iterable) -> Dict[int, list]:
    """Engine ``JobRecord``s grouped by owning workflow (DAG tasks only)."""
    groups: Dict[int, list] = {}
    for r in records:
        wid = r.job.workflow_id
        if wid is not None:
            groups.setdefault(wid, []).append(r)
    return groups


def precedence_violations(records: Sequence) -> int:
    """Number of (task, dep) pairs where a task started before a
    predecessor finished — MUST be zero (the engine's release invariant)."""
    finish = {r.job.job_id: r.finish_s for r in records}
    bad = 0
    for r in records:
        for d in r.job.deps:
            if d not in finish or finish[d] > r.start_s + 1e-6:
                bad += 1
    return bad


def workflow_miss_rate(records: Sequence) -> Tuple[float, int]:
    """(critical-path miss rate, workflows observed): the fraction of
    workflows whose last task finished past the workflow deadline
    (``max deadline_override_s`` over the workflow's tasks — the sinks
    carry exactly the workflow deadline)."""
    groups = group_records_by_workflow(records)
    if not groups:
        return 0.0, 0
    missed = 0
    for recs in groups.values():
        deadline = max(r.job.deadline_override_s for r in recs)
        if max(r.finish_s for r in recs) > deadline + 1e-6:
            missed += 1
    return missed / len(groups), len(groups)
