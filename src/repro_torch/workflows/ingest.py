"""Ichnos-style workflow trace converter (Nextflow/Spark-shaped CSVs; the
port of ``repro/workflows/ingest.py``).

Carbon-footprint tooling for scientific workflows (e.g. ichnos for Nextflow
traces) exports per-task rows: a workflow/run id, a task id, submission and
runtime, a CPU-utilization or energy figure, and the task's predecessor
list. ``load_workflow_csv`` reads that shape into validated
``WorkflowSpec``s and returns finalized ``Job``s (deps + critical-path
deadlines stamped), ready for any scenario/engine surface.

Canonical columns::

    workflow_id, task_id, submit_s, duration_s, energy_kwh, home_region, deps

``deps`` is a ``;``-separated list of predecessor task_ids *within the same
workflow* (empty for source tasks). Real exports name columns differently —
``column_map`` maps canonical -> CSV header and ``unit_scale`` rescales
numeric columns after mapping (e.g. ``{"duration_s": 1e-3}`` for millisecond
runtimes), mirroring ``sim.trace.load_csv``. When the export carries
``cpu_util`` (0..1) instead of energy, map it via
``column_map={"energy_kwh": "cpu_util"}`` and pass ``util_to_energy=True``
to convert through the per-node power model.
"""
from __future__ import annotations

import csv
from typing import Dict, List, Optional, Tuple

from repro_torch.core import footprint
from repro_torch.core.problem import Job
from repro_torch.workflows.spec import WorkflowSpec

_CSV_CANONICAL = ("workflow_id", "task_id", "submit_s", "duration_s",
                  "energy_kwh", "home_region", "deps")


def load_workflow_csv(path: str, tolerance: float = 0.5,
                      column_map: Optional[dict] = None,
                      unit_scale: Optional[dict] = None,
                      package_bytes: float = 2e9,
                      util_to_energy: bool = False,
                      server: footprint.ServerSpec = None) -> List[Job]:
    """Read an ichnos-style per-task workflow CSV into finalized ``Job``s.

    Task ids are remapped to globally unique sequential job_ids (the CSV's
    ids are only unique per workflow); ``deps`` are remapped alongside.
    Graphs are validated per workflow (``cpath.CycleError`` on cycles or
    dangling predecessors). All tasks of a workflow share the workflow's
    submit instant — the earliest ``submit_s`` among its rows — since
    release is gated by precedence, not by per-task submission.
    """
    cmap = {c: c for c in _CSV_CANONICAL}
    cmap.update(column_map or {})
    scale = unit_scale or {}
    server = server or footprint.m5_metal()

    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        headers = reader.fieldnames or []
        missing = [c for c in _CSV_CANONICAL if cmap[c] not in headers]
        if missing:
            raise ValueError(f"workflow trace {path!r} lacks columns for "
                             f"{missing}; available: {headers}")
        rows = list(reader)

    def num(row, c):
        return float(row[cmap[c]]) * float(scale.get(c, 1.0))

    # Group rows per workflow, preserving file order within each.
    by_wf: Dict[int, List[dict]] = {}
    for row in rows:
        by_wf.setdefault(int(float(row[cmap["workflow_id"]])), []).append(row)

    power = footprint.PowerModel.from_server(server)
    jobs: List[Job] = []
    next_id = 0
    for wf_id in sorted(by_wf):
        group = by_wf[wf_id]
        local: Dict[int, int] = {}               # CSV task_id -> job_id
        for row in group:
            local[int(float(row[cmap["task_id"]]))] = next_id
            next_id += 1
        submit = min(num(r, "submit_s") for r in group)
        tasks: List[Job] = []
        for row in group:
            dur = num(row, "duration_s")
            energy = num(row, "energy_kwh")
            if util_to_energy:
                energy = float(power.energy_kwh(energy, dur))
            dep_field = (row[cmap["deps"]] or "").strip()
            deps: Tuple[int, ...] = tuple(
                local.get(int(float(d)), -1)
                for d in dep_field.split(";") if d.strip())
            tasks.append(Job(
                job_id=local[int(float(row[cmap["task_id"]]))],
                home_region=int(float(row[cmap["home_region"]])),
                submit_time_s=submit, exec_time_s=dur, energy_kwh=energy,
                package_bytes=package_bytes, tolerance=tolerance,
                deps=deps))
        spec = WorkflowSpec(workflow_id=wf_id, tasks=tuple(tasks),
                            tolerance=tolerance)
        jobs.extend(spec.finalize())
    jobs.sort(key=lambda j: (j.submit_time_s, j.job_id))
    return jobs
