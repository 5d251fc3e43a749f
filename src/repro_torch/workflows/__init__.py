"""Precedence-constrained (DAG) workloads — ``repro_torch.workflows``, the
port of ``repro/workflows`` (numpy, as there).

Makes workflows first-class across the whole pipeline: a validated
task-graph model (``WorkflowSpec``), vectorized critical-path slack
(``cpath`` — the shared deadline definition the urgency ranking, the
deferral queue, and the Eq-11 temporal mask all derive from), deterministic
synthetic DAG trace generators (``generators`` — chain / fan-out / diamond /
Montage-like mixes in ``sim.trace`` style), and an ichnos-style converter
for Nextflow/Spark-shaped workflow trace CSVs (``ingest``).

The engine side lives in ``repro_torch.sim.engine``: a task becomes
schedulable only when every predecessor has finished, in batch replay and
``repro_torch.serve`` streaming alike (same code path, so batch/stream bit
parity holds by construction).
"""
from repro_torch.workflows.cpath import (CycleError, assign_deadlines,
                                         critical_path_s,
                                         longest_path_to_sink,
                                         topological_order)
from repro_torch.workflows.generators import workflow_trace
from repro_torch.workflows.ingest import load_workflow_csv
from repro_torch.workflows.spec import (WorkflowSpec,
                                        group_records_by_workflow,
                                        precedence_violations,
                                        workflow_miss_rate)

__all__ = [
    "CycleError",
    "WorkflowSpec",
    "assign_deadlines",
    "critical_path_s",
    "group_records_by_workflow",
    "load_workflow_csv",
    "longest_path_to_sink",
    "precedence_violations",
    "topological_order",
    "workflow_miss_rate",
    "workflow_trace",
]
