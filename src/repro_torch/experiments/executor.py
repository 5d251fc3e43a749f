"""ONE ``Executor`` abstraction over interchangeable backends (the port of
``repro/experiments/executor.py``).

Every backend maps a list of experiment cells to tidy rows with identical
values — the backend choice is an operational knob (latency, parallelism,
scale), never a semantic one:

* ``serial``   — in-process loop; zero overhead, fully deterministic.
* ``process``  — one worker process per *cell* (cells are independent and
  rebuilt from primitives). Workers are *spawned*, never forked: a child
  forked after its parent touched CUDA cannot use the card. Each worker
  holds its own CUDA context and loads the kernels already built under
  ``build/repro_torch/``, so on the card the auto-sized pool stops at
  ``CARD_WORKERS``.
* ``sharded``  — one cell split by arrival time across workers with
  engine-state handoff; and
* ``device``   — many cells' scheduling rounds batched into one device
  program. Both are registered under the reference's grammar and schemas
  and are not ported yet (queue item [5]): their ``run`` raises
  ``NotImplementedError``.

Executors are spec-addressable through the shared grammar —
``"process[max_workers=4]"`` — with schemas introspected from the backend
constructors, as in the reference. The torch ``device`` the policies run on
is not a constructor argument: it travels beside the cells,
``run(cells, device=...)`` (None: the CUDA card), and reaches a worker
process as a string.

A crashed cell never aborts the others on any backend: its row carries the
failure in the ``error`` column and execution continues.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
from typing import Dict, List, Union

import repro_torch.obs as obs
from repro_torch.experiments import runner
from repro_torch.experiments.plan import Cell
from repro_torch.spec import (Param, parse_raw, params_from_signature,
                              unknown_name_error, validate_params)


# Auto-sized process pools on the card stop here: each worker opens its own
# CUDA context on the one card. Phase 9(b) of chip_smoke.py runs this many
# (its four cells through ``"process"``) and prints the device memory the
# pool held; no other count was measured.
CARD_WORKERS = 3


def auto_workers(n_cells: int, device=None) -> int:
    """Worker count for ``max_workers=0``: ``min(cpu_count, n_cells)``, and
    at most ``CARD_WORKERS`` when the policies run on the card (``device``
    None or a CUDA device)."""
    n = min(os.cpu_count() or 1, n_cells)
    if device is None or str(device).startswith("cuda"):
        n = min(n, CARD_WORKERS)
    return n


class Executor:
    """Maps cells to tidy rows; subclasses define *where* cells run."""

    name = "?"

    def run(self, cells: List[Cell], device=None) -> List[Dict]:
        raise NotImplementedError

    def _guarded(self, fn, cell: Cell, device=None) -> Dict:
        try:
            return fn(cell, device=device)
        except Exception as e:              # noqa: BLE001 — error-row contract
            return runner.error_row(cell, e)


class SerialExecutor(Executor):
    """In-process, one cell after another."""

    name = "serial"

    def run(self, cells: List[Cell], device=None) -> List[Dict]:
        return [self._guarded(runner.run_cell, c, device) for c in cells]


class ProcessExecutor(Executor):
    """One worker process per cell (the classic sweep fan-out).

    ``max_workers=0`` auto-sizes to ``min(cpu_count, len(cells))``, capped
    at ``CARD_WORKERS`` on the card (``auto_workers``). Serial
    and process runs produce identical rows: every cell is deterministic
    in its specs and rebuilt from primitives inside the worker. Workers
    start by ``spawn``, with the device as a string.
    """

    name = "process"

    def __init__(self, max_workers: int = 0):
        self.max_workers = int(max_workers)

    def run(self, cells: List[Cell], device=None) -> List[Dict]:
        workers = self.max_workers or auto_workers(len(cells), device)
        if workers <= 1 or len(cells) <= 1:
            return SerialExecutor().run(cells, device=device)
        dev = "cuda" if device is None else str(device)
        rows: List[Dict] = []
        fn = runner.run_cell_obs if obs.enabled() else runner.run_cell
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=ctx) as pool:
            futs = [pool.submit(fn, c, device=dev) for c in cells]
            for cell, fut in zip(cells, futs):
                try:
                    row = fut.result()
                    snap = row.pop("_obs", None)
                    if snap:
                        obs.merge(snap)
                    rows.append(row)
                except Exception as e:      # noqa: BLE001 — error-row contract
                    rows.append(runner.error_row(cell, e))
        return rows


class ShardedExecutor(Executor):
    """Splits each cell's trace across ``shards`` worker slices (not
    ported yet: queue item [5]).

    ``shards`` trace slices per cell; ``max_workers=0`` auto-sizes the
    per-cell pool; ``handoff_s=0`` auto-sizes the warm-up handoff window.
    """

    name = "sharded"

    def __init__(self, shards: int = 2, max_workers: int = 0,
                 handoff_s: float = 0.0):
        self.shards = int(shards)
        self.max_workers = int(max_workers)
        self.handoff_s = float(handoff_s)

    def run(self, cells: List[Cell], device=None) -> List[Dict]:
        raise NotImplementedError(
            "the sharded executor (engine-state handoff across trace "
            "slices) is not ported yet (queue item [5]); use 'serial' or "
            "'process'")


class DeviceExecutor(Executor):
    """Device-parallel cell execution, the cells' fused solves batched into
    one device program a round wave (not ported yet: queue item [5]).

    ``devices=0`` auto-sizes to every visible device; ``max_cells=0`` runs
    all batchable cells as one wave.
    """

    name = "device"

    def __init__(self, devices: int = 0, max_cells: int = 0):
        self.devices = int(devices)
        self.max_cells = int(max_cells)

    def run(self, cells: List[Cell], device=None) -> List[Dict]:
        raise NotImplementedError(
            "the device executor (cells' fused solves batched over a cell "
            "axis) is not ported yet (queue item [5]); use 'serial' or "
            "'process'")


_EXECUTORS = {cls.name: cls
              for cls in (SerialExecutor, ProcessExecutor, ShardedExecutor,
                          DeviceExecutor)}

ExecutorLike = Union[str, Executor]


def list_executors() -> List[str]:
    return sorted(_EXECUTORS)


def executor_schema(name: str) -> Dict[str, Param]:
    cls = _EXECUTORS.get(name)
    if cls is None:
        raise unknown_name_error("executor", name, list(_EXECUTORS))
    return {p.name: p
            for p in params_from_signature(cls.__init__, drop_positional=1)}


def get_executor(spec: ExecutorLike, **overrides) -> Executor:
    """Resolve an executor spec — ``"process[max_workers=4]"`` — to a
    backend instance. ``overrides`` (CLI flags; ``None`` values ignored)
    are validated against the backend's introspected schema exactly like
    any other spec params."""
    if isinstance(spec, Executor):
        return spec
    name, raw = parse_raw(spec, kind="executor")
    schema = executor_schema(name)
    merged = dict(raw)
    merged.update({k: v for k, v in overrides.items() if v is not None})
    return _EXECUTORS[name](**validate_params("executor", name, schema,
                                              merged))


def describe_executors() -> str:
    lines = []
    for name in list_executors():
        cls = _EXECUTORS[name]
        doc = (cls.__doc__ or "").strip().splitlines()[0]
        lines.append(f"{name:10s} {doc}")
        for p in executor_schema(name).values():
            lines.append(f"    {p.describe()}")
    return "\n".join(lines)
