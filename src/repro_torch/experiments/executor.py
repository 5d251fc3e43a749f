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
* ``sharded``  — splits each *single* cell's trace by arrival time across
  worker processes with engine-state handoff + boundary stitching
  (``repro_torch.experiments.shard``); spawned workers, as ``process``.
* ``device``   — runs many cells' scheduling rounds batched over a cell
  axis: one engine thread per cell, every ``fused``-backend solve
  intercepted and batched across cells into ONE batched body and
  cell-batched Sinkhorn launch per (bucket, dtype, statics) group
  (``repro_torch.core.round.fused_round_batch``). Cells the batch cannot
  serve (forecast-driven policies, non-``fused`` solver backends) run on
  the serial path, so any plan runs on any backend.

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
import threading
from typing import Dict, List, Optional, Union

import repro_torch.obs as obs
from repro_torch.core import solvers
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
    """Splits each cell's trace across ``shards`` worker slices
    (``repro_torch.experiments.shard``): the single-cell scale-out backend.

    ``shards`` trace slices per cell; ``max_workers=0`` auto-sizes the
    per-cell pool (``auto_workers``: at most ``CARD_WORKERS`` on the card);
    ``handoff_s=0`` auto-sizes the warm-up handoff window from the trace's
    longest possible in-flight span. Cells run one after another — the
    parallelism lives *inside* each cell.
    """

    name = "sharded"

    def __init__(self, shards: int = 2, max_workers: int = 0,
                 handoff_s: float = 0.0):
        self.shards = int(shards)
        self.max_workers = int(max_workers)
        self.handoff_s = float(handoff_s)

    def run(self, cells: List[Cell], device=None) -> List[Dict]:
        from repro_torch.experiments import shard

        def one(cell: Cell, device=None) -> Dict:
            return shard.run_sharded_cell(
                cell, shards=self.shards,
                max_workers=self.max_workers or None,
                handoff_s=self.handoff_s, device=device)

        return [self._guarded(one, c, device) for c in cells]


class _CellBatcher:
    """Lockstep cross-cell solve batcher (the ``device`` backend's core).

    Every participating cell runs in its own thread and funnels each
    ``fused`` solve here via :func:`repro_torch.core.solvers.intercepted`;
    :meth:`submit` blocks until the whole wave's requests are flushed as
    one batch (``flush_fn``) and the caller's result is back.

    Liveness invariant: a flush fires exactly when every *active* thread
    is blocked in :meth:`submit` — the last arrival executes the flush.
    A thread that will submit nothing more MUST :meth:`finish` (the
    executor does so in a ``finally``), which both removes it from the
    barrier arithmetic and flushes any wave it was holding up. Cells make
    different numbers of solves (different round counts, hard + soft
    fallback rounds): late waves simply batch across whichever cells are
    still running, down to single-request "batches" for the last cell
    standing — identical results, less amortization.

    A flush exception fans out to every waiting ``submit`` (re-raised in
    each cell thread → that cell's error row); the batcher itself stays
    usable for the survivors.
    """

    def __init__(self, flush_fn):
        self._flush_fn = flush_fn
        self._cv = threading.Condition()
        self._active = 0
        self._pending: List[list] = []      # [request, result, exception]

    def register(self) -> None:
        with self._cv:
            self._active += 1

    def finish(self) -> None:
        with self._cv:
            self._active -= 1
            self._maybe_flush()

    def submit(self, request):
        item = [request, None, None]
        with self._cv:
            self._pending.append(item)
            self._maybe_flush()
            while item[1] is None and item[2] is None:
                self._cv.wait()
        if item[2] is not None:
            raise item[2]
        return item[1]

    def _maybe_flush(self) -> None:
        # Caller holds the lock. Every active thread pending -> flush now.
        # (The non-submitting threads are all inside submit(), waiting, so
        # holding the lock across the flush serializes nothing that could
        # otherwise run.)
        if not self._pending or len(self._pending) < self._active:
            return
        batch, self._pending = self._pending, []
        try:
            results = self._flush_fn([it[0] for it in batch])
            for it, res in zip(batch, results):
                it[1] = res
        except BaseException as e:          # noqa: BLE001 — fan out to cells
            for it in batch:
                it[2] = e
        self._cv.notify_all()


class DeviceExecutor(Executor):
    """Batched cell execution: one engine thread per cell, the cells' fused
    scheduling solves batched into ONE batched body and cell-batched
    Sinkhorn launch per round wave
    (``repro_torch.core.round.fused_round_batch``).

    ``devices=0`` auto-sizes to every visible CUDA card (one for
    ``device="cpu"``); with more than one, each group is split into
    contiguous shards, one a card. ``max_cells=0`` runs all batchable cells
    as one wave, else waves of at most ``max_cells`` threads. Cells whose
    policy cannot batch — forecast-driven pipelines (their fused path
    pre-solves inside pricing) and non-``fused`` solver backends — run on
    the serial path first; rows come back in plan order either way, equal
    to ``serial``'s.
    """

    name = "device"

    def __init__(self, devices: int = 0, max_cells: int = 0):
        self.devices = int(devices)
        self.max_cells = int(max_cells)

    @staticmethod
    def _batchable(cell: Cell) -> bool:
        """True when the cell's every hard/soft solve goes through solver
        backend ``"fused"`` — the one program the batch path serves.
        Forecast-driven policies are excluded even with ``backend=fused``:
        their fused path pre-solves inside pricing (``PricedPlan.presolved``)
        and never reaches ``solvers.solve``, so a barrier slot for them
        could deadlock the wave. Anything unclassifiable is non-batchable
        (clean fallback beats a wrong classification)."""
        from repro_torch import policy
        try:
            spec = policy.as_spec(cell.policy)
            entry = policy.get_policy(spec.name)
            if entry.forecast_driven:
                return False
            backend = spec.params.get("backend")
            if backend is None:
                p = entry.params.get("backend")
                backend = None if p is None else p.default
            return backend == "fused"
        except Exception:                   # noqa: BLE001 — conservative
            return False

    def _run_threaded(self, cell: Cell, i: int, rows: List,
                      batcher: _CellBatcher, cell_device) -> None:
        from repro_torch.core.round import SolveRequest

        def hook(cost, allowed, capacity, *, backend, soften, overrun, tol,
                 sigma, device):
            if backend != "fused" or device != cell_device:
                return None                 # decline: solve runs in-thread
            return batcher.submit(SolveRequest(
                cost=cost, allowed=allowed, capacity=capacity,
                soften=soften, overrun=overrun, tol=tol, sigma=sigma))

        try:
            with solvers.intercepted(hook):
                rows[i] = self._guarded(runner.run_cell, cell, cell_device)
        finally:
            batcher.finish()

    def run(self, cells: List[Cell], device=None) -> List[Dict]:
        from repro_torch.core import round as fused_round
        from repro_torch.runtime import platform

        avail = fused_round.visible_devices(platform.device(device))
        devices = self.devices or avail
        if devices > avail:
            obs.warn("executor.device_clamp",
                     f"device executor asked for {devices} devices but only "
                     f"{avail} are visible — clamping")
            devices = avail
        rows: List[Optional[Dict]] = [None] * len(cells)
        batched = [i for i, c in enumerate(cells) if self._batchable(c)]
        serial = [i for i in range(len(cells)) if i not in set(batched)]
        for i in serial:
            rows[i] = self._guarded(runner.run_cell, cells[i], device)
        wave = self.max_cells or max(len(batched), 1)
        for start in range(0, len(batched), wave):
            chunk = batched[start:start + wave]
            batcher = _CellBatcher(
                lambda reqs: fused_round.fused_round_batch(
                    reqs, devices=devices, device=device))
            threads = []
            for i in chunk:
                batcher.register()
                threads.append(threading.Thread(
                    target=self._run_threaded,
                    args=(cells[i], i, rows, batcher, device),
                    name=f"device-cell-{i}", daemon=True))
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return rows


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
