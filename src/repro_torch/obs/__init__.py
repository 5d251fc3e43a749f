"""``repro_torch.obs`` — zero-overhead-when-disabled observability.

Three pillars:

* a process-global :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (counters / gauges / exact-quantile latency histograms) with
  snapshot + associative merge, so sharded-executor workers ship their
  metrics back to the driver;
* structured **span tracing** with nesting, exported as
  Chrome-trace-event JSONL (Perfetto / ``chrome://tracing``-loadable)
  via :class:`~repro_torch.obs.trace.TraceWriter`;
* the trace format of the JAX package, so its reporting CLI
  (``python -m repro.obs.report``) renders the port's traces: per-stage
  p50/p99 tables, per-region carbon/water/WUE series, and run diffs.

Disabled (the default) is the fast path: ``span()`` returns a shared
no-op context manager, ``observe``/``gauge`` return immediately, and no
trace I/O happens — pinned in ``tests/test_obs.py`` by checking engine
records are bit-identical with obs on vs off.  Only plain **counters**
are always live (a dict add), because degenerate-path warning counts
and JIT-retrace accounting must be visible in ordinary runs too.

Typical use::

    import repro_torch.obs as obs

    with obs.capture(trace_path="out/run.trace.jsonl"):
        result = engine.run(...)
        snap = obs.snapshot()          # counters/gauges/histograms
    # trace file closed; report with `python -m repro.obs.report`

Instrumentation sites use::

    with obs.span("policy.solve", jobs=M):
        res = solvers.solve(problem)
        obs.annotate(status=res.status)   # add args to the open span

    with obs.timed("cell.run") as t:      # always measures .elapsed_s
        sim.run()
    row["wall_s"] = t.elapsed_s
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, Optional

from repro_torch.obs.metrics import (HIST_BASE, HIST_MAX_SAMPLES, Counter, Gauge,
                               Histogram, MetricsRegistry, merge_snapshots)
from repro_torch.obs.trace import (SIM_PID, TraceWriter, iter_spans, read_trace,
                             validate_events)

__all__ = [
    "enabled", "enable", "disable", "capture", "span", "timed", "annotate",
    "counter", "gauge", "observe", "warn", "snapshot", "merge", "reset",
    "counter_value", "tracer", "registry",
    "MetricsRegistry", "Histogram", "Counter", "Gauge", "merge_snapshots",
    "TraceWriter", "read_trace", "iter_spans", "validate_events",
    "HIST_BASE", "HIST_MAX_SAMPLES", "SIM_PID",
]

_REGISTRY = MetricsRegistry()
_TRACER: Optional[TraceWriter] = None
_ENABLED = False
_STACK: List["_Span"] = []


def enabled() -> bool:
    return _ENABLED


def registry() -> MetricsRegistry:
    return _REGISTRY


def tracer() -> Optional[TraceWriter]:
    return _TRACER


def enable(trace_path: Optional[str] = None) -> None:
    """Turn collection on; if ``trace_path`` is given, also stream
    Chrome-trace events there until :func:`disable`."""
    global _ENABLED, _TRACER
    _ENABLED = True
    if trace_path is not None:
        if _TRACER is not None:
            _TRACER.close()
        _TRACER = TraceWriter(trace_path)


def disable() -> None:
    """Stop collection and close any open trace file. The metrics
    registry is kept (read it with :func:`snapshot`; clear with
    :func:`reset`)."""
    global _ENABLED, _TRACER
    _ENABLED = False
    if _TRACER is not None:
        _TRACER.close()
        _TRACER = None
    _STACK.clear()


@contextlib.contextmanager
def capture(trace_path: Optional[str] = None, fresh: bool = True,
            fold: bool = True):
    """Enable obs for a block, restoring the previous state after.
    Yields the live registry. ``fresh=True`` starts from an empty
    registry so the snapshot covers only this block; ``fold=False``
    discards the block's metrics on exit instead of merging them into
    the outer registry (shard workers ship their snapshot explicitly,
    so the driver must not also receive it by fold)."""
    global _REGISTRY
    prev_enabled, prev_reg = _ENABLED, _REGISTRY
    if fresh:
        _REGISTRY = MetricsRegistry()
    enable(trace_path)
    try:
        yield _REGISTRY
    finally:
        disable()
        if prev_enabled:
            enable()
        if fresh:
            # fold the block's metrics into the outer registry so nested
            # captures don't silently drop observations
            captured = _REGISTRY.snapshot() if fold else None
            _REGISTRY = prev_reg
            if captured is not None:
                _REGISTRY.merge(captured)


def reset() -> None:
    global _REGISTRY
    _REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op span: the entire disabled-mode cost of ``span()``."""
    __slots__ = ()
    elapsed_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass

    def elapsed(self) -> float:
        return 0.0


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "t0", "elapsed_s", "_measure_only")

    def __init__(self, name: str, args: Dict, measure_only: bool = False):
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.elapsed_s = 0.0
        self._measure_only = measure_only

    def set(self, **args) -> None:
        self.args.update(args)

    def elapsed(self) -> float:
        """Mid-flight wall-clock reading (``elapsed_s`` is only set at
        exit); lets a multi-return function report its wall so far."""
        return time.perf_counter() - self.t0

    def __enter__(self):
        self.t0 = time.perf_counter()
        if not self._measure_only:
            _STACK.append(self)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.elapsed_s = t1 - self.t0
        if self._measure_only:
            return False
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        _REGISTRY.observe(self.name, self.elapsed_s)
        if _TRACER is not None:
            ts0 = (self.t0 - _TRACER._t0) * 1e6
            _TRACER.complete(self.name, ts0, self.elapsed_s * 1e6,
                             args=self.args or None)
        return False


def span(name: str, **args):
    """Context manager timing a named stage.  No-op singleton when obs
    is disabled; when enabled, records a latency-histogram observation
    and (if tracing) a Chrome-trace ``X`` event with ``args``."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, args)


def timed(name: str, **args):
    """Like :func:`span`, but **always** measures wall time and exposes
    ``.elapsed_s`` — the drop-in replacement for ad-hoc
    ``time.perf_counter()`` pairs whose result feeds a data field
    (``solve_time_s``, ``wall_s``): the field is populated identically
    whether obs is on or off."""
    if not _ENABLED:
        return _Span(name, args, measure_only=True)
    return _Span(name, args)


def annotate(**args) -> None:
    """Attach args to the innermost open (enabled) span, if any."""
    if _STACK:
        _STACK[-1].set(**args)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def counter(name: str, n: float = 1) -> None:
    """Increment a counter. Always live (cheap), even when disabled —
    counters carry degenerate-path and JIT-retrace accounting that must
    not vanish in ordinary runs."""
    _REGISTRY.counter(name, n)


def counter_value(name: str) -> float:
    c = _REGISTRY.counters.get(name)
    return 0.0 if c is None else c.value


def gauge(name: str, value: float, weight: float = 1.0) -> None:
    if _ENABLED:
        _REGISTRY.gauge(name, value, weight)


def observe(name: str, value: float) -> None:
    if _ENABLED:
        _REGISTRY.observe(name, value)


def warn(name: str, message: str, n: float = 1) -> None:
    """Degenerate-path signal: bump ``warn/<name>`` (always) and issue a
    ``RuntimeWarning`` (Python's default filter dedups repeats per
    call site, so hot loops don't spam)."""
    _REGISTRY.counter(f"warn/{name}", n)
    warnings.warn(f"[{name}] {message}", RuntimeWarning, stacklevel=3)


def snapshot() -> Dict:
    return _REGISTRY.snapshot()


def merge(snap: Dict) -> None:
    """Fold a worker's snapshot into this process's registry."""
    _REGISTRY.merge(snap)
