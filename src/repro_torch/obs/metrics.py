"""Metrics registry: counters, gauges, and log-bucketed latency histograms.

Three metric kinds, chosen to match how the scheduler's numbers are
consumed downstream:

* ``Counter`` — monotonically increasing event counts (rounds run, JIT
  retraces, degenerate-path warnings).  Merge = add.
* ``Gauge`` — a last-written value with a *weight*, so that merging
  shard-local gauges job-weights them exactly like
  ``experiments.shard.merge_forecast_stats`` job-weights forecaster
  losses.  Merge = weighted mean over (value, weight) pairs.
* ``Histogram`` — latency distribution with **exact** p50/p95/p99 while
  the raw-sample buffer holds every observation (default 65 536), plus
  log-spaced bucket counts that survive any sample-cap overflow so the
  quantiles degrade gracefully (relative error bounded by the bucket
  base, ~9%/octave-eighth) instead of silently going wrong.  Merge =
  bucket-count addition plus multiset union of the sample buffers.

Snapshots are plain JSON-serialisable dicts; ``merge_snapshots`` is
associative (pinned in tests), so sharded-executor workers can ship
their registries to the driver in any completion order.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# 2**(1/8): eight buckets per octave -> worst-case relative quantile
# error of ~4.4% once the exact sample buffer overflows.
HIST_BASE = 2.0 ** 0.125
HIST_MAX_SAMPLES = 65536
_LOG_BASE = math.log(HIST_BASE)
_TINY = 1e-12


class Counter:
    __slots__ = ("value",)

    def __init__(self, value: float = 0) -> None:
        self.value = value

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value", "weight")

    def __init__(self, value: float = 0.0, weight: float = 0.0) -> None:
        self.value = value
        self.weight = weight

    def set(self, value: float, weight: float = 1.0) -> None:
        """Fold ``value`` in as a weighted observation (not a plain
        overwrite): the gauge keeps the running weighted mean so that a
        merged snapshot equals the mean over every shard's observations."""
        total = self.weight + weight
        if total > 0:
            self.value = (self.value * self.weight + value * weight) / total
        self.weight = total


def bucket_index(v: float) -> int:
    """Log-bucket index of a positive value (values <= 0 clamp to tiny)."""
    return int(math.ceil(math.log(max(v, _TINY)) / _LOG_BASE))


def bucket_bounds(idx: int) -> tuple:
    """(lo, hi] value range covered by bucket ``idx``."""
    return (HIST_BASE ** (idx - 1), HIST_BASE ** idx)


class Histogram:
    __slots__ = ("counts", "samples", "count", "total", "vmin", "vmax",
                 "max_samples")

    def __init__(self, max_samples: int = HIST_MAX_SAMPLES) -> None:
        self.counts: Dict[int, int] = {}
        self.samples: Optional[List[float]] = []
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.max_samples = max_samples

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bucket_index(v)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if self.samples is not None:
            if len(self.samples) < self.max_samples:
                self.samples.append(v)
            else:
                self.samples = None  # cap hit: fall back to bucket quantiles

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """``q`` in [0, 100].  Exact (``numpy.percentile``-identical,
        linear interpolation) while the sample buffer is intact; bucket
        geometric-midpoint estimate after overflow."""
        if self.count == 0:
            return 0.0
        if self.samples is not None:
            return float(np.percentile(self.samples, q))
        rank = (q / 100.0) * (self.count - 1)
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen > rank:
                lo, hi = bucket_bounds(idx)
                return math.sqrt(max(lo, _TINY) * hi)
        return self.vmax

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        return {f"p{g:g}": self.quantile(g) for g in qs}


class MetricsRegistry:
    """Named counters/gauges/histograms with snapshot + merge."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.hists: Dict[str, Histogram] = {}

    # -- write paths -----------------------------------------------------
    def counter(self, name: str, n: float = 1) -> None:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        c.inc(n)

    def gauge(self, name: str, value: float, weight: float = 1.0) -> None:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        g.set(value, weight)

    def observe(self, name: str, value: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe(value)

    # -- snapshot / merge ------------------------------------------------
    def snapshot(self) -> Dict:
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: {"value": g.value, "weight": g.weight}
                       for k, g in self.gauges.items()},
            "hists": {k: {
                "counts": {str(i): n for i, n in h.counts.items()},
                "samples": None if h.samples is None else list(h.samples),
                "count": h.count,
                "total": h.total,
                "min": None if h.count == 0 else h.vmin,
                "max": None if h.count == 0 else h.vmax,
                "max_samples": h.max_samples,
            } for k, h in self.hists.items()},
        }

    def merge(self, snap: Dict) -> None:
        """Fold a snapshot (e.g. shipped back by a shard worker) in."""
        for k, v in snap.get("counters", {}).items():
            self.counter(k, v)
        for k, g in snap.get("gauges", {}).items():
            self.gauge(k, g["value"], g["weight"])
        for k, hs in snap.get("hists", {}).items():
            h = self.hists.get(k)
            if h is None:
                h = self.hists[k] = Histogram(hs.get("max_samples",
                                                     HIST_MAX_SAMPLES))
            for i, n in hs["counts"].items():
                i = int(i)
                h.counts[i] = h.counts.get(i, 0) + n
            h.count += hs["count"]
            h.total += hs["total"]
            if hs["min"] is not None:
                h.vmin = min(h.vmin, hs["min"])
                h.vmax = max(h.vmax, hs["max"])
            other = hs["samples"]
            if h.samples is None or other is None or \
                    len(h.samples) + len(other) > h.max_samples:
                h.samples = None
            else:
                h.samples.extend(other)


def merge_snapshots(snaps: Iterable[Dict]) -> Dict:
    """Merge snapshots into one (associative; order only permutes the
    retained sample multiset, which quantile() sorts anyway)."""
    reg = MetricsRegistry()
    for s in snaps:
        reg.merge(s)
    return reg.snapshot()
