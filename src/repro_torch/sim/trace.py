"""Workload traces: Borg-like and Alibaba-like synthetic generators.

The evaluated Google Borg slice (paper §5) is ~230,000 jobs over 10 days at
~15% fleet utilization on 175 servers; Alibaba runs at 8.5× the invocation
rate with a burstier pattern. Neither trace is redistributable inside this
offline image, so we generate statistically matched processes:

* arrivals: inhomogeneous Poisson with diurnal modulation (Borg) or
  diurnal × burst-train modulation (Alibaba);
* durations & energy: drawn from per-benchmark profiles of the paper's
  PARSEC/CloudSuite mix (Table 1) — heavy-tailed across the mix;
* home regions: categorical, weighted toward the larger regions;
* real traces can be substituted via ``load_csv`` (job_id, submit_s,
  duration_s, energy_kwh, home_region columns).

The generators are deterministic given (seed, days, rate multiplier).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.problem import Job

DAY = 86400.0


@dataclasses.dataclass(frozen=True)
class BenchProfile:
    """Measured-style profile of one benchmark (paper Table 1 mix).

    Calibrated to plausible m5.metal numbers: exec time in seconds, mean IT
    power draw in watts while running, package (.tar) size to transfer.
    """
    name: str
    suite: str
    exec_s: float
    power_w: float
    tar_bytes: float

    @property
    def energy_kwh(self) -> float:
        return self.power_w * self.exec_s / 3.6e6


BENCHMARK_PROFILES: List[BenchProfile] = [
    # PARSEC-3.0 (paper Table 1)
    BenchProfile("dedup", "parsec", 210.0, 340.0, 1.8e9),
    BenchProfile("netdedup", "parsec", 260.0, 350.0, 1.9e9),
    BenchProfile("canneal", "parsec", 680.0, 290.0, 0.9e9),
    BenchProfile("blackscholes", "parsec", 380.0, 310.0, 0.6e9),
    BenchProfile("swaptions", "parsec", 420.0, 330.0, 0.5e9),
    # CloudSuite
    BenchProfile("data-caching", "cloudsuite", 900.0, 260.0, 2.5e9),
    BenchProfile("graph-analytics", "cloudsuite", 1500.0, 380.0, 3.2e9),
    BenchProfile("web-serving", "cloudsuite", 1100.0, 240.0, 2.8e9),
    BenchProfile("memory-analytics", "cloudsuite", 1300.0, 360.0, 3.0e9),
    BenchProfile("media-streaming", "cloudsuite", 800.0, 270.0, 4.5e9),
]


def _arrivals(rng: np.random.Generator, days: float, rate_per_s: float,
              diurnal_depth: float = 0.45, burst: float = 0.0) -> np.ndarray:
    """Inhomogeneous Poisson arrivals via thinning."""
    horizon = days * DAY
    lam_max = rate_per_s * (1 + diurnal_depth) * (1 + burst * 4)
    n_cand = rng.poisson(lam_max * horizon)
    t = np.sort(rng.uniform(0, horizon, n_cand))
    lam = rate_per_s * (1 + diurnal_depth * np.sin(t / DAY * 2 * np.pi))
    if burst > 0:
        # Burst trains: 30-minute hot windows every ~4h (Alibaba-like).
        phase = (t % (4 * 3600.0)) < 1800.0
        lam = lam * np.where(phase, 1 + 4 * burst, 1.0)
    keep = rng.uniform(0, lam_max, n_cand) < lam
    return t[keep]


def _make_jobs(rng: np.random.Generator, arrivals: np.ndarray,
               num_regions: int, tolerance: float,
               duration_jitter: float = 0.35) -> List[Job]:
    profiles = BENCHMARK_PROFILES
    picks = rng.integers(0, len(profiles), arrivals.size)
    # Region weights: larger regions receive more submissions.
    w = np.array([0.25, 0.30, 0.15, 0.15, 0.15])[:num_regions]
    w = w / w.sum()
    homes = rng.choice(num_regions, size=arrivals.size, p=w)
    jitter = rng.lognormal(mean=0.0, sigma=duration_jitter, size=arrivals.size)
    jobs = []
    for i, (ts, k, h, jt) in enumerate(zip(arrivals, picks, homes, jitter)):
        p = profiles[k]
        t_exec = float(p.exec_s * jt)
        jobs.append(Job(job_id=i, home_region=int(h), submit_time_s=float(ts),
                        exec_time_s=t_exec,
                        energy_kwh=float(p.energy_kwh * jt),
                        package_bytes=p.tar_bytes, tolerance=tolerance,
                        arch=p.name))
    return jobs


def borg_trace(days: float = 10.0, seed: int = 0, num_regions: int = 5,
               tolerance: float = 0.25, rate_multiplier: float = 1.0,
               target_jobs_per_day: float = 23000.0) -> List[Job]:
    """Borg-like trace: ~23k jobs/day (≈230k over 10 days, paper §5)."""
    rng = np.random.default_rng(seed)
    rate = target_jobs_per_day / DAY * rate_multiplier
    t = _arrivals(rng, days, rate, diurnal_depth=0.45, burst=0.0)
    return _make_jobs(rng, t, num_regions, tolerance)


def alibaba_trace(days: float = 10.0, seed: int = 1, num_regions: int = 5,
                  tolerance: float = 0.25,
                  rate_multiplier: float = 1.0) -> List[Job]:
    """Alibaba-like trace: 8.5× Borg invocation rate, bursty (paper §6)."""
    rng = np.random.default_rng(seed)
    rate = 8.5 * 23000.0 / DAY * rate_multiplier
    t = _arrivals(rng, days, rate, diurnal_depth=0.30, burst=0.5)
    # Alibaba VM jobs skew shorter.
    jobs = _make_jobs(rng, t, num_regions, tolerance, duration_jitter=0.5)
    for j in jobs:
        j.exec_time_s *= 0.6
        j.energy_kwh *= 0.6
    return jobs


# Canonical trace columns -> (required, default). Published Borg/Alibaba
# slices name these differently; ``column_map`` translates.
_CSV_CANONICAL = ("job_id", "submit_s", "duration_s", "energy_kwh",
                  "home_region")


def load_csv(path: str, tolerance: float = 0.25,
             column_map: Optional[dict] = None,
             unit_scale: Optional[dict] = None,
             package_bytes: float = 2e9) -> List[Job]:
    """Load a real trace CSV into ``Job`` objects.

    Canonical columns: ``job_id, submit_s, duration_s, energy_kwh,
    home_region``. Published slices rarely match — ``column_map`` maps
    canonical name -> CSV header (e.g. Google Borg:
    ``{"submit_s": "time", "duration_s": "runtime"}``), and ``unit_scale``
    multiplies a canonical column after mapping (e.g.
    ``{"submit_s": 1e-6}`` for microsecond timestamps). ``energy_kwh`` may
    be mapped from a mean-power column via ``unit_scale`` since energy =
    power × duration is not expressible here; absent energy columns can be
    synthesized upstream instead.

    Home regions outside [0, 4] are folded modulo the region count by the
    scenario builder, not here — the loader stays a faithful reader.
    """
    cmap = {c: c for c in _CSV_CANONICAL}
    cmap.update(column_map or {})
    scale = unit_scale or {}
    raw = np.genfromtxt(path, delimiter=",", names=True)
    if raw.shape == ():                       # single-row CSV edge case
        raw = raw.reshape(1)
    missing = [c for c in _CSV_CANONICAL if cmap[c] not in
               (raw.dtype.names or ())]
    if missing:
        raise ValueError(f"trace {path!r} lacks columns for {missing}; "
                         f"available: {raw.dtype.names}")

    def col(c):
        return np.asarray(raw[cmap[c]], np.float64) * float(scale.get(c, 1.0))

    jobs = [Job(job_id=int(i), home_region=int(h), submit_time_s=float(t),
                exec_time_s=float(d), energy_kwh=float(e),
                package_bytes=package_bytes, tolerance=tolerance)
            for i, t, d, e, h in zip(col("job_id"), col("submit_s"),
                                     col("duration_s"), col("energy_kwh"),
                                     col("home_region"))]
    jobs.sort(key=lambda j: j.submit_time_s)
    return jobs


def rescale_arrival_rate(jobs: Sequence[Job], days: float,
                         target_jobs_per_day: float,
                         seed: int = 0) -> List[Job]:
    """Deterministically thin (or keep) a trace to ≈ ``target_jobs_per_day``.

    Real slices rarely match the fleet size under study. Thinning keeps the
    empirical arrival process (burst structure, diurnal shape) intact —
    unlike time-warping, which would move arrivals across telemetry hours.
    Traces *below* the target are returned unchanged (jobs are never
    duplicated; synthetic upsampling belongs to the generators).
    """
    native = len(jobs) / max(days, 1e-9)
    keep_p = target_jobs_per_day / max(native, 1e-9)
    if keep_p >= 1.0:
        return list(jobs)
    rng = np.random.default_rng(seed)
    keep = rng.random(len(jobs)) < keep_p
    return [j for j, k in zip(jobs, keep) if k]


# ---------------------------------------------------------------------------
# Arrival-time sharding (repro.experiments sharded executor)
# ---------------------------------------------------------------------------

def pick_shard_boundaries(jobs: Sequence[Job], shards: int,
                          window_frac: float = 0.1) -> List[float]:
    """Choose ``shards - 1`` boundary times that split ``jobs`` into
    near-equal-count, arrival-contiguous slices.

    Each boundary starts at the exact count quantile, then snaps to the
    *largest arrival gap* within ±``window_frac`` of a slice's worth of
    jobs around it, and lands at the midpoint of that gap. Wide gaps
    maximize the chance that the fleet has fully drained at the boundary —
    the condition under which an optimistically (independently) executed
    slice is bit-identical to its stretch of the unsharded run, so the
    sharded executor keeps its parallel results instead of falling back.

    Deterministic in its arguments; boundaries are strictly increasing and
    never touch an arrival instant (so slicing is unambiguous). Degenerate
    requests (more shards than distinct arrivals) yield fewer boundaries.
    """
    if shards <= 1 or len(jobs) < 2:
        return []
    t = np.sort(np.asarray([j.submit_time_s for j in jobs], np.float64))
    n = t.size
    gaps = np.diff(t)                       # gap g lies between t[g], t[g+1]
    half = max(int(n / shards * window_frac), 1)
    out: List[float] = []
    for k in range(1, shards):
        q = int(round(k * n / shards))      # first index of the next slice
        if q < 1 or q > n - 1:
            continue                        # no arrivals left to split off
        lo = max(q - half, 1)
        hi = min(q + half, n - 1)
        if lo > hi:
            lo = hi = q
        g = lo - 1 + int(np.argmax(gaps[lo - 1:hi]))
        b = 0.5 * (t[g] + t[g + 1])
        if out and b <= out[-1]:
            continue                        # collapsed with previous boundary
        if t[g + 1] <= b or b <= t[g]:
            continue                        # zero-width gap: unusable
        out.append(float(b))
    return out


def slice_by_arrival(jobs: Sequence[Job],
                     boundaries: Sequence[float]) -> List[List[Job]]:
    """Partition ``jobs`` into ``len(boundaries) + 1`` arrival-time slices:
    slice ``k`` holds exactly the jobs with ``B_k <= submit < B_{k+1}``
    (``B_0 = -inf``, ``B_last = +inf``).

    An exact partition — every job lands in exactly one slice (no loss, no
    duplication) and the input's relative order is preserved within each
    slice (hypothesis-property-tested in tests/test_experiments.py).
    """
    bounds = sorted(float(b) for b in boundaries)
    out: List[List[Job]] = [[] for _ in range(len(bounds) + 1)]
    if not bounds:
        out[0] = list(jobs)
        return out
    edges = np.asarray(bounds, np.float64)
    for j in jobs:
        k = int(np.searchsorted(edges, j.submit_time_s, side="right"))
        out[k].append(j)
    return out


def scale_capacity_for_utilization(jobs: Sequence[Job], days: float,
                                   num_regions: int,
                                   utilization: float = 0.15) -> np.ndarray:
    """Servers per region so mean fleet utilization hits ``utilization``
    (paper §5: 175 servers ≈ 15% at Borg rates; §6 sweeps 5%/15%/25%)."""
    busy_s = sum(j.exec_time_s for j in jobs)
    servers = busy_s / (days * DAY) / utilization
    per_region = max(int(np.ceil(servers / num_regions)), 1)
    return np.full(num_regions, per_region, dtype=np.int64)
