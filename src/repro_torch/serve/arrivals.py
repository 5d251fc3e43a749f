"""Arrival streams + bounded admission for the always-on scheduler service
(the port of ``repro/serve/arrivals.py``; host code, numpy as there).

Batch replay hands the engine the whole trace up front; a *service* sees
jobs only as they arrive. An ``ArrivalSource`` is the pull side of that
stream: ``poll(until_s)`` returns every job that has arrived strictly
before ``until_s`` (simulated time) and not been returned yet, in submit
order — the decision loop polls once per round boundary and injects the
chunk into the stepable engine. Three sources cover the serving regimes:

* ``ReplayArrivals``   — an in-memory trace replayed as a stream (the
                         batch-parity reference: chunked polling must be
                         bit-identical to handing the engine the list);
* ``PoissonBurstArrivals`` — endless synthetic load, lazily generated in
                         hourly chunks with the same diurnal × burst-train
                         modulation as ``sim.trace`` (storm testing);
* ``FileTailArrivals`` — tails a JSONL file, consuming complete lines
                         only (the live ingestion seam).

Between the stream and the engine sits the ``AdmissionQueue``: a *bounded*
buffer with an explicit shed policy. Under a burst storm the service must
choose — queue without bound (latency collapse), or shed with accounting.
Shedding is never silent: every shed job is counted, listed, and folded
into the service report as a deadline miss.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.problem import Job
from repro_torch.sim import trace as sim_trace

DAY = sim_trace.DAY


class ArrivalSource:
    """Pull-based arrival stream (see module docstring)."""

    def poll(self, until_s: float) -> List[Job]:
        """Jobs with ``submit_time_s < until_s`` not yet returned, in
        submit order. Monotone: later calls never return earlier jobs."""
        raise NotImplementedError

    def next_arrival_s(self) -> Optional[float]:
        """Submit time of the next pending arrival, if knowable."""
        return None

    @property
    def exhausted(self) -> bool:
        """True when no future ``poll`` can return more jobs."""
        return False


class ReplayArrivals(ArrivalSource):
    """An in-memory trace replayed as a stream (batch-parity reference)."""

    def __init__(self, jobs: Sequence[Job]):
        self._jobs = sorted(jobs, key=lambda j: j.submit_time_s)
        self._i = 0

    def poll(self, until_s: float) -> List[Job]:
        out: List[Job] = []
        while self._i < len(self._jobs) \
                and self._jobs[self._i].submit_time_s < until_s:
            out.append(self._jobs[self._i])
            self._i += 1
        return out

    def next_arrival_s(self) -> Optional[float]:
        if self._i < len(self._jobs):
            return self._jobs[self._i].submit_time_s
        return None

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._jobs)


class PoissonBurstArrivals(ArrivalSource):
    """Endless synthetic load: inhomogeneous Poisson with diurnal and
    burst-train modulation, generated lazily in fixed chunks.

    The intensity matches ``sim.trace._arrivals`` (diurnal sine of depth
    ``diurnal_depth``; 30-minute hot windows every 4 h multiplying the
    rate by ``1 + 4·burst``), but generation is *chunked*: chunk ``c``
    covers ``[c·chunk_s, (c+1)·chunk_s)`` and draws from its own
    ``default_rng((seed, c))``, so an always-on service can stream for
    days without materializing the future, deterministically — the same
    (seed, chunk) always yields the same jobs regardless of polling
    cadence. Job ids are globally unique and arrival-ordered.
    """

    def __init__(self, rate_per_s: float, *, seed: int = 0,
                 num_regions: int = 5, tolerance: float = 0.25,
                 diurnal_depth: float = 0.45, burst: float = 0.0,
                 duration_jitter: float = 0.35, chunk_s: float = 3600.0,
                 horizon_s: Optional[float] = None):
        self.rate_per_s = float(rate_per_s)
        self.seed = int(seed)
        self.num_regions = int(num_regions)
        self.tolerance = float(tolerance)
        self.diurnal_depth = float(diurnal_depth)
        self.burst = float(burst)
        self.duration_jitter = float(duration_jitter)
        self.chunk_s = float(chunk_s)
        self.horizon_s = horizon_s
        self._chunk = 0               # next chunk index to generate
        self._buffer: List[Job] = []  # generated, not yet polled
        self._next_id = 0

    def _gen_chunk(self) -> None:
        t0 = self._chunk * self.chunk_s
        t1 = t0 + self.chunk_s
        rng = np.random.default_rng((self.seed, self._chunk))
        lam_max = (self.rate_per_s * (1 + self.diurnal_depth)
                   * (1 + self.burst * 4))
        n_cand = rng.poisson(lam_max * self.chunk_s)
        t = np.sort(rng.uniform(t0, t1, n_cand))
        lam = self.rate_per_s * (
            1 + self.diurnal_depth * np.sin(t / DAY * 2 * np.pi))
        if self.burst > 0:
            phase = (t % (4 * 3600.0)) < 1800.0
            lam = lam * np.where(phase, 1 + 4 * self.burst, 1.0)
        keep = rng.uniform(0, lam_max, n_cand) < lam
        arrivals = t[keep]
        if self.horizon_s is not None:
            arrivals = arrivals[arrivals < self.horizon_s]
        jobs = sim_trace._make_jobs(rng, arrivals, self.num_regions,
                                    self.tolerance, self.duration_jitter)
        for j in jobs:                # globally unique, arrival-ordered ids
            j.job_id = self._next_id
            self._next_id += 1
        self._buffer.extend(jobs)
        self._chunk += 1

    def _covered_s(self) -> float:
        end = self._chunk * self.chunk_s
        return end if self.horizon_s is None else min(end, self.horizon_s)

    def poll(self, until_s: float) -> List[Job]:
        while self._covered_s() < until_s and not self.exhausted:
            self._gen_chunk()
        cut = 0
        while cut < len(self._buffer) \
                and self._buffer[cut].submit_time_s < until_s:
            cut += 1
        out, self._buffer = self._buffer[:cut], self._buffer[cut:]
        return out

    def next_arrival_s(self) -> Optional[float]:
        # Peek without forcing generation of the infinite future: only the
        # already-buffered head is knowable cheaply.
        if self._buffer:
            return self._buffer[0].submit_time_s
        return None

    @property
    def exhausted(self) -> bool:
        return (self.horizon_s is not None and not self._buffer
                and self._chunk * self.chunk_s >= self.horizon_s)


class FileTailArrivals(ArrivalSource):
    """Tails a JSONL file of job submissions (the live ingestion seam).

    Each line is one job: ``{"job_id": int, "home_region": int,
    "submit_s": float, "exec_s": float, "energy_kwh": float}`` plus
    optional ``tolerance`` / ``package_bytes``. Only *complete* lines
    (newline-terminated) are consumed — a writer mid-append never yields a
    half-parsed job; the partial line is picked up whole on a later poll.
    """

    def __init__(self, path: str, *, tolerance: float = 0.25,
                 package_bytes: float = 2e9):
        self.path = path
        self.tolerance = float(tolerance)
        self.package_bytes = float(package_bytes)
        self._offset = 0
        self._buffer: List[Job] = []
        self._closed = False

    def close(self) -> None:
        """Mark the stream finished: the file will receive no more lines."""
        self._closed = True

    def _ingest(self) -> None:
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except FileNotFoundError:
            return
        end = data.rfind(b"\n")
        if end < 0:
            return                    # no complete line yet
        complete, self._offset = data[:end + 1], self._offset + end + 1
        for line in complete.splitlines():
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            self._buffer.append(Job(
                job_id=int(d["job_id"]),
                home_region=int(d["home_region"]),
                submit_time_s=float(d["submit_s"]),
                exec_time_s=float(d["exec_s"]),
                energy_kwh=float(d["energy_kwh"]),
                package_bytes=float(d.get("package_bytes",
                                          self.package_bytes)),
                tolerance=float(d.get("tolerance", self.tolerance))))
        self._buffer.sort(key=lambda j: j.submit_time_s)

    def poll(self, until_s: float) -> List[Job]:
        self._ingest()
        cut = 0
        while cut < len(self._buffer) \
                and self._buffer[cut].submit_time_s < until_s:
            cut += 1
        out, self._buffer = self._buffer[:cut], self._buffer[cut:]
        return out

    def next_arrival_s(self) -> Optional[float]:
        if self._buffer:
            return self._buffer[0].submit_time_s
        return None

    @property
    def exhausted(self) -> bool:
        return self._closed and not self._buffer


# ---------------------------------------------------------------------------
# Bounded admission
# ---------------------------------------------------------------------------

REJECT_NEW, DROP_OLDEST = "reject-new", "drop-oldest"


class AdmissionQueue:
    """Bounded FIFO between the arrival stream and the decision loop.

    Invariants (hypothesis-property-tested in tests/test_torch_serve.py,
    against the reference's queue):

      * ``len(queue) <= bound`` after every ``offer`` — under any storm;
      * conservation: every offered job is exactly once either admitted
        (eventually returned by ``take``), still queued, or in ``shed_ids``
        — nothing is silently dropped;
      * FIFO: ``take`` returns jobs in offer order.

    ``policy`` picks who pays when the bound binds: ``reject-new`` sheds
    the incoming overflow (protects queued work — default), ``drop-oldest``
    evicts the head to admit fresh arrivals (bounds staleness).
    """

    def __init__(self, bound: int, policy: str = REJECT_NEW):
        if policy not in (REJECT_NEW, DROP_OLDEST):
            raise ValueError(f"unknown shed policy {policy!r}")
        self.bound = int(bound)
        self.policy = policy
        self._q: List[Job] = []
        self.offered = 0
        self.admitted = 0
        self.shed = 0
        self.peak_depth = 0
        self.shed_ids: List[int] = []

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, jobs: Sequence[Job], now_s: float) -> List[Job]:
        """Admit up to the bound; returns the shed jobs (accounted, never
        silent)."""
        jobs = list(jobs)
        self.offered += len(jobs)
        shed: List[Job] = []
        if self.policy == REJECT_NEW:
            room = self.bound - len(self._q)
            take, shed = jobs[:max(room, 0)], jobs[max(room, 0):]
            self._q.extend(take)
        else:                                    # drop-oldest
            self._q.extend(jobs)
            over = len(self._q) - self.bound
            if over > 0:
                shed, self._q = self._q[:over], self._q[over:]
        self.admitted += len(jobs) - len(shed)
        self.shed += len(shed)
        self.shed_ids.extend(j.job_id for j in shed)
        self.peak_depth = max(self.peak_depth, len(self._q))
        if obs.enabled():
            if shed:
                obs.counter("serve.shed", len(shed))
            obs.gauge("serve.admission_depth", float(len(self._q)))
        return shed

    def take(self, limit: Optional[int] = None) -> List[Job]:
        """Pop up to ``limit`` jobs (all, when ``None``) in FIFO order."""
        n = len(self._q) if limit is None else min(int(limit), len(self._q))
        out, self._q = self._q[:n], self._q[n:]
        return out
