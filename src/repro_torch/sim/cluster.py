"""Region/cluster state: capacities, reservations, in-flight transfers."""
from __future__ import annotations

import heapq
from typing import List

import numpy as np


class Cluster:
    """Server bookkeeping for N regions.

    A scheduled job holds one server from dispatch until completion (the
    transfer window is included in the hold — a deliberate, conservative
    simplification: the destination server is pinned once the move starts,
    mirroring how checkpoint-restore targets are reserved in practice).

    Capacity may change mid-run (``set_capacity``, scenario outage events).
    Running jobs are never evicted: ``busy`` can transiently exceed a
    *reduced* capacity, but ``free()`` clamps at zero so no new dispatch ever
    lands on a lost server.
    """

    def __init__(self, capacity: np.ndarray):
        self.capacity = np.asarray(capacity, dtype=np.int64).copy()
        self.busy = np.zeros_like(self.capacity)
        self._completions: List = []      # heap of (finish_s, region)
        self.busy_integral_s = 0.0        # server-seconds actually busy
        self.cap_integral_s = 0.0         # server-seconds provisioned
        self._last_t = 0.0
        self._busy_total = 0
        self._cap_total = int(self.capacity.sum())
        self._max_finish = 0.0            # time the fleet fully drains
        self.peak_busy = np.zeros_like(self.capacity)

    @property
    def num_regions(self) -> int:
        return len(self.capacity)

    def free(self) -> np.ndarray:
        return np.maximum(self.capacity - self.busy, 0)

    def busy_any(self) -> bool:
        return self._busy_total > 0

    def set_capacity(self, capacity: np.ndarray) -> None:
        self.capacity = np.asarray(capacity, dtype=np.int64).copy()
        self._cap_total = int(self.capacity.sum())

    def drain_time(self) -> float:
        """Time at which every in-flight job has finished."""
        return self._max_finish

    def advance(self, now_s: float) -> int:
        """Release servers whose jobs finished by ``now_s``.

        The busy-time integral is accumulated piecewise at each completion,
        so utilization is exact regardless of how far apart the engine's
        events are (the windowed engine over-counted by up to one window per
        completion)."""
        released = 0
        comp = self._completions
        while comp and comp[0][0] <= now_s:
            t, region = heapq.heappop(comp)
            self.busy_integral_s += self._busy_total * (t - self._last_t)
            self.cap_integral_s += self._cap_total * (t - self._last_t)
            self._last_t = t
            self.busy[region] -= 1
            self._busy_total -= 1
            released += 1
        self.busy_integral_s += self._busy_total * (now_s - self._last_t)
        self.cap_integral_s += self._cap_total * (now_s - self._last_t)
        self._last_t = now_s
        return released

    def dispatch(self, region: int, finish_s: float) -> None:
        assert self.busy[region] < self.capacity[region], "over-capacity"
        self.busy[region] += 1
        self._busy_total += 1
        if self.busy[region] > self.peak_busy[region]:
            self.peak_busy[region] = self.busy[region]
        if finish_s > self._max_finish:
            self._max_finish = finish_s
        heapq.heappush(self._completions, (finish_s, region))

    # -- state handoff (sharded execution, repro.experiments.shard) ---------

    def export_state(self) -> dict:
        """Snapshot everything a later engine run needs to continue this
        cluster mid-flight: occupancy, the completion heap, and the exact
        utilization integrals (so a chained run reports the same cumulative
        utilization as an unsharded one)."""
        return dict(capacity=self.capacity.copy(), busy=self.busy.copy(),
                    completions=list(self._completions),
                    busy_integral_s=self.busy_integral_s,
                    cap_integral_s=self.cap_integral_s,
                    last_t=self._last_t, max_finish=self._max_finish,
                    peak_busy=self.peak_busy.copy())

    def restore_state(self, state: dict) -> None:
        """Inverse of ``export_state`` (overwrites this cluster's state)."""
        self.capacity = np.asarray(state["capacity"], np.int64).copy()
        self.busy = np.asarray(state["busy"], np.int64).copy()
        self._completions = list(state["completions"])
        heapq.heapify(self._completions)
        self.busy_integral_s = float(state["busy_integral_s"])
        self.cap_integral_s = float(state["cap_integral_s"])
        self._last_t = float(state["last_t"])
        self._busy_total = int(self.busy.sum())
        self._cap_total = int(self.capacity.sum())
        self._max_finish = float(state["max_finish"])
        self.peak_busy = np.asarray(state["peak_busy"], np.int64).copy()

    def utilization(self, horizon_s: float) -> float:
        """Busy server-seconds over *provisioned* server-seconds — the
        denominator is the time-integral of capacity, so runs with capacity
        events (outages) report a meaningful, finite utilization."""
        denom = self.cap_integral_s + self._cap_total * max(
            horizon_s - self._last_t, 0.0)
        return self.busy_integral_s / max(denom, 1e-9)
