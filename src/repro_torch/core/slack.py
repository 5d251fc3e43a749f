"""Job slack management — paper §4 Eq (14).

The MILP is stateless w.r.t. how long a job has already waited; the slack
manager restores that state. When demand exceeds fleet capacity, jobs are
ranked by urgency (ascending — least slack first) and only the top Σcap(n)
enter the solver; the rest wait for the next round (Algorithm 1, lines 5-7).

    Urgency_m = TOL%·t_m − L_m^avg − waited_m                       (Eq 14)

where waited_m = T^current − T_m^start. (The paper prints the last term as
(T_m^start − T^current) but describes it as "how long the job has been
waiting" and ranks ascending-urgent; we implement the described semantics —
waiting *consumes* slack.)
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.problem import Job, latency_matrix, slack_budget

__all__ = ["urgency", "pick_most_urgent", "slack_budget"]


def urgency(jobs: Sequence[Job], now_s: float,
            bw_gbps: np.ndarray = None,
            rtt_s: np.ndarray = None) -> np.ndarray:
    """Eq (14) urgency score per job (seconds of remaining slack).

    One vectorized latency-matrix evaluation instead of a per-job Python
    loop — this runs on every congested scheduling round (Algorithm 1
    lines 5-7), where the pending set is by definition large. Pass the
    telemetry's identity-mapped WAN tables (``tele.wan_bw_gbps`` /
    ``tele.wan_rtt_s``) so region-subset runs rank with the right links.

    Workflow tasks rank by their critical-path slack (``problem.
    slack_budget``) minus the average transfer latency — the same shared
    slack definition the deferral queue and the Eq (11) mask use. Plain
    jobs keep the exact original expression (op order preserved for
    bit-stable rankings).
    """
    if not jobs:
        return np.zeros(0)
    home = np.array([j.home_region for j in jobs])
    size = np.array([j.package_bytes for j in jobs])
    l_avg = latency_matrix(home, size, bw_gbps, rtt_s).mean(axis=1)
    waited = np.maximum(
        now_s - np.array([j.submit_time_s for j in jobs]), 0.0)
    tol_budget = np.array([j.tolerance * j.exec_time_s for j in jobs])
    plain = tol_budget - l_avg - waited
    if all(j.deadline_override_s is None for j in jobs):
        return plain
    return np.where(
        np.fromiter((j.deadline_override_s is None for j in jobs),
                    bool, len(jobs)),
        plain, slack_budget(jobs, now_s) - l_avg)


def pick_most_urgent(jobs: Sequence[Job], now_s: float, k: int,
                     bw_gbps: np.ndarray = None,
                     rtt_s: np.ndarray = None):
    """Split ``jobs`` into (top-k most urgent, deferred) per Eq 14 ranking."""
    if len(jobs) <= k:
        return list(jobs), []
    u = urgency(jobs, now_s, bw_gbps, rtt_s)
    order = np.argsort(u, kind="stable")      # ascending = most urgent first
    take = set(order[:k].tolist())
    chosen = [j for i, j in enumerate(jobs) if i in take]
    deferred = [j for i, j in enumerate(jobs) if i not in take]
    return chosen, deferred
