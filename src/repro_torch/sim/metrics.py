"""Figures of merit (paper §5): carbon/water totals & savings, service time,
delay-tolerance violations, decision overhead."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _empty_summary(result: Dict) -> Dict[str, float]:
    return dict(carbon_kg=0.0, water_kl=0.0, embodied_kg=0.0,
                mean_service_ratio=1.0,
                violation_pct=0.0, jobs=0, mean_solve_ms=0.0,
                p99_service_ratio=1.0, moved_pct=0.0,
                utilization=result.get("utilization", 0.0))


def _frame_of(result: Dict) -> Optional[Dict[str, np.ndarray]]:
    """The columnar per-job frame, if the engine attached one (the
    event-driven engine always does; the windowed oracle and hand-built
    results fall back to the record-object loop)."""
    return result.get("frame")


def summarize(result: Dict) -> Dict[str, float]:
    frame = _frame_of(result)
    if frame is not None:
        n = int(frame["region"].size)
        if n == 0:
            return _empty_summary(result)
        service = frame["finish_s"] - frame["submit_s"]
        ratios = service / np.maximum(frame["exec_s"], 1e-9)
        violated = service > ((1.0 + frame["tolerance"]) * frame["exec_s"]
                              + 1e-6)
        deadline = frame.get("deadline_s")
        if deadline is not None and deadline.size:
            # Workflow tasks carry an absolute critical-path deadline
            # (NaN = plain job, which keeps the tolerance-based test).
            violated = np.where(np.isnan(deadline), violated,
                                frame["finish_s"] > deadline + 1e-6)
        moved = frame["region"] != frame["home_region"]
        st = result["solve_times"]
        embodied = frame.get("embodied_g")
        return dict(carbon_kg=float(np.sum(frame["carbon_g"]) / 1e3),
                    water_kl=float(np.sum(frame["water_l"]) / 1e3),
                    embodied_kg=(float(np.sum(embodied) / 1e3)
                                 if embodied is not None else 0.0),
                    mean_service_ratio=float(ratios.mean()),
                    p99_service_ratio=float(np.percentile(ratios, 99)),
                    violation_pct=float(np.mean(violated) * 100.0),
                    jobs=n,
                    mean_solve_ms=float(st.mean() * 1e3) if st.size else 0.0,
                    moved_pct=float(np.mean(moved) * 100.0),
                    utilization=float(result.get("utilization", 0.0)))
    recs = result["records"]
    if not recs:
        return _empty_summary(result)
    carbon = sum(r.carbon_g for r in recs) / 1e3
    water = sum(r.water_l for r in recs) / 1e3
    embodied = sum(r.embodied_g for r in recs) / 1e3
    ratios = np.array([r.service_ratio for r in recs])
    viol = np.mean([r.violated for r in recs]) * 100.0
    moved = np.mean([r.region != r.job.home_region for r in recs]) * 100.0
    st = result["solve_times"]
    return dict(carbon_kg=float(carbon), water_kl=float(water),
                embodied_kg=float(embodied),
                mean_service_ratio=float(ratios.mean()),
                p99_service_ratio=float(np.percentile(ratios, 99)),
                violation_pct=float(viol), jobs=len(recs),
                mean_solve_ms=float(st.mean() * 1e3) if st.size else 0.0,
                moved_pct=float(moved),
                utilization=float(result.get("utilization", 0.0)))


def stress_water_kl(result: Dict, weight: np.ndarray) -> float:
    """Scarcity-weighted water total (Wu et al. accounting view) in kl."""
    frame = _frame_of(result)
    if frame is not None:
        if frame["region"].size == 0:
            return 0.0
        w = np.asarray(weight, np.float64)
        return float(np.sum(frame["water_l"]
                            * w[frame["region"].astype(np.int64)]) / 1e3)
    return float(sum(r.water_l * weight[r.region]
                     for r in result["records"]) / 1e3)


def savings_vs(baseline: Dict[str, float], other: Dict[str, float]) -> Dict:
    """% carbon/water savings of ``other`` relative to ``baseline``
    (positive = better, the paper's primary metric)."""
    def pct(key):
        b = baseline[key]
        return 100.0 * (b - other[key]) / b if b else 0.0
    return dict(carbon_savings_pct=pct("carbon_kg"),
                water_savings_pct=pct("water_kl"))


def region_distribution(result: Dict, num_regions: int) -> np.ndarray:
    """Fig 3(b): % of jobs executed per region."""
    frame = _frame_of(result)
    if frame is not None:
        counts = np.bincount(frame["region"].astype(np.int64),
                             minlength=num_regions)
        return 100.0 * counts / max(int(frame["region"].size), 1)
    recs = result["records"]
    counts = np.bincount([r.region for r in recs], minlength=num_regions)
    return 100.0 * counts / max(len(recs), 1)
