"""Deterministic synthetic DAG workload generators (``sim.trace`` style;
the port of ``repro/workflows/generators.py``).

Workflow *arrivals* reuse the inhomogeneous-Poisson machinery of
``sim.trace._arrivals`` (diurnal / burst-train modulation); each arrival
instantiates one workflow from a template mix:

* ``chain``    — linear stage pipeline (ETL-like);
* ``fanout``   — one splitter feeding K parallel shards joined by a reducer
                 (MapReduce-like);
* ``diamond``  — split into two branches that re-join (A/B preprocessing);
* ``montage``  — the classic astronomy mosaicking shape: wide projection
                 fan-out → pairwise overlap fitting → concat/background →
                 final mosaic (Montage-like, the standard DAG benchmark).

Task durations are drawn from the paper's PARSEC/CloudSuite profile mix and
task *energy* comes from the per-node power model
(``footprint.PowerModel`` — idle/peak utilization curve) instead of a fixed
per-benchmark wattage, so DAG tasks exercise the utilization-dependent
accounting path. Generators are deterministic given (seed, days, rate).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import footprint
from repro_torch.core.problem import Job
from repro_torch.sim import trace
from repro_torch.workflows.spec import WorkflowSpec

DAY = trace.DAY

# Template mix: (name, weight). Montage-like graphs are the heavyweight
# "real workflow" shape; the simple shapes keep the mix varied.
TEMPLATES: Tuple[Tuple[str, float], ...] = (
    ("chain", 0.30),
    ("fanout", 0.25),
    ("diamond", 0.25),
    ("montage", 0.20),
)


def _template_deps(name: str, rng: np.random.Generator
                   ) -> List[Tuple[int, ...]]:
    """Local-index predecessor lists for one workflow instance. Index i's
    entry lists the indices that must finish before task i may start."""
    if name == "chain":
        n = int(rng.integers(3, 7))
        return [() if i == 0 else (i - 1,) for i in range(n)]
    if name == "fanout":
        k = int(rng.integers(3, 8))
        deps: List[Tuple[int, ...]] = [()]                  # splitter
        deps += [(0,) for _ in range(k)]                    # shards
        deps.append(tuple(range(1, k + 1)))                 # reducer
        return deps
    if name == "diamond":
        return [(), (0,), (0,), (1, 2)]
    if name == "montage":
        # mProject ×k → mDiffFit (pairwise) → mConcatFit → mBackground ×k
        # → mAdd: the canonical Montage skeleton at small scale.
        k = int(rng.integers(3, 6))
        deps = [() for _ in range(k)]                       # mProject fan
        proj = tuple(range(k))
        diff = []
        for i in range(k - 1):
            deps.append((i, i + 1))                         # mDiffFit pairs
            diff.append(k + i)
        deps.append(tuple(diff))                            # mConcatFit
        concat = len(deps) - 1
        bg = []
        for i in range(k):
            deps.append((i, concat))                        # mBackground fan
            bg.append(len(deps) - 1)
        deps.append(tuple(bg))                              # mAdd
        return deps
    raise ValueError(f"unknown workflow template {name!r}")


def _pick_templates(rng: np.random.Generator, n: int) -> np.ndarray:
    w = np.array([w for _, w in TEMPLATES])
    return rng.choice(len(TEMPLATES), size=n, p=w / w.sum())


def workflow_trace(days: float = 1.0, seed: int = 0, num_regions: int = 5,
                   tolerance: float = 0.5,
                   workflows_per_day: float = 400.0,
                   burst: float = 0.0,
                   diurnal_depth: float = 0.45,
                   duration_jitter: float = 0.35,
                   server: footprint.ServerSpec = None) -> List[Job]:
    """Generate a finalized DAG trace: a flat ``List[Job]`` (submit order)
    whose tasks carry ``deps`` / ``workflow_id`` / critical-path deadlines.

    Every task of a workflow shares the workflow's submit instant (the DAG
    is known at submission; *release* is what precedence gates). job_ids are
    globally unique and sequential, so the trace drops into every existing
    scenario/engine surface unchanged.
    """
    rng = np.random.default_rng(seed)
    server = server or footprint.m5_metal()
    power = footprint.PowerModel.from_server(server)
    arrivals = trace._arrivals(rng, days, workflows_per_day / DAY,
                               diurnal_depth=diurnal_depth, burst=burst)
    picks = _pick_templates(rng, arrivals.size)
    region_w = np.array([0.25, 0.30, 0.15, 0.15, 0.15])[:num_regions]
    region_w = region_w / region_w.sum()
    profiles = trace.BENCHMARK_PROFILES

    jobs: List[Job] = []
    next_id = 0
    for wf_i, (ts, tmpl_k) in enumerate(zip(arrivals, picks)):
        name = TEMPLATES[tmpl_k][0]
        deps_local = _template_deps(name, rng)
        n = len(deps_local)
        home = int(rng.choice(num_regions, p=region_w))
        pk = rng.integers(0, len(profiles), n)
        jitter = rng.lognormal(mean=0.0, sigma=duration_jitter, size=n)
        util = rng.uniform(0.35, 0.95, n)
        base = next_id
        tasks = []
        for i in range(n):
            p = profiles[pk[i]]
            t_exec = float(p.exec_s * jitter[i])
            tasks.append(Job(
                job_id=base + i, home_region=home,
                submit_time_s=float(ts), exec_time_s=t_exec,
                energy_kwh=float(power.energy_kwh(util[i], t_exec)),
                package_bytes=p.tar_bytes, tolerance=tolerance,
                arch=f"{name}:{p.name}",
                deps=tuple(base + d for d in deps_local[i])))
        next_id += n
        spec = WorkflowSpec(workflow_id=wf_i, tasks=tuple(tasks),
                            tolerance=tolerance)
        jobs.extend(spec.finalize())
    jobs.sort(key=lambda j: (j.submit_time_s, j.job_id))
    return jobs


def mixed_trace(days: float = 1.0, seed: int = 0, num_regions: int = 5,
                tolerance: float = 0.5,
                workflows_per_day: float = 400.0,
                plain_jobs_per_day: float = 0.0,
                burst: float = 0.0) -> List[Job]:
    """DAG trace optionally blended with plain (independent) Borg-like jobs
    — exercises the mixed plain/workflow scheduling path. job_ids stay
    globally unique (plain jobs are offset past the DAG id range)."""
    jobs = workflow_trace(days=days, seed=seed, num_regions=num_regions,
                          tolerance=tolerance,
                          workflows_per_day=workflows_per_day, burst=burst)
    if plain_jobs_per_day > 0:
        plain = trace.borg_trace(days=days, seed=seed + 1,
                                 num_regions=num_regions, tolerance=0.25,
                                 target_jobs_per_day=plain_jobs_per_day)
        offset = (max(j.job_id for j in jobs) + 1) if jobs else 0
        for p in plain:
            p.job_id += offset
        jobs = sorted(jobs + plain,
                      key=lambda j: (j.submit_time_s, j.job_id))
    return jobs
