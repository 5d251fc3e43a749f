"""Sharded cell execution: split one large cell's trace by arrival time,
run the slices on worker processes, stitch the boundaries, aggregate exact
totals (the port of ``repro/experiments/shard.py``).

The torch ``device`` the policy runs on travels beside the cell (None: the
CUDA card) and reaches a worker as a string. Workers are *spawned*, never
forked — a child forked after its parent touched CUDA cannot use the card
— and the auto-sized pool stops at ``executor.CARD_WORKERS`` on the card.

A fleet-scale cell (1M+ jobs over days) is one long sequential simulation —
the ROADMAP's first open item is splitting it across workers *without
changing its result*. The mechanism here keeps sharded output **bit-
identical** to the unsharded run (same placements, same per-job footprints,
same violation totals), by construction rather than by tolerance:

**Chained handoff (always exact).** ``EventSimulator.run`` can stop at a
boundary and export an ``EngineState`` (clock + grid phase, pending queue,
in-flight completions, capacity cursor); resuming the next slice from that
state with the *same scheduler object* reproduces the single run exactly.
This sequential chain is the fallback spine — and the only path for
*stateful* policies (history learners, deferral queues), whose internal
state cannot cross process boundaries.

**Speculative warm-up (parallel, validated).** For registry policies marked
``stateless``, each shard ``k`` starts a *handoff window* before its
boundary ``B_k``: it seeds an empty engine at a grid-aligned instant
``B_k - handoff_s`` (the engine's round grid is a deterministic float
accumulation from the first arrival, so the driver can replay it bit-for-
bit), simulates the warm-up arrivals with ``hold_grid=True`` (ticking the
grid through idle exactly as the busy unsharded engine would), and exports
its *speculated* entry state at ``B_k``. All shards run in parallel; the
driver then walks the boundaries left to right comparing each shard's
speculated entry state against the **true** exported state of the accepted
run before it — clock bitwise, pending queue, completion heap, capacity —
and accepts the shard's slice records only on exact match. A mismatched
shard is re-run sequentially from the true state (correctness never
depends on the speculation; only speed does). Warm-up records are
discarded — every job's record comes from exactly one accepted slice run.

Totals then aggregate exactly: records concatenate in the unsharded
placement order, so summed carbon/water/violation match the serial run
bit-for-bit (per-record accounting is elementwise — ``Telemetry.mean_over``
is a closed-form antiderivative lookup). Utilization is recomposed from
per-slice busy integrals over an analytic capacity integral (equal in
value, not guaranteed to the last bit — float association differs).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import multiprocessing
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import repro_torch.obs as obs
from repro_torch import policy
from repro_torch.experiments.executor import auto_workers
from repro_torch.experiments.plan import Cell
from repro_torch.experiments.runner import (execute, finalize_row,
                                            forecast_stats,
                                            resolve_policy_spec)
from repro_torch.experiments.scenario import build_instance
from repro_torch.sim.engine import (EngineState, EventSimulator, SimConfig,
                                    resolve_capacity)
from repro_torch.sim.trace import pick_shard_boundaries, slice_by_arrival


def auto_handoff_s(jobs: Sequence) -> float:
    """Default handoff-window span: 1.5× the longest possible in-flight
    stretch of any single job — ``(1 + TOL) × exec`` covers intentional
    oracle delays (``planned_start_s``) on top of the execution itself,
    and the extra half gives queue effects room to converge. Too short a
    window only costs speed (validation rejects the shard), never
    correctness."""
    return 1.5 * max(((1.0 + j.tolerance) * j.exec_time_s * j.time_scale
                      for j in jobs), default=0.0)


def _grid_at(t0: float, window_s: float, target: float) -> float:
    """Replay the engine's float-accumulated round grid (anchored at the
    first arrival ``t0``) to the first instant ``>= target`` — bitwise the
    same value the unsharded engine's ``now += w`` chain produces there."""
    now = t0
    while now < target:
        now += window_s
    return now


def _empty_seed(now: float, base_capacity: np.ndarray,
                events: Sequence[Tuple[float, object]]) -> EngineState:
    """Speculated engine state at a warm-up start: empty fleet, no pending,
    clock at a grid instant, capacity events up to ``now`` pre-applied."""
    base = np.asarray(base_capacity, np.int64)
    cap = base.copy()
    applied = 0
    for t, payload in events:
        if t > now:
            break
        cap = resolve_capacity(payload, base)
        applied += 1
    zeros = np.zeros_like(cap)
    return EngineState(now=now, pending=[], applied_events=applied,
                       cluster=dict(capacity=cap, busy=zeros.copy(),
                                    completions=[], busy_integral_s=0.0,
                                    cap_integral_s=0.0, last_t=now,
                                    max_finish=0.0, peak_busy=zeros.copy()))


def states_match(a: Optional[EngineState], b: Optional[EngineState]) -> bool:
    """Exact (bitwise) equivalence of the decision-relevant engine state:
    clock/grid phase, pending queue identity+order, in-flight completion
    heap, capacity and its event cursor. Utilization integrals and peak
    counters are bookkeeping, not decision inputs, and are merged
    separately — they don't participate."""
    if a is None or b is None:
        return False
    if a.now != b.now or a.applied_events != b.applied_events:
        return False
    if [j.job_id for j in a.pending] != [j.job_id for j in b.pending]:
        return False
    ca, cb = a.cluster, b.cluster
    return (np.array_equal(ca["busy"], cb["busy"])
            and np.array_equal(ca["capacity"], cb["capacity"])
            and sorted(ca["completions"]) == sorted(cb["completions"]))


def _cap_integral(base: np.ndarray, events: Sequence[Tuple[float, object]],
                  horizon_s: float) -> float:
    """Analytic ∫ total-capacity dt over [0, horizon] (server-seconds),
    the denominator of the merged utilization."""
    base = np.asarray(base, np.int64)
    total, last_t, cap = 0.0, 0.0, float(base.sum())
    for t, payload in sorted(events, key=lambda e: e[0]):
        if t >= horizon_s:
            break
        if t > last_t:
            total += cap * (t - last_t)
            last_t = t
        cap = float(resolve_capacity(payload, base).sum())
    total += cap * max(horizon_s - last_t, 0.0)
    return total


# ---------------------------------------------------------------------------
# Shard worker (module-level: picklable for the process pool)
# ---------------------------------------------------------------------------

def _slice_stats(res: Dict, entry: Optional[EngineState],
                 keep_records: bool = False) -> Dict:
    """Per-slice pieces of the merged result, with the warm-up stage's
    contribution (rounds, solve times, busy integral) subtracted out.

    Workers ship the columnar ``frame`` (fast numpy pickle) instead of the
    record-object list unless ``keep_records`` (in-driver re-runs, where
    nothing crosses a process boundary)."""
    rounds0 = entry.rounds if entry is not None else 0
    busy0 = entry.cluster["busy_integral_s"] if entry is not None else 0.0
    st = res["solve_times"]
    return dict(records=res["records"] if keep_records else [],
                frame=res["frame"],
                solve_times=st[min(rounds0, len(st)):],
                rounds=res["rounds"] - rounds0,
                busy_integral_s=res["busy_integral_s"] - busy0,
                unfinished=res["unfinished"], horizon_s=res["horizon_s"],
                peak_busy=res["peak_busy"])


def _run_shard(cell: Cell, spec_str: str, boundaries: Sequence[float],
               handoff_s: float, k: int, collect_obs: bool = False,
               device=None) -> Dict:
    """Run shard ``k`` of a cell speculatively: (warm-up →) slice.

    Rebuilds the scenario instance deterministically from the cell's specs
    (workers are driven by ``(spec, boundaries)`` alone — no trace bytes
    cross the process boundary inbound) and returns the slice frame plus
    the speculated entry state and exported exit state for validation.
    ``spec_str`` is the driver's fully *resolved* policy spec (scenario
    forecast-error injection applied), so every worker builds exactly the
    scheduler the row's ``spec`` column claims.

    ``collect_obs`` ships the slice run's metrics snapshot in the ``obs``
    key (``repro_torch.obs`` registries are per-process — the driver merges the
    snapshots of *accepted* shards, so merged metrics cover exactly the
    work the merged row reports). Warm-up metrics are isolated and
    discarded: speculation is an implementation detail, not row work.
    """
    inst, cellkw = build_instance(cell.resolved_scenario())
    w = float(cellkw["window_s"])
    jobs = sorted(inst.jobs, key=lambda j: j.submit_time_s)
    slices = slice_by_arrival(jobs, boundaries)
    sl = slices[k]
    sched = policy.build(spec_str, inst.tele, device=device)
    sim = EventSimulator(inst.tele, inst.capacity, SimConfig(window_s=w),
                         capacity_events=inst.capacity_events)
    stop = boundaries[k] if k < len(boundaries) else None
    entry: Optional[EngineState] = None
    if k > 0:
        b = boundaries[k - 1]
        t0 = jobs[0].submit_time_s if jobs else 0.0
        s_k = _grid_at(t0, w, max(b - handoff_s, t0))
        warm = [j for j in jobs if s_k <= j.submit_time_s < b]
        seed = _empty_seed(s_k, inst.capacity, inst.capacity_events)
        iso = (obs.capture(fold=False) if collect_obs
               else contextlib.nullcontext())
        with iso:
            entry = sim.run(warm, sched, state=seed, stop_at=b,
                            export_state=True, hold_grid=True)["state"]
    shard_obs: Optional[Dict] = None
    if collect_obs:
        with obs.capture(fold=False) as reg:
            res = sim.run(sl, sched, state=entry, stop_at=stop,
                          export_state=stop is not None)
            shard_obs = reg.snapshot()
    else:
        res = sim.run(sl, sched, state=entry, stop_at=stop,
                      export_state=stop is not None)
    out = _slice_stats(res, entry)
    out.update(k=k, entry=entry, exit=res.get("state"),
               stats=forecast_stats(sched, len(sl)), n_jobs=len(sl),
               obs=shard_obs)
    return out


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------

def merge_forecast_stats(stats: Sequence[Optional[Dict]]) -> Optional[Dict]:
    """Job-weighted aggregation of per-shard deferral/forecast telemetry.

    ``forecast_mape`` weights by each shard's job count, ``mean_defer_s``
    by its *deferred* job count — so shards that never defer (or hold only
    a handful of jobs) neither drop the fields nor dilute the averages
    arithmetically. ``None`` entries (shards of a non-forecast policy)
    propagate: the merged row only carries the fields when at least one
    shard reported them.
    """
    present = [s for s in stats if s is not None]
    if not present:
        return None
    jobs = sum(s["jobs"] for s in present)
    deferred = sum(s["deferred_jobs"] for s in present)
    mape = (sum(s["forecast_mape"] * s["jobs"] for s in present)
            / max(jobs, 1))
    defer_s = (sum(s["mean_defer_s"] * s["deferred_jobs"] for s in present)
               / deferred if deferred else 0.0)
    return dict(forecast_mape=mape, mean_defer_s=defer_s,
                deferred_jobs=deferred, jobs=jobs,
                deferred_pct=100.0 * deferred / max(jobs, 1))


def _merge_results(parts: List[Dict], inst) -> Dict:
    """Stitch accepted per-slice results into one engine-result dict whose
    per-job frame equals the unsharded run's (same placement order ⇒ the
    same arrays ⇒ identical reductions bit-for-bit)."""
    records = [r for p in parts for r in p["records"]]
    frame = {key: np.concatenate([p["frame"][key] for p in parts])
             for key in parts[0]["frame"]} if parts else None
    if frame is not None and len(records) != int(frame["region"].size):
        # Workers ship frame-only (records stay behind the process
        # boundary): expose *no* record list rather than a silently
        # partial one — a consumer that needs records fails loudly.
        records = None
    sts = [np.asarray(p["solve_times"], np.float64) for p in parts]
    solve_times = (np.concatenate(sts) if sts
                   else np.zeros(0, np.float64))
    horizon = max((p["horizon_s"] for p in parts), default=1.0)
    busy = sum(p["busy_integral_s"] for p in parts)
    denom = _cap_integral(inst.capacity, inst.capacity_events, horizon)
    rounds = sum(p["rounds"] for p in parts)
    peak = np.max(np.stack([p["peak_busy"] for p in parts]), axis=0) \
        if parts else np.zeros_like(inst.capacity)
    return dict(records=records, frame=frame, solve_times=solve_times,
                rounds=rounds, windows=rounds, horizon_s=horizon,
                utilization=busy / max(denom, 1e-9), peak_busy=peak,
                unfinished=parts[-1]["unfinished"] if parts else 0,
                drain_s=horizon)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_sharded_cell(cell: Cell, *, shards: int = 2,
                     max_workers: Optional[int] = None,
                     handoff_s: float = 0.0, device=None) -> Dict:
    """Execute one cell sharded; returns its tidy row.

    Stateless policies take the speculative parallel path (validated per
    boundary, per-shard sequential re-run on mismatch); stateful policies
    run the exact chained handoff (sequential by nature — the scheduler
    object itself is the carried state). ``handoff_s=0`` picks the
    ``auto_handoff_s`` window. The row is bit-identical to the serial
    executor's for carbon/water/violation totals on every path.
    ``device`` is where the policy runs (None: the CUDA card).
    """
    with obs.timed("cell.run_sharded", shards=shards) as t:
        inst, cellkw = build_instance(cell.resolved_scenario())
        w = float(cellkw["window_s"])
        jobs = sorted(inst.jobs, key=lambda j: j.submit_time_s)
        boundaries = pick_shard_boundaries(jobs, shards)
        spec = resolve_policy_spec(cell, inst)
        entry = policy.get_policy(spec.name)
        if not boundaries:                      # degenerate: nothing to split
            inst, spec, sched, result, wall = execute(cell, device=device)
            return finalize_row(cell, spec, inst, result, wall,
                                stats=forecast_stats(sched, len(inst.jobs)))
        if handoff_s <= 0.0:
            handoff_s = auto_handoff_s(jobs)
        slices = slice_by_arrival(jobs, boundaries)
        sim_cfg = SimConfig(window_s=w)

        def _rerun(k: int, state: Optional[EngineState]) -> Dict:
            """Sequential exact run of slice ``k`` from the true state."""
            sched = policy.build(spec, inst.tele, device=device)
            sim = EventSimulator(inst.tele, inst.capacity, sim_cfg,
                                 capacity_events=inst.capacity_events)
            stop = boundaries[k] if k < len(boundaries) else None
            res = sim.run(slices[k], sched, state=state, stop_at=stop,
                          export_state=stop is not None)
            out = _slice_stats(res, None, keep_records=True)
            # A resumed run's rounds/integrals continue the imported state's
            # cumulative values; the fresh scheduler's solve_times don't —
            # subtract only where the chain carried over.
            if state is not None:
                out["rounds"] = res["rounds"] - state.rounds
                out["busy_integral_s"] = (res["busy_integral_s"]
                                          - state.cluster["busy_integral_s"])
            out.update(k=k, entry=state, exit=res.get("state"),
                       stats=forecast_stats(sched, len(slices[k])),
                       n_jobs=len(slices[k]))
            return out

        accepted: List[Dict]
        collect = obs.enabled()
        if entry.stateless:
            n = len(slices)
            workers = max_workers or auto_workers(n, device)
            if workers > 1:
                dev = "cuda" if device is None else str(device)
                with concurrent.futures.ProcessPoolExecutor(
                        workers, mp_context=multiprocessing.get_context(
                            "spawn")) as pool:
                    futs = [pool.submit(_run_shard, cell, str(spec),
                                        boundaries, handoff_s, k, collect,
                                        dev)
                            for k in range(n)]
                    outs = [f.result() for f in futs]
            else:
                outs = [_run_shard(cell, str(spec), boundaries, handoff_s, k,
                                   collect, device) for k in range(n)]
            accepted = [outs[0]]
            true_exit = outs[0]["exit"]
            for k in range(1, n):
                if states_match(true_exit, outs[k]["entry"]):
                    accepted.append(outs[k])
                else:                           # speculation missed: exact redo
                    obs.counter("shard/speculation_miss")
                    accepted.append(_rerun(k, true_exit))
                true_exit = accepted[-1]["exit"]
            if collect:
                # Fold the accepted shards' shipped metrics into the
                # driver registry (re-runs recorded live in-driver and
                # ship no snapshot; rejected speculations are dropped).
                for p in accepted:
                    if p.get("obs"):
                        obs.merge(p["obs"])
        else:
            # Stateful policy: exact chained handoff with one scheduler
            # instance carried across every slice (sequential by nature). The
            # engine's carried state keeps its counters and utilization
            # integrals *cumulative*, so the final slice's result already
            # reports whole-run values bit-identical to the serial path —
            # only the per-slice record streams need concatenating.
            sched = policy.build(spec, inst.tele, device=device)
            sim = EventSimulator(inst.tele, inst.capacity, sim_cfg,
                                 capacity_events=inst.capacity_events)
            records, frames = [], []
            state: Optional[EngineState] = None
            res: Dict = {}
            for k, sl in enumerate(slices):
                stop = boundaries[k] if k < len(boundaries) else None
                res = sim.run(sl, sched, state=state, stop_at=stop,
                              export_state=stop is not None)
                state = res.get("state")
                records.extend(res["records"])
                frames.append(res["frame"])
            result = dict(res, records=records,
                          frame={key: np.concatenate([f[key] for f in frames])
                                 for key in frames[0]})
            result.pop("state", None)
            stats = forecast_stats(sched, len(jobs))
            return finalize_row(cell, spec, inst, result, t.elapsed(),
                                stats=stats)

        stats = merge_forecast_stats([p.get("stats") for p in accepted])
        result = _merge_results(accepted, inst)
        return finalize_row(cell, spec, inst, result, t.elapsed(),
                            stats=stats)
