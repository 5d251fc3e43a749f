"""Reporting CLI for obs traces (the port of ``repro/obs/report.py``; the
port's traces share the reference's format).

Usage::

    python -m repro_torch.obs.report run.trace.jsonl         # per-stage table
    python -m repro_torch.obs.report run.trace.jsonl --json  # machine-readable
    python -m repro_torch.obs.report --validate run.trace.jsonl  # schema
    python -m repro_torch.obs.report --diff a.trace.jsonl b.trace.jsonl

The per-stage table gives count / total / p50 / p95 / p99 / max wall
time per span name, plus mean Sinkhorn iteration count and final
residual for solver spans that carry them as args.  If the trace holds
simulated-time counter series (``sim/carbon_g`` etc., emitted by a
traced :class:`~repro_torch.sim.engine.EventSimulator` run), a per-region
carbon/water/WUE time-series table is rendered after the stage table.
``--diff`` compares two traces stage-by-stage (p50/p99 deltas) for
regression triage.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import read_trace, validate_events

# span args whose mean is worth a column in the stage table
_ARG_COLS = ("sinkhorn_iters", "residual", "occupancy")

_SERIES = ("sim/carbon_g", "sim/water_L", "sim/wue")
_SERIES_LABEL = {"sim/carbon_g": "carbon_g", "sim/water_L": "water_L",
                 "sim/wue": "wue"}


def stage_stats(events: Sequence[Dict]) -> Dict[str, Dict]:
    """Aggregate ``ph == "X"`` events by name."""
    durs: Dict[str, List[float]] = {}
    args_acc: Dict[str, Dict[str, List[float]]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev["name"]
        durs.setdefault(name, []).append(ev["dur"] / 1e3)  # -> ms
        for k in _ARG_COLS:
            v = ev.get("args", {}).get(k)
            if isinstance(v, (int, float)):
                args_acc.setdefault(name, {}).setdefault(k, []).append(v)
    out: Dict[str, Dict] = {}
    for name, ds in durs.items():
        arr = np.asarray(ds)
        st = {
            "count": int(arr.size),
            "total_ms": float(arr.sum()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
            "max_ms": float(arr.max()),
        }
        for k, vals in args_acc.get(name, {}).items():
            st[f"mean_{k}"] = float(np.mean(vals))
        out[name] = st
    return out


def series_stats(events: Sequence[Dict]) -> Dict[str, Dict[str, List]]:
    """Collect simulated-time counter series: name -> region -> points.
    ``ts`` is sim-microseconds (hour = ts / 3.6e9)."""
    out: Dict[str, Dict[str, List]] = {}
    for ev in events:
        if ev.get("ph") != "C" or ev["name"] not in _SERIES:
            continue
        hour = ev["ts"] / 3.6e9
        for region, v in ev.get("args", {}).items():
            out.setdefault(ev["name"], {}).setdefault(region, []) \
               .append((hour, float(v)))
    return out


def _fmt(v: Optional[float], width: int = 9) -> str:
    if v is None:
        return " " * (width - 1) + "-"
    if v == 0:
        return f"{0:>{width}.0f}"
    if abs(v) >= 1e5 or abs(v) < 1e-3:
        return f"{v:>{width}.2e}"
    return f"{v:>{width}.3f}"


def render_stage_table(stats: Dict[str, Dict]) -> str:
    if not stats:
        return "(no spans in trace)"
    has_iters = any("mean_sinkhorn_iters" in s for s in stats.values())
    head = (f"{'stage':<28}{'count':>7}{'total_ms':>11}{'p50_ms':>10}"
            f"{'p95_ms':>10}{'p99_ms':>10}{'max_ms':>10}")
    if has_iters:
        head += f"{'iters':>8}{'residual':>11}"
    lines = [head, "-" * len(head)]
    for name in sorted(stats, key=lambda n: -stats[n]["total_ms"]):
        s = stats[name]
        row = (f"{name:<28}{s['count']:>7}{_fmt(s['total_ms'], 11)}"
               f"{_fmt(s['p50_ms'], 10)}{_fmt(s['p95_ms'], 10)}"
               f"{_fmt(s['p99_ms'], 10)}{_fmt(s['max_ms'], 10)}")
        if has_iters:
            it = s.get("mean_sinkhorn_iters")
            res = s.get("mean_residual")
            row += (f"{it:>8.0f}" if it is not None else f"{'-':>8}")
            row += (f"{res:>11.2e}" if res is not None else f"{'-':>11}")
        lines.append(row)
    return "\n".join(lines)


def render_series_table(series: Dict[str, Dict[str, List]],
                        max_rows: int = 24) -> str:
    if not series:
        return ""
    regions = sorted({r for by_r in series.values() for r in by_r})
    # union of hours across signals, subsampled to max_rows
    hours = sorted({round(h, 6) for by_r in series.values()
                    for pts in by_r.values() for h, _ in pts})
    step = max(1, len(hours) // max_rows)
    shown = hours[::step]
    lookup = {(n, r): dict((round(h, 6), v) for h, v in pts)
              for n, by_r in series.items() for r, pts in by_r.items()}
    cols = [(n, r) for n in _SERIES if n in series for r in regions
            if r in series[n]]
    head = f"{'hour':>7}" + "".join(
        f"{_SERIES_LABEL[n] + ':' + r:>16}" for n, r in cols)
    lines = ["per-region footprint series (simulated time)", head,
             "-" * len(head)]
    for h in shown:
        row = f"{h:>7.1f}"
        for key in cols:
            row += _fmt(lookup[key].get(h), 16)
        lines.append(row)
    if step > 1:
        lines.append(f"({len(hours)} hourly points, showing every {step})")
    return "\n".join(lines)


def render_diff(a_stats: Dict[str, Dict], b_stats: Dict[str, Dict],
                a_name: str, b_name: str) -> str:
    names = sorted(set(a_stats) | set(b_stats))
    head = (f"{'stage':<28}{'p50_a':>10}{'p50_b':>10}{'Δp50%':>8}"
            f"{'p99_a':>10}{'p99_b':>10}{'Δp99%':>8}")
    lines = [f"diff: a={a_name}  b={b_name}", head, "-" * len(head)]
    for name in names:
        sa, sb = a_stats.get(name), b_stats.get(name)
        if sa is None or sb is None:
            lines.append(f"{name:<28}  only in {'b' if sa is None else 'a'}")
            continue
        def delta(k):
            if sa[k] <= 0:
                return float("nan")
            return 100.0 * (sb[k] - sa[k]) / sa[k]
        lines.append(f"{name:<28}{_fmt(sa['p50_ms'], 10)}"
                     f"{_fmt(sb['p50_ms'], 10)}{delta('p50_ms'):>+8.1f}"
                     f"{_fmt(sa['p99_ms'], 10)}{_fmt(sb['p99_ms'], 10)}"
                     f"{delta('p99_ms'):>+8.1f}")
    return "\n".join(lines)


def summarize(path: str) -> Dict:
    events = read_trace(path)
    return {"path": path, "events": len(events),
            "stages": stage_stats(events),
            "series": {n: {r: len(pts) for r, pts in by_r.items()}
                       for n, by_r in series_stats(events).items()}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.obs.report",
                                description=__doc__.splitlines()[0])
    p.add_argument("trace", nargs="*", help="trace file(s)")
    p.add_argument("--diff", nargs=2, metavar=("A", "B"),
                   help="compare two traces stage-by-stage")
    p.add_argument("--validate", action="store_true",
                   help="validate events against the schema; exit 1 on errors")
    p.add_argument("--json", action="store_true",
                   help="emit a machine-readable summary instead of tables")
    args = p.parse_args(argv)

    if args.diff:
        a, b = args.diff
        print(render_diff(stage_stats(read_trace(a)),
                          stage_stats(read_trace(b)), a, b))
        return 0

    if not args.trace:
        p.error("need a trace file (or --diff A B)")
    rc = 0
    for path in args.trace:
        events = read_trace(path)
        if args.validate:
            errors = validate_events(events)
            if errors:
                rc = 1
                print(f"{path}: {len(errors)} schema violation(s)")
                for e in errors[:20]:
                    print(f"  {e}")
            else:
                print(f"{path}: {len(events)} events, schema OK")
            continue
        if args.json:
            print(json.dumps(summarize(path), indent=2, sort_keys=True))
            continue
        print(f"{path}: {len(events)} events")
        print(render_stage_table(stage_stats(events)))
        tbl = render_series_table(series_stats(events))
        if tbl:
            print()
            print(tbl)
    return rc


if __name__ == "__main__":
    sys.exit(main())
