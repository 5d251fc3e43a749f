"""Chrome-trace-event JSONL writer + reader.

The on-disk format is the Chrome trace "JSON array" flavour written
line-orientedly: the first line is ``[``, then one event object per
line, each terminated by ``,``.  The closing ``]`` is deliberately
omitted — the trace-event spec makes it optional so crashed runs stay
loadable — which means the file is simultaneously

* loadable in Perfetto / ``chrome://tracing`` as-is, and
* greppable/streamable: every event is one ``json.loads``-able line
  after stripping the trailing comma.

Timestamps (``ts``/``dur``) are microseconds.  Wall-clock spans use
``time.perf_counter`` relative to the writer's epoch; *simulated-time*
counter series (per-region carbon/water/WUE) are emitted against a
separate ``pid`` so Perfetto renders them on their own track instead of
interleaving sim-seconds with wall-microseconds.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional

# pid used for simulated-time counter tracks (sim seconds -> "us").
SIM_PID = 2

# Event-schema contract (validated by ``validate_events`` and the CI
# smoke job): required keys per phase type.
_REQUIRED = {"name", "ph", "ts", "pid", "tid"}
_PHASES = {"X", "i", "C", "M"}


class TraceWriter:
    """Append-only trace-event writer. Not thread-safe by design — the
    simulator is single-threaded and shard workers each get their own
    process (and would write their own file)."""

    def __init__(self, path: str) -> None:
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")
        self._f.write("[\n")
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self.events_written = 0
        self.metadata("process_name", {"name": "repro"})
        self.metadata("process_name", {"name": "simulated-time"}, pid=SIM_PID)

    # -- clock -----------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- emitters --------------------------------------------------------
    def _emit(self, ev: Dict) -> None:
        self._f.write(json.dumps(ev, separators=(",", ":")) + ",\n")
        self.events_written += 1

    def complete(self, name: str, ts_us: float, dur_us: float,
                 args: Optional[Dict] = None, cat: str = "repro") -> None:
        """A ``ph: "X"`` complete event (a span)."""
        ev = {"name": name, "ph": "X", "cat": cat, "ts": round(ts_us, 3),
              "dur": round(max(dur_us, 0.0), 3), "pid": self._pid, "tid": 1}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, args: Optional[Dict] = None) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "ts": round(self.now_us(), 3),
              "pid": self._pid, "tid": 1}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: Dict[str, float],
                ts_us: Optional[float] = None, pid: Optional[int] = None) -> None:
        """A ``ph: "C"`` counter event. Pass ``pid=SIM_PID`` with a
        simulated-time ``ts_us`` for sim-clock series."""
        self._emit({"name": name, "ph": "C",
                    "ts": round(self.now_us() if ts_us is None else ts_us, 3),
                    "pid": self._pid if pid is None else pid, "tid": 1,
                    "args": values})

    def metadata(self, name: str, args: Dict, pid: Optional[int] = None) -> None:
        self._emit({"name": name, "ph": "M", "ts": 0,
                    "pid": self._pid if pid is None else pid, "tid": 1,
                    "args": args})

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ---------------------------------------------------------------------------
# reading / validation
# ---------------------------------------------------------------------------

def read_trace(path: str) -> List[Dict]:
    """Parse a trace file written by :class:`TraceWriter` (tolerates a
    plain JSON array too)."""
    with open(path) as f:
        first = f.readline().strip()
        if not first.startswith("["):
            raise ValueError(f"{path}: not a trace-event file")
        if first != "[":  # whole array on one (or few) line(s)
            text = (first + f.read()).rstrip().rstrip(",")
            if not text.endswith("]"):
                text += "]"
            return json.loads(text)
        events = []
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line == "]":
                continue
            events.append(json.loads(line))
        return events


def iter_spans(events: List[Dict]) -> Iterator[Dict]:
    for ev in events:
        if ev.get("ph") == "X":
            yield ev


def validate_events(events: List[Dict]) -> List[str]:
    """Return a list of schema violations (empty == valid)."""
    errors: List[str] = []
    for i, ev in enumerate(events):
        missing = _REQUIRED - set(ev)
        if missing:
            errors.append(f"event {i}: missing keys {sorted(missing)}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES:
            errors.append(f"event {i} ({ev['name']}): unknown ph {ph!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            errors.append(f"event {i} ({ev['name']}): bad ts {ev['ts']!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev['name']}): X event needs "
                              f"non-negative dur, got {dur!r}")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append(f"event {i} ({ev['name']}): C event needs args")
    return errors
