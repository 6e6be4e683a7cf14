"""Trace export: Chrome-trace/Perfetto JSON, JSONL, and the shared
strict-RFC artifact writer.

Chrome trace format (the `chrome://tracing` / Perfetto "JSON object"
flavor): a `{"traceEvents": [...]}` object whose events carry
microsecond `ts`/`dur`. Host-clock spans map 1 s -> 1e6 us as usual; sim
clock spans are scaled the same way (1 sim unit -> 1e6 us) so both load,
but land in separate Perfetto *processes* (pid 1 "host", pid 2 "sim") --
the two axes are different clocks and must never share a lane. Track
names become named threads via `thread_name` metadata events; counters
are emitted as one terminal `ph: "C"` sample per counter so totals show
up in the counter track.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable

from repro_torch.obs.tracer import TraceEvent, Tracer

__all__ = ["chrome_trace_events", "write_chrome_trace",
           "write_json_artifact", "write_jsonl"]

_CLOCK_PID = {"host": 1, "sim": 2}
_US = 1e6  # 1 second (or 1 sim unit) -> microseconds


def _track_ids(events: Iterable[TraceEvent]) -> dict[tuple[str, str], int]:
    """Stable (clock, track) -> tid assignment in first-seen order."""
    ids: dict[tuple[str, str], int] = {}
    for ev in events:
        key = (ev.clock, ev.track)
        if key not in ids:
            ids[key] = len(ids) + 1
    return ids


def chrome_trace_events(tracer: Tracer, run_name: str = "run") -> list[dict]:
    """Render a Tracer's events/counters as Chrome trace event dicts."""
    tids = _track_ids(tracer.events)
    out: list[dict] = []
    # process/thread naming metadata
    for clock, pid in _CLOCK_PID.items():
        label = "host (s)" if clock == "host" else "sim (units)"
        out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": f"{run_name}: {label}"}})
    for (clock, track), tid in tids.items():
        out.append({"name": "thread_name", "ph": "M",
                    "pid": _CLOCK_PID[clock], "tid": tid,
                    "args": {"name": track}})
    for ev in tracer.events:
        pid = _CLOCK_PID[ev.clock]
        tid = tids[(ev.clock, ev.track)]
        if ev.instant:
            rec = {"name": ev.name, "ph": "i", "s": "t",
                   "ts": ev.t0 * _US, "pid": pid, "tid": tid}
        else:
            rec = {"name": ev.name, "ph": "X", "ts": ev.t0 * _US,
                   "dur": ev.dur * _US, "pid": pid, "tid": tid}
        if ev.args:
            rec["args"] = dict(ev.args)
        out.append(rec)
    # counter totals as one terminal sample each
    t_end = max((ev.t0 + ev.dur for ev in tracer.events), default=0.0)
    for name, value in sorted(tracer.counters.items()):
        out.append({"name": name, "ph": "C", "ts": t_end * _US,
                    "pid": _CLOCK_PID["host"], "tid": 0,
                    "args": {"value": value}})
    return out


def write_chrome_trace(tracer: Tracer, path, run_name: str = "run") -> str:
    """Write a Perfetto-loadable Chrome trace JSON file; returns the path."""
    payload = {
        "traceEvents": chrome_trace_events(tracer, run_name=run_name),
        "displayTimeUnit": "ms",
        "otherData": {
            "events_dropped": tracer.events_dropped,
            "series": {k: [[t, v] for t, v in s]
                       for k, s in tracer.series.items()},
        },
    }
    return write_json_artifact(path, payload)


def write_jsonl(tracer: Tracer, path) -> str:
    """Write the raw event stream as JSON Lines (one event per line,
    counters and series as trailing summary records); returns the path."""
    from repro_torch.core.dda import json_sanitize

    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        for ev in tracer.events:
            rec = {"kind": "instant" if ev.instant else "span",
                   "name": ev.name, "t0": ev.t0, "dur": ev.dur,
                   "clock": ev.clock, "track": ev.track}
            if ev.args:
                rec["args"] = json_sanitize(ev.args)
            f.write(json.dumps(rec, allow_nan=False) + "\n")
        for name, value in sorted(tracer.counters.items()):
            f.write(json.dumps({"kind": "counter", "name": name,
                                "value": value}, allow_nan=False) + "\n")
        for name, samples in sorted(tracer.series.items()):
            f.write(json.dumps(
                {"kind": "series", "name": name,
                 "samples": [[t, v] for t, v in samples]},
                allow_nan=False) + "\n")
        if tracer.events_dropped:
            f.write(json.dumps({"kind": "dropped",
                                "count": tracer.events_dropped},
                               allow_nan=False) + "\n")
    return str(p)


def write_json_artifact(path, payload: dict) -> str:
    """The one strict-RFC JSON artifact writer: sanitizes (inf/nan ->
    null, np scalars -> Python), creates parent dirs, writes with
    `allow_nan=False`. CI smoke artifacts, bench --out files and the
    convergence tier's failure dumps all go through here."""
    from repro_torch.core.dda import json_sanitize

    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(json_sanitize(payload), f, indent=2, allow_nan=False)
    return str(p)
