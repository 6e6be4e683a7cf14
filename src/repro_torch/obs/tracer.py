"""Span/counter tracer all three execution backends emit into.

Two clocks, never mixed in one event:

  * ``"host"`` -- wall-clock seconds from `time.perf_counter()`, relative
    to the tracer's construction time. Used for the coarse phase spans
    (build / compile / execute / eval) every backend emits.
  * ``"sim"`` -- the backend's own simulated-time axis (the netsim event
    clock, or the dense simulator's closed-form `iters*(1/n + k r)`
    charge), in sim units. Used for per-event detail spans (node steps,
    message flights, retunes).

The contract that keeps tracing out of the engines' bit-identity budget:
detail (per-event) emission only happens when `detail=True`, and the
engines hold a pre-resolved local ``tr = tracer if tracer is not None and
tracer.detail else None`` so the hot path carries exactly one
``if tr is not None`` branch -- the same pattern as the controller hooks.
A phase-level tracer (the default for every `repro.run()`) never threads
into the event loops at all.

Events are capped at `max_events`; past the cap the tracer counts drops
instead of growing without bound (`events_dropped`). Counters and series
are never dropped.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Iterator, Sequence

__all__ = ["TraceEvent", "Tracer"]


@dataclasses.dataclass
class TraceEvent:
    """One trace event: a completed span (`dur > 0` or explicit) or an
    instant (`dur == 0.0` and `instant=True`)."""

    name: str
    t0: float                 # start time (host: s since tracer start; sim: sim units)
    dur: float                # duration in the event's clock units
    clock: str = "host"       # "host" | "sim"
    track: str = "main"       # display lane (Perfetto thread)
    instant: bool = False
    args: dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """Collects spans, instants, counters and time series for one run.

    Args:
      detail: when True, backends additionally emit per-event sim-time
        spans (node steps, message flights, retunes). When False (the
        default), only phase-level spans and counters are recorded and the
        engines' event loops are never entered with a tracer at all.
      max_events: hard cap on stored events; further events increment
        `events_dropped` instead of being stored.
    """

    def __init__(self, detail: bool = False, max_events: int = 200_000):
        self.detail = bool(detail)
        self.max_events = int(max_events)
        self.events: list[TraceEvent] = []
        self.counters: dict[str, float] = {}
        self.series: dict[str, list[tuple[float, float]]] = {}
        self.events_dropped = 0
        self._t_origin = time.perf_counter()

    # -- host-clock phases ---------------------------------------------------

    def now(self) -> float:
        """Host seconds since this tracer was created."""
        return time.perf_counter() - self._t_origin

    @contextmanager
    def span(self, name: str, track: str = "main", **args: Any) -> Iterator[None]:
        """Host-clock phase span around a `with` block."""
        t0 = self.now()
        try:
            yield
        finally:
            self._emit(TraceEvent(name=name, t0=t0, dur=self.now() - t0,
                                  clock="host", track=track, args=args))

    def add_host_span(self, name: str, t0: float, dur: float,
                      track: str = "main", **args: Any) -> None:
        """Record an already-measured host-clock span (seconds, relative to
        the tracer's origin -- use `now()` to take timestamps)."""
        self._emit(TraceEvent(name=name, t0=float(t0), dur=float(dur),
                              clock="host", track=track, args=args))

    # -- sim-clock detail ----------------------------------------------------

    def add_span(self, name: str, t0: float, dur: float,
                 track: str = "sim", **args: Any) -> None:
        """Record one sim-time span (e.g. a node step or message flight)."""
        self._emit(TraceEvent(name=name, t0=float(t0), dur=float(dur),
                              clock="sim", track=track, args=args))

    def add_spans(self, name: str, t0s: Sequence[float], durs: Sequence[float],
                  tracks: Sequence[str] | None = None,
                  track: str = "sim") -> None:
        """Batch form of `add_span` for the vectorized engine's chunked
        event groups (one call per chunk, not per node)."""
        if tracks is None:
            for t0, dur in zip(t0s, durs):
                self._emit(TraceEvent(name=name, t0=float(t0), dur=float(dur),
                                      clock="sim", track=track))
        else:
            for t0, dur, trk in zip(t0s, durs, tracks):
                self._emit(TraceEvent(name=name, t0=float(t0), dur=float(dur),
                                      clock="sim", track=str(trk)))

    def add_instant(self, name: str, t: float, clock: str = "sim",
                    track: str = "sim", **args: Any) -> None:
        """Record a zero-duration marker (retune, rewire, eval point)."""
        self._emit(TraceEvent(name=name, t0=float(t), dur=0.0, clock=clock,
                              track=track, instant=True, args=args))

    # -- counters / series ---------------------------------------------------

    def count(self, name: str, n: float = 1.0) -> None:
        """Increment a named counter (messages-sent, bytes-on-wire, ...)."""
        self.counters[name] = self.counters.get(name, 0.0) + n

    def record_series(self, name: str, t: float, value: float) -> None:
        """Append one (t, value) sample to a named time series (e.g. the
        observed r-hat trajectory on the sim clock)."""
        self.series.setdefault(name, []).append((float(t), float(value)))

    # -- aggregation ---------------------------------------------------------

    def phase_totals(self) -> dict[str, dict[str, float]]:
        """Aggregate host-clock spans by name: total seconds and count."""
        out: dict[str, dict[str, float]] = {}
        for ev in self.events:
            if ev.clock != "host" or ev.instant:
                continue
            agg = out.setdefault(ev.name, {"total_s": 0.0, "count": 0})
            agg["total_s"] += ev.dur
            agg["count"] += 1
        return out

    # -- internals -----------------------------------------------------------

    def _emit(self, ev: TraceEvent) -> None:
        if len(self.events) >= self.max_events:
            self.events_dropped += 1
            return
        self.events.append(ev)
