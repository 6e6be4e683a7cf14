"""Discrete-event simulation clock: a priority queue of timestamped events.

The netsim's single source of truth for time. Events are totally ordered by
(time, prio, seq): `prio` ranks event KINDS at equal timestamps (message
arrivals before everything else -- see below), and `seq` is a monotone
insertion counter, so simultaneous same-kind events fire in schedule order
and the whole simulation is deterministic for a fixed seed (no dict/hash
iteration order anywhere on the hot path).

Why kind priority exists: the object engine interleaves message and
step-reschedule insertions per node, while the vectorized engine inserts a
whole batch's messages before its steps. Under pure (time, seq) order the
two engines could disagree ONLY when a message arrival tied a FUTURE step
completion to the exact float (link latency == remaining busy time to the
ulp) -- the one documented seam of the vectorized fast path. Ranking
in-flight arrivals ahead of other events at their (strictly future) target
time makes the insertion interleaving unobservable and closes that seam:
the engines are bit-identical even on constructed exact ties
(tests/test_netsim_engine.py::test_exact_float_tie_msg_vs_step_bit_identical).

The priority is deliberately NOT applied to a message scheduled at exactly
`now` (a zero-remaining-flight delivery emitted while processing the
current timestamp): simultaneous events must not causally affect each
other, so such a message stays behind the steps already due at `now` --
which is both engines' existing (and matching) behavior for the
ubiquitous zero-latency case. Non-tied timestamps are ordered by time
alone; all previously seeded traces are unchanged either way.

Two interchangeable backends behind the same API:

  * ``"heap"``     -- binary heap (heapq), O(log m) per operation. The
                      reference backend; always correct, never surprising.
  * ``"calendar"`` -- bucketed calendar queue (Brown 1988): events hash into
                      a circular array of time buckets of width w, inserts
                      bisect into their bucket, pops walk the calendar one
                      bucket per "day". For the netsim's workloads -- a
                      bounded number of in-flight events whose timestamps
                      cluster around now -- every operation is O(1)
                      amortized, which matters once the vectorized engine
                      has removed the per-node Python work and queue churn
                      is the next hot spot. The bucket count doubles when
                      the queue outgrows it, and the width is re-estimated
                      from observed inter-event gaps on each resize.

Both backends produce the exact same (time, prio, seq) total order,
including the tie-breaking of simultaneous events -- property-tested
against each other in tests/test_netsim_engine.py.

Time is in the paper's normalized units: 1.0 = one full-data gradient on the
reference node (tradeoff.py eq. 9 normalization), so event timestamps are
directly comparable to `iteration_cost` / `time_to_accuracy` predictions.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import Any

__all__ = ["Event", "EventQueue"]


#: kinds that jump the queue at equal (strictly future) timestamps: message
#: arrivals. "fault" and "retry" events form their own classes below
#: arrivals but above everything else, so a crash scheduled at time tau
#: kills the node BEFORE its step completing at tau, identically on both
#: engines (whose seq numbering differs for batched vs per-node inserts).
#: Every other kind -- and an arrival at exactly `now` -- shares the lowest
#: class, preserving plain seq order among themselves.
_ARRIVAL_KINDS = frozenset({"msg", "msgs"})
_KIND_PRIO = {"fault": 1, "retry": 2}
_DEFAULT_PRIO = 3


@dataclasses.dataclass(order=True, slots=True)
class Event:
    time: float
    prio: int
    seq: int
    kind: str = dataclasses.field(compare=False)
    data: dict[str, Any] = dataclasses.field(compare=False,
                                             default_factory=dict)


class _HeapBackend:
    """Reference backend: one heapq entry per event."""

    __slots__ = ("_heap",)

    def __init__(self) -> None:
        self._heap: list[Event] = []

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, ev)

    def peek(self) -> Event:
        return self._heap[0]

    def pop(self) -> Event:
        return heapq.heappop(self._heap)


class _CalendarBackend:
    """Calendar queue: a circular array of sorted day-buckets.

    Every event is keyed by its absolute day ``day = floor(time / width)``
    and lives in bucket ``day % nb``. The queue walks days in order: the
    head of the current day's bucket is next iff its day matches; otherwise
    the calendar advances (fast-forwarding over empty stretches by scanning
    the heads of all buckets, which only happens when the queue is sparse
    relative to its year and is amortized against the events that put the
    calendar there).

    The in-this-day test recomputes ``_day_of(event.time)`` at pop time and
    compares it to the walker's day by exact integer equality -- immune to
    the float boundary cases that plague width-multiplication bound checks.
    This is consistent with the insert-side bucketing ONLY because
    ``_width`` never changes outside ``_resize``, which re-buckets every
    pending event under the new width; any future adaptive width retuning
    must do the same full re-insertion.

    Buckets are kept ascending by (time, seq) with a start-offset pointer
    instead of list.pop(0), so draining a bucket of m simultaneous events
    is O(m) total, not O(m^2). Because `seq` is globally monotone, the
    common insert (newest event among equal timestamps) lands at the tail
    of its bucket -- an O(log m) bisect plus an O(1) append.
    """

    __slots__ = ("_width", "_nb", "_buckets", "_starts", "_count", "_day")

    _MIN_WIDTH = 1e-12

    def __init__(self, width: float = 1.0, nbuckets: int = 8) -> None:
        self._width = float(width)
        self._nb = int(nbuckets)
        self._buckets: list[list[tuple[float, int, Event]]] = [
            [] for _ in range(self._nb)]
        self._starts = [0] * self._nb
        self._count = 0
        self._day = 0  # absolute day the calendar is currently serving

    def __len__(self) -> int:
        return self._count

    # -- internals ----------------------------------------------------------

    def _day_of(self, time: float) -> int:
        return int(time / self._width)

    def _insert(self, ev: Event) -> None:
        day = self._day_of(ev.time)
        b = self._buckets[day % self._nb]
        key = (ev.time, ev.prio, ev.seq, ev)
        if b and key < b[-1]:
            lo = self._starts[day % self._nb]
            bisect.insort(b, key, lo=lo)
        else:
            b.append(key)
        self._count += 1

    def _resize(self) -> None:
        """Double the bucket count and retune the width to the mean
        inter-event gap, then re-insert everything (O(m): each event is
        appended to a bucket and each bucket sorted once)."""
        events = [key for i, b in enumerate(self._buckets)
                  for key in b[self._starts[i]:]]
        times = sorted(key[0] for key in events)
        if len(times) >= 2 and times[-1] > times[0]:
            # mean gap over the occupied span; distinct-time collapse (all
            # events simultaneous) keeps the previous width instead
            width = (times[-1] - times[0]) / (len(times) - 1)
            self._width = max(width, self._MIN_WIDTH)
        self._nb *= 2
        self._buckets = [[] for _ in range(self._nb)]
        self._starts = [0] * self._nb
        if events:
            floor_day = min(self._day_of(key[0]) for key in events)
            self._day = min(self._day, floor_day)
        for key in sorted(events):
            day = self._day_of(key[0])
            self._buckets[day % self._nb].append(key)
        self._count = len(events)

    def _advance_to_next(self) -> None:
        """Move `_day` forward to the next day holding an event.

        Walks at most one full rotation bucket-by-bucket; if a whole year
        passes with nothing due, jumps straight to the earliest pending
        day (sparse-queue fast-forward)."""
        for _ in range(self._nb):
            idx = self._day % self._nb
            b = self._buckets[idx]
            s = self._starts[idx]
            if s < len(b) and self._day_of(b[s][0]) == self._day:
                return
            self._day += 1
        # full rotation without a hit: jump to the earliest pending event
        best = None
        for i, b in enumerate(self._buckets):
            s = self._starts[i]
            if s < len(b):
                d = self._day_of(b[s][0])
                if best is None or d < best:
                    best = d
        assert best is not None, "advance called on empty calendar"
        self._day = best

    # -- API ----------------------------------------------------------------

    def push(self, ev: Event) -> None:
        if not math.isfinite(ev.time):
            raise ValueError(f"calendar queue needs finite times, got {ev.time}")
        day = self._day_of(ev.time)
        if day < self._day:
            self._day = day  # pushing at/near `now`: rewind the walk
        self._insert(ev)
        if self._count > 2 * self._nb and self._nb < (1 << 20):
            self._resize()

    def _head(self) -> tuple[int, int]:
        """(bucket index, start offset) of the next event; advances days."""
        self._advance_to_next()
        idx = self._day % self._nb
        return idx, self._starts[idx]

    def peek(self) -> Event:
        if not self._count:
            raise IndexError("peek from an empty calendar queue")
        idx, s = self._head()
        return self._buckets[idx][s][-1]

    def pop(self) -> Event:
        if not self._count:
            raise IndexError("pop from an empty calendar queue")
        idx, s = self._head()
        b = self._buckets[idx]
        ev = b[s][-1]
        self._starts[idx] = s + 1
        self._count -= 1
        # compact lazily so a drained prefix doesn't pin memory
        if self._starts[idx] > 64 and self._starts[idx] * 2 >= len(b):
            del b[:self._starts[idx]]
            self._starts[idx] = 0
        return ev


class EventQueue:
    """Priority queue of events plus the simulation clock `now`.

    `now` only advances via `pop()`; scheduling in the past raises, so causal
    ordering cannot be violated by a buggy handler.

    `backend` selects the storage strategy ("heap" or "calendar", see module
    docstring); both realize the identical (time, prio, seq) total order,
    with prio derived from the event kind (message arrivals first).
    """

    def __init__(self, backend: str = "heap") -> None:
        if backend == "heap":
            self._q: _HeapBackend | _CalendarBackend = _HeapBackend()
        elif backend == "calendar":
            self._q = _CalendarBackend()
        else:
            raise ValueError(f"unknown EventQueue backend {backend!r}")
        self.backend = backend
        self._seq = 0
        self.now = 0.0

    def __len__(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return len(self._q) == 0

    def schedule(self, time: float, kind: str, **data: Any) -> Event:
        if time < self.now:
            raise ValueError(
                f"cannot schedule {kind!r} at {time} < now={self.now}")
        prio = (0 if (kind in _ARRIVAL_KINDS and time > self.now)
                else _KIND_PRIO.get(kind, _DEFAULT_PRIO))
        ev = Event(float(time), prio, self._seq, kind, data)
        self._seq += 1
        self._q.push(ev)
        return ev

    def schedule_in(self, delay: float, kind: str, **data: Any) -> Event:
        return self.schedule(self.now + delay, kind, **data)

    def peek(self) -> Event:
        return self._q.peek()

    def pop(self) -> Event:
        ev = self._q.pop()
        self.now = ev.time
        return ev
