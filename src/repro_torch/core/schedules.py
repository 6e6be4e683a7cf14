"""Communication schedules and convergence constants from the paper.

Three regimes (paper sections III.B, IV.A, IV.B):

  * every-iteration  (h = 1)                        -- constant C_1   (eq. 7)
  * periodic         (communicate every h+1 iters)  -- constant C_h   (eq. 18)
  * increasingly sparse (h_j = j^p, 0 < p < 1/2)    -- constant C_p   (eq. 31)

A schedule answers one question per step t (1-indexed): "is t a communication
(expensive) iteration?" plus the bookkeeping H_t (number of communication
steps among the first t iterations, eq. 12) and Q_t (iterations since the last
communication).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Iterator

import numpy as np

__all__ = [
    "CommSchedule",
    "EveryIteration",
    "Periodic",
    "IncreasinglySparse",
    "PiecewisePeriodic",
    "make_schedule",
    "c1_constant",
    "ch_constant",
    "cp_constant",
    "optimal_stepsize_A",
]


class CommSchedule:
    """Base class. Iterations are 1-indexed, matching the paper."""

    name: str = "base"

    def is_comm_step(self, t: int) -> bool:
        raise NotImplementedError

    def H(self, t: int) -> int:
        """Number of communication steps among iterations 1..t."""
        return sum(1 for s in range(1, t + 1) if self.is_comm_step(s))

    def comm_steps(self, T: int) -> Iterator[int]:
        return (t for t in range(1, T + 1) if self.is_comm_step(t))

    def next_comm_step(self, t: int) -> int:
        """Smallest communication iteration strictly greater than t.

        Sim-time query used by the event-driven netsim: an async node asks
        once per communication round instead of testing `is_comm_step`
        every iteration (which is O(t) per call for the sparse schedule).
        Subclasses override with closed forms where available.
        """
        s = t + 1
        while not self.is_comm_step(s):
            s += 1
        return s

    def next_comm_step_batch(self, t: np.ndarray) -> np.ndarray:
        """`next_comm_step` over an int array of iteration counters.

        Used by the netsim's vectorized engine, which advances a whole
        batch of due nodes per event bucket. The base implementation is
        the per-element loop; schedules with closed forms override it with
        pure array arithmetic so a 1000-node batch costs no Python-level
        iteration.
        """
        t = np.asarray(t)
        return np.array([self.next_comm_step(int(s)) for s in t],
                        dtype=np.int64)

    def comm_mask(self, t0: int, length: int) -> np.ndarray:
        """Boolean mask over iterations t0+1 .. t0+length: True where the
        iteration communicates.

        This is the whole-run precompute behind `DDASimulator`'s scanned
        segment loop: the comm pattern becomes DATA fed to one compiled
        program instead of a host-side `is_comm_step` query per iteration
        per dispatch. The base implementation hops `next_comm_step`
        (O(#comm steps), schedule-agnostic); Every/Periodic/Sparse/
        Piecewise override with pure array arithmetic.
        """
        mask = np.zeros(int(length), dtype=bool)
        t = int(t0)
        end = int(t0) + int(length)
        while True:
            t = self.next_comm_step(t)
            if t > end:
                return mask
            mask[t - t0 - 1] = True

    def constant(self, L: float, R: float, lam2: float) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EveryIteration(CommSchedule):
    """h = 1: communicate at every iteration (original DDA, paper III.B)."""

    name: str = "every"

    def is_comm_step(self, t: int) -> bool:
        return True

    def H(self, t: int) -> int:
        return t

    def next_comm_step(self, t: int) -> int:
        return t + 1

    def next_comm_step_batch(self, t: np.ndarray) -> np.ndarray:
        return np.asarray(t, dtype=np.int64) + 1

    def comm_mask(self, t0: int, length: int) -> np.ndarray:
        return np.ones(int(length), dtype=bool)

    def constant(self, L: float, R: float, lam2: float) -> float:
        return c1_constant(L, R, lam2)


@dataclasses.dataclass(frozen=True)
class Periodic(CommSchedule):
    """Communicate once every h+1 iterations (h cheap then 1 expensive).

    Paper IV.A: of T iterations only H_T = floor((T-1)/h) involve
    communication (eq. 19). We realize that count with comm steps at
    t = h+1, 2h+2, ...? No -- the paper's indexing has the FIRST h
    iterations cheap, then iteration h+1 is... Careful reading of eq. (12):
    H_t = floor((t-1)/h) counts communication steps within t iterations and
    Q_t = mod(t, h) (or h when the mod is 0) counts the trailing cheap
    iterations. That corresponds to: iteration t is expensive iff
    t ≡ 1 (mod h) and t > 1  -- i.e. comm happens at t = h+1, 2h+1, 3h+1...
    equivalently after every h local updates.
    """

    h: int = 1
    name: str = "periodic"

    def __post_init__(self):
        if self.h < 1:
            raise ValueError("h must be >= 1")

    def is_comm_step(self, t: int) -> bool:
        return t > 1 and (t - 1) % self.h == 0

    def H(self, t: int) -> int:
        return (t - 1) // self.h

    def Q(self, t: int) -> int:
        m = t % self.h
        return m if m > 0 else self.h

    def next_comm_step(self, t: int) -> int:
        # comm steps are 1 + m*h for m >= 1
        m = max(1, (t - 1) // self.h + 1)
        return 1 + m * self.h

    def next_comm_step_batch(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.int64)
        m = np.maximum(1, (t - 1) // self.h + 1)
        return 1 + m * self.h

    def comm_mask(self, t0: int, length: int) -> np.ndarray:
        t = np.arange(int(t0) + 1, int(t0) + int(length) + 1, dtype=np.int64)
        return (t > 1) & ((t - 1) % self.h == 0)

    def constant(self, L: float, R: float, lam2: float) -> float:
        return ch_constant(L, R, lam2, self.h)


@dataclasses.dataclass(frozen=True)
class IncreasinglySparse(CommSchedule):
    """h_j = j^p cheap-iteration gaps (paper IV.B).

    The j-th communication happens at iteration ceil(sum_{i<=j} i^p): the
    first at h_1 = 1, the second at h_1 + h_2, etc. H_T = Theta(T^(1/(p+1)))
    communication steps among T iterations (eq. 22). Convergence requires
    0 <= p < 1/2 (p = 1 provably diverges -- paper Fig. 2).
    """

    p: float = 0.3
    name: str = "sparse"

    def __post_init__(self):
        if self.p < 0:
            raise ValueError("p must be >= 0")

    def _comm_times(self, upto: int) -> list[int]:
        times, acc, j = [], 0.0, 1
        while True:
            acc += j ** self.p
            t = math.ceil(acc)
            if t > upto:
                break
            times.append(t)
            j += 1
        return times

    def _comm_times_past(self, upto: int) -> np.ndarray:
        """All comm times for j = 1..jmax with jmax chosen so the tail
        strictly exceeds `upto` (sum_{i<=j} i^p >= j^(p+1)/(p+1), so any
        j > ((p+1) upto)^(1/(p+1)) lands past it). The partial sums are
        accumulated with host floats in the exact order of the scalar
        queries above, so the vectorized answers can never drift from
        `is_comm_step`/`next_comm_step` by a ulp of `pow`."""
        upto = max(int(upto), 1)
        jmax = int(((self.p + 1.0) * upto) ** (1.0 / (self.p + 1.0))) + 2
        steps = np.array([float(j) ** self.p for j in range(1, jmax + 1)],
                         dtype=np.float64)
        times = np.ceil(np.cumsum(steps)).astype(np.int64)
        assert times[-1] > upto, (times[-1], upto)
        return times

    def is_comm_step(self, t: int) -> bool:
        # t is a comm step iff exists j with ceil(sum_{i<=j} i^p) == t.
        acc, j = 0.0, 1
        while True:
            acc += j ** self.p
            ct = math.ceil(acc)
            if ct == t:
                return True
            if ct > t:
                return False
            j += 1

    def H(self, t: int) -> int:
        return len(self._comm_times(t))

    def next_comm_step(self, t: int) -> int:
        acc, j = 0.0, 1
        while True:
            acc += j ** self.p
            ct = math.ceil(acc)
            if ct > t:
                return ct
            j += 1

    def next_comm_step_batch(self, t: np.ndarray) -> np.ndarray:
        """Vectorized closed form: the comm times are the ceil'd partial
        sums of j^p, so 'first comm step strictly after t' is one
        searchsorted into that (precomputed) sequence -- no per-element
        Python iteration, usable inside the scanned-mask precompute."""
        t = np.asarray(t, dtype=np.int64)
        times = self._comm_times_past(int(t.max()) if t.size else 1)
        return times[np.searchsorted(times, t, side="right")]

    def comm_mask(self, t0: int, length: int) -> np.ndarray:
        t0, length = int(t0), int(length)
        mask = np.zeros(length, dtype=bool)
        times = self._comm_times_past(t0 + length)
        sel = times[(times > t0) & (times <= t0 + length)]
        mask[sel - t0 - 1] = True
        return mask

    def constant(self, L: float, R: float, lam2: float) -> float:
        return cp_constant(L, R, lam2, self.p)


class PiecewisePeriodic(CommSchedule):
    """Periodic schedule whose interval h can be re-spliced forward in time.

    This is the schedule-mutation protocol the closed-loop controller
    (`repro.adaptive.AdaptiveSchedule`) builds on: the comm pattern is a
    sequence of segments, each a plain `Periodic`-style pattern

        comm steps of segment j:  t = a_j + m * h_j   (m >= 1, s_j < t <= e_j)

    where `s_j` is the segment's start iteration, `e_j` the next segment's
    start (inf for the last), and `a_j` the ANCHOR -- the last communication
    step at or before `s_j` (1 before any communication has happened, so a
    fresh instance with one segment reproduces `Periodic(h)` exactly,
    including the t > 1 rule). Anchoring each splice at the previous comm
    step preserves the "h cheap iterations between communications"
    semantics across an h change instead of resetting the phase.

    Mutation contract (`set_h`):
      * append-only in time: `from_t` must be >= the latest segment start;
        the pattern for iterations <= `from_t` NEVER changes, so answers
        already handed out for past iterations stay valid.
      * re-splicing at the same `from_t` replaces the pending segment.
      * after any sequence of mutations the schedule is still a fixed
        deterministic sequence: `H(t)` is non-decreasing,
        `next_comm_step(t) > t`, and the batch query agrees with the
        scalar path (property-tested in tests/test_adaptive.py).

    All queries are closed-form per segment (no per-iteration scanning):
    `H` and `next_comm_step` cost O(log #segments) and
    `next_comm_step_batch` is pure array arithmetic plus at most one
    segment-advance round per distinct segment touched -- the C_h/C_p
    bookkeeping stays cheap for the vectorized engine's batch queries.
    """

    name: str = "piecewise"

    def __init__(self, h: int = 1):
        if h < 1:
            raise ValueError("h must be >= 1")
        self._h0 = int(h)
        self.reset()

    def reset(self) -> None:
        """Discard every splice and return to the initial single-segment
        pattern -- the 'new run, fresh history' hook (a fixed run's past is
        immutable, but a NEW run starts its own timeline; the controller's
        bind() calls this)."""
        # parallel arrays: segment start, interval, anchor, H(start)
        self._starts = [0]
        self._hs = [self._h0]
        self._anchors = [1]
        self._H0 = [0]

    # -- mutation protocol ---------------------------------------------------

    @property
    def h_current(self) -> int:
        """Interval of the latest segment (the one future splices extend)."""
        return self._hs[-1]

    @property
    def segments(self) -> list[tuple[int, int]]:
        """[(start, h), ...] -- the splice history, for diagnostics."""
        return list(zip(self._starts, self._hs))

    def set_h(self, from_t: int, h: int) -> None:
        """Splice a new interval: iterations > from_t follow `h`.

        `from_t` must be at or beyond the latest existing splice point
        (append-only; the past is immutable). Callers that drive live runs
        pass the node-iteration frontier (max in-flight iteration), so no
        already-made communication decision is ever rewritten.
        """
        from_t, h = int(from_t), int(h)
        if h < 1:
            raise ValueError("h must be >= 1")
        if from_t < self._starts[-1]:
            raise ValueError(
                f"splice at {from_t} is before the latest segment start "
                f"{self._starts[-1]} (mutations are append-only in time)")
        if from_t == self._starts[-1]:
            # replace the pending segment (same start => same anchor/H0)
            self._hs[-1] = h
            return
        if h == self._hs[-1]:
            return  # no-op splice
        j = len(self._starts) - 1
        a, hj = self._anchors[j], self._hs[j]
        anchor = a + hj * ((from_t - a) // hj)  # last comm step <= from_t
        self._starts.append(from_t)
        self._hs.append(h)
        self._anchors.append(anchor)
        self._H0.append(self.H(from_t))

    # -- queries (closed forms per segment) ----------------------------------

    def _seg(self, t: int) -> int:
        """Index of the segment containing iteration t (t > start)."""
        return max(bisect.bisect_left(self._starts, t) - 1, 0)

    def is_comm_step(self, t: int) -> bool:
        if t <= 1:
            return False
        j = self._seg(t)
        a = self._anchors[j]
        return t > a and (t - a) % self._hs[j] == 0

    def H(self, t: int) -> int:
        if t <= 1:
            return 0
        j = self._seg(t)
        s, h, a = self._starts[j], self._hs[j], self._anchors[j]
        return self._H0[j] + (t - a) // h - max(s - a, 0) // h

    def next_comm_step(self, t: int) -> int:
        j = self._seg(max(t, 1))
        while True:
            s, h, a = self._starts[j], self._hs[j], self._anchors[j]
            end = (self._starts[j + 1] if j + 1 < len(self._starts)
                   else None)
            base = max(t, s)
            cand = a + h * max((base - a) // h + 1, 1)
            if end is None or cand <= end:
                return cand
            j += 1

    def comm_mask(self, t0: int, length: int) -> np.ndarray:
        """Vectorized `is_comm_step` over one iteration window: resolve
        every iteration's segment with one searchsorted, then apply each
        segment's anchored modulus -- pure array arithmetic regardless of
        how many splices the controller has appended."""
        t = np.arange(int(t0) + 1, int(t0) + int(length) + 1, dtype=np.int64)
        starts = np.asarray(self._starts, dtype=np.int64)
        hs = np.asarray(self._hs, dtype=np.int64)
        anchors = np.asarray(self._anchors, dtype=np.int64)
        j = np.maximum(np.searchsorted(starts, t, side="left") - 1, 0)
        a = anchors[j]
        return (t > 1) & (t > a) & ((t - a) % hs[j] == 0)

    def next_comm_step_batch(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.int64)
        starts = np.asarray(self._starts, dtype=np.int64)
        hs = np.asarray(self._hs, dtype=np.int64)
        anchors = np.asarray(self._anchors, dtype=np.int64)
        # segment ends; sentinel keeps every candidate in the last segment
        ends = np.concatenate([starts[1:], [np.iinfo(np.int64).max]])
        j = np.maximum(np.searchsorted(starts, np.maximum(t, 1),
                                       side="left") - 1, 0)
        last = len(starts) - 1
        while True:
            a, h = anchors[j], hs[j]
            base = np.maximum(t, starts[j])
            cand = a + h * np.maximum((base - a) // h + 1, 1)
            over = (cand > ends[j]) & (j < last)
            if not over.any():
                return cand
            j = j + over  # advance the overshooting rows one segment

    def constant(self, L: float, R: float, lam2: float) -> float:
        """Convergence constant of the CURRENT interval (eq. 18). A spliced
        run's true constant is segment-dependent; this is the controller's
        working value for the pattern it is emitting now."""
        return ch_constant(L, R, lam2, self.h_current)


def make_schedule(kind: str, *, h: int | None = None,
                  p: float | None = None, **kwargs) -> CommSchedule:
    """Build a schedule by kind -- a thin shim over the
    `repro.experiments.components.schedules` registry.

    The ad-hoc kind branching that used to live here is deprecated: it
    could not construct `PiecewisePeriodic` (or `repro.adaptive`'s
    AdaptiveSchedule), and every new schedule needed an edit in two places.
    Now the registry is the single source of kinds ("every"/"h1",
    "periodic", "sparse", "piecewise", "adaptive", ...). This function only
    preserves the legacy calling convention: callers may pass both `h` and
    `p` and each kind takes what it accepts (`make_schedule("every",
    h=args.h)` stays legal, as the benchmark CLIs rely on), with the
    registry builders' own defaults (h=1, p=0.3) when omitted. Any OTHER
    kwarg is forwarded verbatim, so typos fail loudly. New code should use
    the registry (or an ExperimentSpec schedule component) directly.
    """
    from repro_torch.experiments.components import schedules as _registry
    try:
        name = _registry.canonical(kind)
    except KeyError as e:  # legacy contract: unknown kind is a ValueError
        raise ValueError(str(e)) from None
    legacy = {}
    if h is not None:
        legacy["h"] = h
    if p is not None:
        legacy["p"] = p
    legacy = _registry.accepted(name, legacy)
    return _registry.build(name, **legacy, **kwargs)


# ---------------------------------------------------------------------------
# Convergence-rate leading constants (all with a(t) = A / sqrt(t), optimized A)
# ---------------------------------------------------------------------------

def c1_constant(L: float, R: float, lam2: float) -> float:
    """C_1 = 2LR sqrt(19 + 12/(1 - sqrt(lam2)))  -- eq. (7)."""
    gap = 1.0 - math.sqrt(min(max(lam2, 0.0), 1.0 - 1e-15))
    return 2.0 * L * R * math.sqrt(19.0 + 12.0 / gap)


def ch_constant(L: float, R: float, lam2: float, h: int) -> float:
    """C_h = 2RL sqrt(1 + 18h + 12h/(1 - sqrt(lam2)))  -- eq. (18)."""
    gap = 1.0 - math.sqrt(min(max(lam2, 0.0), 1.0 - 1e-15))
    return 2.0 * R * L * math.sqrt(1.0 + 18.0 * h + 12.0 * h / gap)


def cp_constant(L: float, R: float, lam2: float, p: float) -> float:
    """C_p = 2LR sqrt(7 + (12p+12)/((3p+1)(1-sqrt(lam2))) + 12/(2p+1)) -- eq. (31)."""
    gap = 1.0 - math.sqrt(min(max(lam2, 0.0), 1.0 - 1e-15))
    return 2.0 * L * R * math.sqrt(
        7.0 + (12.0 * p + 12.0) / ((3.0 * p + 1.0) * gap) + 12.0 / (2.0 * p + 1.0)
    )


def optimal_stepsize_A(L: float, R: float, lam2: float, h: int = 1) -> float:
    """A = (R/L) / sqrt(1 + 18h + 12h/(1-sqrt(lam2)))  -- eq. (18)."""
    gap = 1.0 - math.sqrt(min(max(lam2, 0.0), 1.0 - 1e-15))
    return (R / L) / math.sqrt(1.0 + 18.0 * h + 12.0 * h / gap)
