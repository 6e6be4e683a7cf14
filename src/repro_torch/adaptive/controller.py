"""The closed loop: measure (RTracker) -> predict (h_opt, lambda2) -> act
(AdaptiveSchedule splice), plus straggler-aware mixing-weight refresh.

`AdaptiveController` is the object a `NetSimulator(controller=...)` run
threads through both execution engines. The engines call four hooks --
`on_steps`, `on_messages`, `on_rewire`, `maybe_retune` -- and otherwise run
their normal event loops; with no controller attached not a single extra
branch executes on the hot path, which is what keeps the controller-off
bit-identity guarantee intact (benchmarks/fig_adaptive.py --smoke gates it).

`StragglerReweighter` keeps the controller's spectral input honest: the
static lambda2 of the configured graph assumes every neighbor's message
lands every round, but observed per-node step-time quantiles say otherwise
on a straggler-ridden cluster. It folds on-time arrival probabilities into
P exactly as `runtime.fault_tolerance.arrival_reweighted_matrix` (the
expected deadline-degraded matrix over Bernoulli arrivals), re-validates
double stochasticity via `sinkhorn_project` (which raises rather than
return a near-miss), and hands back `lambda2_fast` of the rebalanced
matrix -- the effective mixing rate h_opt should be solved against.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.adaptive.rtracker import RTracker
from repro_torch.adaptive.schedule import AdaptiveSchedule
from repro_torch.core.graphs import CommGraph
from repro_torch.core.tradeoff import lambda2_fast
from repro_torch.runtime.fault_tolerance import (arrival_reweighted_matrix,
                                                 sinkhorn_project)

__all__ = ["AdaptiveController", "DenseController", "StragglerReweighter"]


class StragglerReweighter:
    """Fold observed per-node step-time quantiles into the mixing matrix.

    Args:
      deadline_factor: a message is modeled on-time when its sender's step
        time is within `deadline_factor` times the cluster median (the
        reference's `fault_tolerance.StragglerModel.deadline` convention).
      floor: lower clamp on arrival probability, keeping the reweighted
        matrix irreducible even for an extreme straggler.
    """

    def __init__(self, graph: CommGraph, deadline_factor: float = 2.0,
                 floor: float = 0.05, cache_rtol: float = 1e-3):
        if deadline_factor <= 0.0:
            raise ValueError("deadline_factor must be positive")
        if not 0.0 < floor <= 1.0:
            raise ValueError("floor must be in (0, 1]")
        self.deadline_factor = deadline_factor
        self.floor = floor
        # skip the (Sinkhorn + eigendecomposition) refresh when the step
        # means moved less than this relative amount since the last update
        # -- EW means go stationary once the cluster's speeds are learned,
        # and a sub-0.1% shift cannot move lambda2 meaningfully. 0 disables.
        self.cache_rtol = cache_rtol
        self.set_graph(graph)
        self.last_P: np.ndarray | None = None
        self.last_lam2: float | None = None
        self.last_arrive_prob: np.ndarray | None = None

    def set_graph(self, graph: CommGraph) -> None:
        self.graph = graph
        self._P0 = graph.mixing_matrix()
        self._cached_q: np.ndarray | None = None  # topology changed

    def update(self, step_means: np.ndarray) -> tuple[np.ndarray, float]:
        """(effective P, its lambda2) from per-node EW step-time means.

        Nodes not yet observed (NaN) count as median-speed. The arrival
        model: node j's message lands on time with probability
        min(1, deadline / step_time_j), deadline = factor * median -- a 4x
        straggler under factor 2 is heard half the time.
        """
        q = np.asarray(step_means, dtype=np.float64)
        if q.shape != (self._P0.shape[0],):
            raise ValueError(
                f"need one step-time mean per node ({self._P0.shape[0]}), "
                f"got shape {q.shape}")
        if (self._cached_q is not None
                and np.allclose(q, self._cached_q, rtol=self.cache_rtol,
                                atol=0.0, equal_nan=True)):
            return self.last_P, self.last_lam2
        self._cached_q = q.copy()
        med = float(np.nanmedian(q))
        if math.isnan(med) or med <= 0.0:
            lam2 = lambda2_fast(self._P0)
            self.last_P, self.last_lam2 = self._P0, lam2
            self.last_arrive_prob = np.ones(len(q))
            return self._P0, lam2
        deadline = self.deadline_factor * med
        with np.errstate(invalid="ignore", divide="ignore"):
            a = deadline / q
        a = np.clip(np.where(np.isnan(a), 1.0, a), self.floor, 1.0)
        P_eff = sinkhorn_project(arrival_reweighted_matrix(self._P0, a))
        lam2 = lambda2_fast(P_eff)
        self.last_P, self.last_lam2, self.last_arrive_prob = P_eff, lam2, a
        return P_eff, lam2


class AdaptiveController:
    """Online h controller for netsim runs.

    Args:
      schedule: the AdaptiveSchedule the run shares (also pass it -- or let
        NetSimulator pick it up -- as the run's schedule).
      update_every: sim-time between retunes (event-clock units; eq. (9)
        normalization, so 1.0 = one full-data gradient on the reference
        node).
      halflife: RTracker EW window, in observations.
      r0: prior for r before the first messages land (None = wait).
      reweight: refresh lambda2 via StragglerReweighter each retune; when
        False the configured graph's static lambda2 is used.
      warmup_messages / warmup_steps: minimum observations before the first
        retune -- an h spliced off two noisy flights would thrash.
      wire_ratio: bytes-on-wire compression ratio c applied to the measured
        r_hat before each retune (h solved against the EFFECTIVE r*c, eq.
        21). Default 1.0 is correct for netsim runs with compression on:
        the observed flights already serialize `wire_bytes`, so r_hat IS
        the effective tradeoff. Set it explicitly (Compressor.wire_ratio)
        when the r feed is a raw/uncompressed measurement -- the dense
        backend's wall-clock tracker, or a netsim whose link calibration
        ignores wire_bytes.
    """

    def __init__(self, schedule: AdaptiveSchedule | None = None,
                 update_every: float = 0.5, halflife: float = 64.0,
                 r0: float | None = None, reweight: bool = True,
                 warmup_messages: int = 8, warmup_steps: int = 8,
                 reweight_gossip: bool = False,
                 wire_ratio: float = 1.0):
        self.schedule = schedule if schedule is not None else AdaptiveSchedule()
        if not isinstance(self.schedule, AdaptiveSchedule):
            raise TypeError("AdaptiveController needs an AdaptiveSchedule")
        if update_every <= 0.0:
            raise ValueError("update_every must be positive")
        if reweight_gossip and not reweight:
            raise ValueError("reweight_gossip needs reweight=True (the "
                             "effective P comes from the StragglerReweighter)")
        self.update_every = update_every
        self.halflife = halflife
        self.r0 = r0
        self.reweight = reweight
        # Apply the reweighter's effective P to the ACTUAL stale-gossip
        # mixing (Network.mix_weights), not just to the lambda2 estimate
        # h_opt is solved against. Stale-gossip DDA only: push-sum's mass
        # splitting is its own weighting scheme (NetSimulator validates).
        self.reweight_gossip = reweight_gossip
        if wire_ratio <= 0.0:
            raise ValueError("wire_ratio must be positive")
        self.wire_ratio = wire_ratio
        self.warmup_messages = warmup_messages
        self.warmup_steps = warmup_steps
        self.tracker: RTracker | None = None
        self.reweighter: StragglerReweighter | None = None
        # observability: every r_hat the controller computed at retune
        # cadence, as (event-clock time, r_hat) -- the durable record the
        # RunMetrics r_hat_trajectory is built from. `tracer` (an optional
        # repro_torch.obs.Tracer, set via attach_tracer) additionally receives
        # the series and a retune counter; None costs nothing.
        self.r_hat_history: list[tuple[float, float]] = []
        self.tracer = None
        # single-slot (graph, lam2) cache: only the CURRENT graph can hit,
        # and holding the object rules out a recycled-id stale hit
        self._lam2_cache: tuple[CommGraph, float] | None = None
        self._next_update = update_every
        self._n = 0
        self._k = 0
        # fault-injection membership: when a FaultRuntime splices a reduced
        # graph in (node left/joined), this holds the int64 array of member
        # node ids and the controller retunes against the SUB-cluster
        # (n = len(members), lambda2 of the sub-graph) -- the embedded
        # full-size graph's self-loops would poison the spectral gap.
        self._members: np.ndarray | None = None

    # -- engine-facing hooks -------------------------------------------------

    def bind(self, net) -> None:
        """Attach to a Network at run start (re-binding resets the window
        AND the schedule's splice history: a new run is a new cluster and a
        new iteration timeline as far as the controller is concerned)."""
        self._n = net.n
        self._k = net.graph.degree
        self.r_hat_history = []
        self.tracker = RTracker(net.n, halflife=self.halflife, r0=self.r0,
                                tracer=self.tracer)
        self.reweighter = (StragglerReweighter(net.graph)
                           if self.reweight else None)
        self._lam2_cache = None
        self._graph = net.graph
        self._net = net
        self._members = None
        if self.reweight_gossip:
            net.mix_weights = None  # fresh run: no weights learned yet
        self._next_update = self.update_every
        self.schedule.reset()

    def on_steps(self, nodes: np.ndarray, durations: np.ndarray) -> None:
        self.tracker.observe_steps(nodes, durations)

    def on_messages(self, flights: np.ndarray) -> None:
        self.tracker.observe_messages(flights)

    def on_rewire(self, graph: CommGraph) -> None:
        if self._members is not None:
            # membership changed since bind: the scheduled rewire delivers
            # the PRE-fault full-size graph, which no longer describes the
            # live cluster. The FaultRuntime's spliced graph (delivered via
            # on_membership) stays authoritative until the next splice.
            return
        self._graph = graph
        self._k = graph.degree
        if self.reweighter is not None:
            self.reweighter.set_graph(graph)
        if self.reweight_gossip:
            # the learned P refers to the OLD edge set; fall back to the
            # configured uniform weights until the next retune relearns it
            self._net.mix_weights = None

    def on_membership(self, sub_graph: CommGraph,
                      members: np.ndarray) -> None:
        """A FaultRuntime spliced a rebuilt graph after a join/leave.

        `sub_graph` is the graph over the m CURRENT members (NOT embedded
        into full size: the identity self-loops the embedding adds for
        departed nodes would drive the estimated lambda2 toward 1 and
        poison h_opt), `members` the sorted full-cluster ids those m rows
        map to. From here on the controller solves the tradeoff for the
        m-node cluster; per-node step statistics are sliced down to the
        members at retune time so a departed straggler stops dragging the
        reweighter."""
        self._members = np.asarray(members, dtype=np.int64)
        self._n = int(sub_graph.n)
        self._k = max(sub_graph.degree, 1)
        self._graph = sub_graph
        self._lam2_cache = None
        if self.reweighter is not None:
            self.reweighter = StragglerReweighter(sub_graph)
        if self.reweight_gossip:
            self._net.mix_weights = None

    def on_partition_heal(self, now: float) -> None:
        """A link partition healed: the measured r/step statistics from the
        partition era are stale for the rejoined cluster, so pull the next
        retune forward to `now` instead of waiting out the cadence."""
        self._next_update = min(self._next_update, float(now))

    def retune_due(self, now: float) -> bool:
        """Cheap cadence test so engines only compute the (O(n)) iteration
        frontier when a retune will actually be attempted."""
        return now >= self._next_update

    def maybe_retune(self, now: float, frontier: int) -> int | None:
        """Run the predict->act half if the cadence is due.

        `frontier` is the max in-flight iteration across STILL-ACTIVE
        nodes. That is exactly the bound correctness needs: no splice ever
        rewrites an iteration an active node has executed or in flight, so
        cached next-comm answers and already-charged busy times stay valid
        (engines refresh the rest). It is deliberately NOT the global max:
        a finished node that ran ahead no longer constrains the future,
        and using its T would freeze the controller for the stragglers'
        entire remaining run. The flip side, accepted and documented: once
        iteration ranges diverge (a fast node finished under the old
        pattern), a later splice inside that range makes the schedule
        forward-looking for the nodes still running -- the finished node's
        actual communication history lives in its own `comm_iters`/trace
        counters, not in post-hoc `schedule.H` queries. If the frontier
        sits at or behind the latest splice point, the retune is skipped
        (re-splicing there would also disturb the pattern ACTIVE nodes are
        mid-way through) and resumes once the frontier catches up.

        Returns the splice point when the emitted pattern changed (the
        engine must then refresh cached next-comm answers beyond it), else
        None.
        """
        if now < self._next_update:
            return None
        # advance the cadence even on a failed warmup: retune_due must go
        # cheap-and-false again, or the engines would pay their O(n)
        # frontier scan on EVERY step event for the whole warmup stretch
        self._next_update = now + self.update_every
        if not self.tracker.ready(self.warmup_messages, self.warmup_steps):
            return None
        r_hat = self.tracker.r_hat
        if r_hat is None:
            return None
        # record the measurement even when the splice below is skipped: the
        # trajectory is what the controller OBSERVED, not what it acted on
        self.r_hat_history.append((float(now), float(r_hat)))
        if self.tracer is not None:
            self.tracer.record_series("r_hat", float(now), float(r_hat))
        cut = int(frontier)
        # '<=': a cut EQUAL to the latest splice start would take set_h's
        # replace-pending branch, which also rewrites (start, inf) -- and a
        # since-finished node may have executed iterations there
        if cut <= self.schedule.segments[-1][0]:
            return None  # see docstring: wait for the frontier to catch up
        if self.reweighter is not None:
            means = self.tracker.step_means
            if self._members is not None:
                means = means[self._members]
            P_eff, lam2 = self.reweighter.update(means)
            if self.reweight_gossip:
                if self._members is not None:
                    # lift the m x m effective P back to full size; departed
                    # nodes keep identity rows (they hold no gossip edges)
                    full = np.eye(self._net.n)
                    full[np.ix_(self._members, self._members)] = P_eff
                    self._net.mix_weights = full
                else:
                    self._net.mix_weights = P_eff
        else:
            lam2 = self._static_lam2()
        # history records what was OBSERVED (raw r_hat); the act half solves
        # against the effective per-message cost r_hat * wire_ratio
        changed = self.schedule.retune(cut, self._n, self._k,
                                       r_hat * self.wire_ratio, lam2)
        if changed and self.tracer is not None:
            self.tracer.count("retunes")
            self.tracer.add_instant("retune", float(now), track="controller",
                                    h=self.schedule.h_current, r_hat=r_hat)
        return cut if changed else None

    def attach_tracer(self, tracer) -> None:
        """Attach a repro_torch.obs.Tracer; propagated to the RTracker at the
        next bind() (call before the run starts)."""
        self.tracer = tracer
        if self.tracker is not None:
            self.tracker.tracer = tracer

    def _static_lam2(self) -> float:
        hit = self._lam2_cache
        if hit is None or hit[0] is not self._graph:
            hit = (self._graph, self._graph.lambda2())
            self._lam2_cache = hit
        return hit[1]


class DenseController:
    """Wall-clock twin of `AdaptiveController` for the dense synchronous
    mode (`DDASimulator`'s run program, timed a chunk at a time).

    The dense mode has no event timeline -- only whole-iteration wall-clock
    durations -- so the measure half is `DenseRTracker` (inverts the eq. 9
    cost model from comm vs plain iteration timings) and there is no
    straggler reweighting (every node IS the same host). The act half is the
    same `AdaptiveSchedule` splice protocol; the driver
    (`repro_torch.experiments.runner`, dense backend) times uniform-comm chunks,
    feeds `observe`, and calls `maybe_retune(frontier)` at trace-segment
    boundaries, where `frontier` is the number of iterations already
    executed -- the synchronous analogue of the netsim's in-flight frontier.

    Args:
      schedule: the AdaptiveSchedule the run shares.
      halflife: DenseRTracker EW window, in observed iterations.
      retune_every: minimum iterations between accepted retunes (None =
        retune whenever the driver asks).
      warmup_comm / warmup_plain: minimum timed iterations of each kind
        before the first retune (one noisy first-use segment would
        otherwise set h). warmup_plain defaults to 1 because an h0 = 1
        cold start has exactly ONE plain iteration (t = 1) until the first
        retune raises h -- a larger default would deadlock the loop.
      wire_ratio: compression byte ratio c applied to the measured r_hat
        before each retune. Unlike the netsim controller, the dense
        tracker's r_hat comes from wall-clock iteration timings that do
        NOT shrink with compression (the dense simulator computes full
        vectors either way), so a compressed dense run SHOULD pass its
        compressor's `wire_ratio(d)` here for h to land on the effective
        r*c optimum.
    """

    def __init__(self, schedule: AdaptiveSchedule | None = None,
                 halflife: float = 32.0, retune_every: int | None = None,
                 warmup_comm: int = 2, warmup_plain: int = 1,
                 wire_ratio: float = 1.0):
        self.schedule = schedule if schedule is not None else AdaptiveSchedule()
        if not isinstance(self.schedule, AdaptiveSchedule):
            raise TypeError("DenseController needs an AdaptiveSchedule")
        if retune_every is not None and retune_every < 1:
            raise ValueError("retune_every must be >= 1")
        self.halflife = halflife
        self.retune_every = retune_every
        self.warmup_comm = warmup_comm
        self.warmup_plain = warmup_plain
        if wire_ratio <= 0.0:
            raise ValueError("wire_ratio must be positive")
        self.wire_ratio = wire_ratio
        self.tracker = None
        self._lam2 = 0.0
        self._n = 0
        self._k = 0
        self._last_retune_t = 0
        # same observability contract as AdaptiveController: (frontier
        # iteration, r_hat) per computed estimate, optional obs.Tracer
        self.r_hat_history: list[tuple[float, float]] = []
        self.tracer = None

    def bind(self, n: int, k: int, lam2: float) -> None:
        """Attach to a run's graph; resets the window and splice history."""
        from repro_torch.adaptive.rtracker import DenseRTracker
        self._n, self._k, self._lam2 = n, max(k, 1), float(lam2)
        self.tracker = DenseRTracker(n, max(k, 1), halflife=self.halflife)
        self._last_retune_t = 0
        self.r_hat_history = []
        self.schedule.reset()

    def observe(self, wall_seconds: float, was_comm: bool) -> None:
        self.tracker.observe_iteration(wall_seconds, was_comm)

    def maybe_retune(self, frontier: int) -> bool:
        """Re-solve h_opt from the streamed wall-clock r_hat and splice at
        `frontier` (iterations already executed; the splice only shapes the
        future). Returns True when the emitted pattern changed."""
        if (self.tracker is None
                or self.tracker.n_comm < self.warmup_comm
                or self.tracker.n_plain < self.warmup_plain):
            return False
        if (self.retune_every is not None
                and frontier - self._last_retune_t < self.retune_every):
            return False
        r_hat = self.tracker.r_hat
        if r_hat is None:
            return False
        self.r_hat_history.append((float(frontier), float(r_hat)))
        if self.tracer is not None:
            self.tracer.record_series("r_hat", float(frontier), float(r_hat))
        cut = int(frontier)
        if cut <= self.schedule.segments[-1][0]:
            return False  # same append-only guard as the netsim controller
        changed = self.schedule.retune(cut, self._n, self._k,
                                       r_hat * self.wire_ratio, self._lam2)
        if changed:
            self._last_retune_t = cut
            if self.tracer is not None:
                self.tracer.count("retunes")
                self.tracer.add_instant("retune", float(cut),
                                        track="controller",
                                        h=self.schedule.h_current,
                                        r_hat=r_hat)
        return changed

    def attach_tracer(self, tracer) -> None:
        """Attach a repro_torch.obs.Tracer (DenseRTracker has no per-event feed;
        the series/counters come from this controller itself)."""
        self.tracer = tracer
