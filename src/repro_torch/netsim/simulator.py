"""Event-driven asynchronous cluster simulator for DDA.

The second execution mode of the port next to `core.dda.DDASimulator`
(dense, synchronous, one device): a discrete-event
simulation of a *cluster* -- heterogeneous node speeds, per-link latency /
bandwidth / jitter / loss, and optionally a time-varying topology -- running
asynchronous stale-gossip DDA or drop-robust push-sum DDA.

Traces come out `SimTrace`-compatible but on a WALL-CLOCK time axis: sim_time
is the event-clock timestamp of each evaluation, not the closed-form
`iters * (1/n + k r)` charge of the dense simulator. That makes the paper's
predictions falsifiable here: `measure_r_empirical()` recovers r from the
observed message flights and step durations exactly as the paper measures it
on its cluster (r = t_msg / t_full_grad), and `predict()` feeds that
empirical r back into `core.tradeoff.h_opt` / `n_opt_complete` /
`time_to_accuracy` for closed-loop prediction-vs-observation checks
(benchmarks/fig_async.py).

Two engines drive the event loop (netsim.engine): the per-node `"object"`
reference and the struct-of-arrays `"vectorized"` fast path, selected by the
`engine` constructor argument. `"auto"` (the default) picks the vectorized
engine -- every scenario the presets can express is compatible with it, and
it is bit-identical to the object engine on seeded runs (the equivalence is
regression-tested, see tests/test_netsim_engine.py) while being orders of
magnitude faster at large n (benchmarks/bench_netsim.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.core import tradeoff as _tradeoff
from repro_torch.core.dda import SimTrace, stepsize_sqrt, trace_time_to_reach
from repro_torch.core.schedules import CommSchedule, EveryIteration
from repro_torch.netsim.engine import ObjectEngine, VectorizedEngine, _EvalBatch, \
    _GradBatch
from repro_torch.netsim.node import AsyncDDANode, GradFn, PushSumDDANode
from repro_torch.netsim.scenarios import Scenario

__all__ = ["NetSimulator", "RMeasurement"]

_ENGINES = ("object", "vectorized", "auto")


@dataclasses.dataclass(frozen=True)
class RMeasurement:
    """Empirical communication/computation tradeoff from an event timeline,
    measured the way the paper measures it on its cluster (section V.A)."""

    r: float                  # t_msg / t_grad_full
    t_msg: float              # mean observed send->receive time per message
    t_grad_full: float        # median local step time * n (full-data grad)
    n_messages: int
    n_steps: int
    drop_rate: float          # fraction of messages lost in flight


class NetSimulator:
    """Drives one scenario to completion on the event clock.

    Args:
      scenario: cluster description (see netsim.scenarios).
      grad_fn: (node_index, x_i, t) -> subgradient of f_i at x_i; t is the
        0-indexed iteration counter, matching DDASimulator's subgrad_fn
        convention. Must return something `np.asarray` accepts (host
        numpy: a torch closure on the card hands back `.cpu()` values).
      eval_fn: x -> scalar F(x) on the full objective. If it also accepts a
        stacked (n, d) batch and returns one scalar per node, trace
        evaluation happens in a single call (probed, verified bitwise).
      a_fn: stepsize a(t); default `core.dda.stepsize_sqrt(1.0)`, the same
        closure the dense simulator defaults to.
      schedule: communication schedule shared by all nodes (local iteration
        counts -- nodes drift apart in wall-clock, not in schedule logic).
      algorithm: "dda" (stale gossip) or "pushsum" (drop-robust ratio
        consensus; required for convergence under heavy loss or directed
        links).
      engine: "object" (per-node reference), "vectorized" (struct-of-arrays
        fast path), or "auto" (vectorized; bit-identical on seeded runs).
      batch_grad_fn: optional batched gradient `(idx, x_stack, t_array) ->
        (b, d)`; e.g. `engine.torch_batch_grad(grad_fn)` for a
        `torch.func.vmap` path. When absent, `grad_fn` itself is probed
        with a stacked batch and used batched only if bitwise-equal to the
        loop.
      controller: optional `repro_torch.adaptive.AdaptiveController` -- closes
        the measure->predict->act loop online: both engines feed it step
        durations and message flights and let it splice a re-solved h into
        its AdaptiveSchedule at the iteration frontier. The controller's
        schedule becomes the run's schedule (passing a different
        `schedule=` too is an error); with `controller=None` the engines
        run their uncontrolled (bit-identical) event loops.
      tracer: optional `repro_torch.obs.Tracer`. With `tracer.detail` set, both
        engines emit per-event sim-time spans (node steps, message
        flights) and instants (drops, rewires, evals) -- purely observing
        the records they already produce, behind the same single-branch
        pattern as the controller hooks, so traced runs stay bit-identical
        to untraced ones. A non-detail (or absent) tracer never enters the
        event loops at all.
      faults: optional `repro_torch.faults.FaultPlan` -- deterministic, seeded
        fault injection (crashes, restarts, joins, leaves, partitions,
        flapping links) executed as first-class simulation events by BOTH
        engines, which stay bit-identical under every plan. Requires
        algorithm="dda". After `run()`, `fault_stats` holds the counters
        (crashes/restarts/downtime_sim/partition_epochs/...).
      pushsum_inject: "plain" (default, textbook y += grad) or "scaled"
        (y += w * grad): under sustained loss the scaled form keeps the
        injected gradient at its true magnitude through the ratio estimate
        instead of amplifying it by 1/w (see PushSumDDANode). Push-sum
        only; opt-in because it changes seeded trajectories.
      compression: optional `repro_torch.compress.Compressor` -- every gossip
        payload is compressed on the sender with error feedback (residuals
        live on the sender; receivers see dequantized/dense-layout
        messages, so the stale-mix code is unchanged) and the network's
        `wire_bytes` is scaled by the compressor's byte model, so
        bandwidth-limited links serialize compressed messages
        proportionally faster. Requires algorithm="dda"; both engines stay
        bit-identical because `compress_np` is a pure function of
        (message, node, stamp). Mutually exclusive with `faults`
        (checkpoint rows do not carry residual state).
    """

    def __init__(self, scenario: Scenario, grad_fn: GradFn,
                 eval_fn: Callable[[np.ndarray], float],
                 a_fn: Callable[[float], float] | None = None,
                 schedule: CommSchedule | None = None,
                 projection: Callable[[np.ndarray], np.ndarray] | None = None,
                 algorithm: str = "dda", seed: int = 0,
                 pushsum_y0: np.ndarray | None = None,
                 pushsum_w_floor: float = 0.5,
                 engine: str = "auto",
                 batch_grad_fn: Callable | None = None,
                 controller=None,
                 tracer=None,
                 faults=None,
                 pushsum_inject: str = "plain",
                 compression=None):
        if algorithm not in ("dda", "pushsum"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if engine not in _ENGINES:
            raise ValueError(f"unknown engine {engine!r} (one of {_ENGINES})")
        if pushsum_inject not in ("plain", "scaled"):
            raise ValueError(f"pushsum_inject must be 'plain' or 'scaled', "
                             f"got {pushsum_inject!r}")
        if pushsum_inject == "scaled" and algorithm != "pushsum":
            raise ValueError("pushsum_inject applies to push-sum only")
        if faults is not None:
            from repro_torch.faults.plan import FaultPlan
            if not isinstance(faults, FaultPlan):
                raise TypeError(f"faults must be a repro_torch.faults.FaultPlan, "
                                f"got {type(faults).__name__}")
            if algorithm != "dda":
                raise ValueError(
                    "fault injection requires algorithm='dda': push-sum's "
                    "cumulative sigma/rho mass counters make crash/restore "
                    "a different protocol (a restored node would replay "
                    "already-sent mass); stale-gossip DDA tolerates a "
                    "reset inbox by folding missing weight into the "
                    "self-loop")
            faults.validate_for(scenario.topology.n)
        if compression is not None:
            from repro_torch.compress import Compressor
            if not isinstance(compression, Compressor):
                raise TypeError(
                    f"compression must be a repro_torch.compress.Compressor, "
                    f"got {type(compression).__name__}")
            if compression.kind == "none":
                compression = None  # normalize: uncompressed runs stay
                # byte-for-byte the seed event loop
            elif algorithm != "dda":
                raise ValueError(
                    "compression requires algorithm='dda': push-sum ships "
                    "cumulative sigma mass counters whose DIFFERENCES carry "
                    "the information -- quantizing the cumulative totals "
                    "breaks the conservation invariant mass recovery "
                    "depends on")
            elif faults is not None:
                raise ValueError(
                    "compression and faults are mutually exclusive: "
                    "checkpoint/restore rows do not carry error-feedback "
                    "residual state, so a restored node would replay "
                    "compression error it already corrected")
        if controller is not None:
            if schedule is not None and schedule is not controller.schedule:
                raise ValueError(
                    "controller and schedule both given but disagree; pass "
                    "the controller's schedule (or neither)")
            if (getattr(controller, "reweight_gossip", False)
                    and algorithm != "dda"):
                raise ValueError(
                    "reweight_gossip applies to the stale-gossip mix only; "
                    "push-sum's mass splitting is its own weighting scheme")
            schedule = controller.schedule
        self.controller = controller
        self.tracer = tracer
        if controller is not None and tracer is not None:
            controller.attach_tracer(tracer)
        self.scenario = scenario
        self.grad_fn = grad_fn
        self.eval_fn = eval_fn
        self.a_fn = a_fn or stepsize_sqrt(1.0)
        self.schedule = schedule or EveryIteration()
        self.projection = projection
        self.algorithm = algorithm
        self.seed = seed
        self.pushsum_y0 = pushsum_y0
        self.pushsum_w_floor = pushsum_w_floor
        self.pushsum_inject = pushsum_inject
        self.faults = faults
        self.fault_stats: dict | None = None
        self.compression = compression
        self.engine = engine
        self.net = scenario.build_network()
        self._engine_inst: ObjectEngine | VectorizedEngine | None = None
        self._nodes_cache: list[AsyncDDANode | PushSumDDANode] | None = []
        # batch-capability probes persist across runs (the probe verdict is a
        # property of grad_fn/eval_fn, not of one run)
        self._grad_batch = _GradBatch(grad_fn, batch_grad_fn)
        self._eval_batch = _EvalBatch(eval_fn)
        # observability: the "profiler trace" measure_r_empirical reads
        self.msg_flights: list[float] = []
        self.compute_times: list[float] = []
        self.drops = 0
        self.sent = 0
        self.rewires = 0
        self.retransmits = 0
        # mean error-feedback residual norm per trace point (compression on)
        self.comp_res_norms: list[float] = []

    # -- lifecycle ----------------------------------------------------------

    def _resolve_engine(self) -> ObjectEngine | VectorizedEngine:
        if self.engine == "object":
            return ObjectEngine(self)
        # "vectorized" and "auto": every scenario the presets express is
        # vectorizable (jitter and per-edge link overrides fall back to
        # exact per-message sampling inside the engine)
        return VectorizedEngine(self)

    # -- main loop ----------------------------------------------------------

    def run(self, x0_stack: np.ndarray, T: int,
            eval_every: int = 25, time_limit: float = math.inf) -> SimTrace:
        """Run every node for T iterations (or until time_limit); returns a
        SimTrace whose sim_time axis is the event clock."""
        x0_stack = np.asarray(x0_stack, dtype=np.float64)
        n = self.net.n
        if x0_stack.shape[0] != n:
            raise ValueError(f"x0 must be stacked ({n}, ...)")
        # compression shrinks what crosses the wire: links keep their
        # calibrated bandwidth (bw = message_bytes / r) but serialize
        # wire_ratio(d) of the bytes, so r_effective = r * c on
        # bandwidth-limited links (and measure_r_empirical sees it)
        d = int(np.prod(x0_stack.shape[1:]))
        self.net.wire_bytes = self.net.message_bytes * (
            1.0 if self.compression is None
            else self.compression.wire_ratio(d))
        eng = self._resolve_engine()
        self._engine_inst = eng
        trace = eng.run(x0_stack, T, eval_every, time_limit)
        # mirror the engine's observability into the accumulating lists the
        # public API (and measure_r_empirical) reads
        self.msg_flights.extend(eng.msg_flights)
        self.compute_times.extend(eng.compute_times)
        self.drops += eng.drops
        self.sent += eng.sent
        self.rewires += eng.rewires
        self.retransmits += eng.retransmits
        self.comp_res_norms.extend(eng.comp_res_norms)
        if eng._fr is not None:
            self.fault_stats = eng._fr.stats()
        self._nodes_cache = None  # re-materialize lazily from the new state
        return trace

    @property
    def nodes(self) -> list[AsyncDDANode | PushSumDDANode]:
        """Per-node views of the final state. For the object engine these
        ARE the simulation's nodes; the vectorized engine materializes
        equivalent objects from its struct-of-arrays state on first access
        (so a 1000-node run that never inspects them pays nothing)."""
        if self._nodes_cache is None:
            self._nodes_cache = self._engine_inst.materialize_nodes()
        return self._nodes_cache

    # -- closed-loop measurement --------------------------------------------

    def measure_r_empirical(self) -> RMeasurement:
        """Recover r from the observed event timeline, as the paper does on
        its cluster: mean message send->receive time over the median node's
        full-data gradient time (median is robust to stragglers)."""
        if not self.msg_flights or not self.compute_times:
            raise ValueError("run() first (needs observed messages and steps)")
        t_msg = float(np.mean(self.msg_flights))
        t_full = float(np.median(self.compute_times)) * self.net.n
        return RMeasurement(
            r=_tradeoff.measure_r(t_msg, t_full),
            t_msg=t_msg,
            t_grad_full=t_full,
            n_messages=len(self.msg_flights),
            n_steps=len(self.compute_times),
            drop_rate=self.drops / max(self.sent, 1))

    def predict(self, eps: float, L: float = 1.0, R: float = 1.0) -> dict:
        """Closed-loop paper predictions from the EMPIRICAL r: optimal
        cluster size (eq. 11), optimal communication interval (eq. 21) and
        tau(eps) (eq. 10/20/30) for this topology + schedule."""
        m = self.measure_r_empirical()
        g = self.net.graph
        lam2 = g.lambda2()
        return {
            "r_empirical": m.r,
            "n_opt": _tradeoff.n_opt_complete(m.r),
            "h_opt": _tradeoff.h_opt_int(g.n, g.degree, m.r, lam2),
            "tau_eps": _tradeoff.time_to_accuracy(
                eps, g.n, g.degree, m.r, lam2, L, R, self.schedule),
            "measurement": m,
        }

    def time_to_reach(self, trace: SimTrace, eps_value: float,
                      use_consensus: bool = False) -> float:
        """Same contract as DDASimulator.time_to_reach, on the event clock."""
        return trace_time_to_reach(trace, eps_value, use_consensus)
