"""Execution engines for the event-driven cluster simulator.

Two backends drive the same simulation behind `NetSimulator`:

  * `ObjectEngine`     -- the reference: one Python `AsyncDDANode` /
    `PushSumDDANode` object per node, one event per message. Simple,
    obviously correct, and O(interpreter) per event -- fine up to ~100
    nodes, hopeless at 1000.

  * `VectorizedEngine` -- the fast path: all node state lives in
    struct-of-arrays form (stacked (n, d) arrays for z/x/xhat, an (n, n)
    latest-stamp matrix plus growable per-edge value pools for the
    stale-gossip inboxes, per-edge cumulative sigma/rho mass pools for
    push-sum), events are BATCH entries (one queue entry per set of node
    steps or message arrivals sharing a timestamp), and every update is
    applied to the whole due batch with vectorized numpy. Message payloads
    are index stamps into shared snapshot buffers -- no per-message numpy
    copy ever happens.

Equivalence contract
--------------------
On the same seeded scenario the two engines produce BIT-IDENTICAL traces
(`SimTrace` and `measure_r_empirical`), not merely statistically equivalent
ones. That works because every vectorized operation is arranged to perform
the exact same float64 operations in the exact same order as the per-node
loop:

  * the drop/jitter RNG is consumed in the object engine's event order
    (numpy `Generator` block draws are stream-identical to scalar draws);
  * batched stale mixing accumulates in-neighbor slots in slot order via
    `core.consensus.stale_combine_batch`, folding undelivered neighbors'
    weight into the self weight per row exactly like the object node;
  * the stepsize is evaluated once per distinct iteration counter with the
    same scalar call the object node makes, then scattered to the batch;
  * `np.add.at` applies push-sum mass deltas unbuffered in event order.

The engines' message and step-reschedule queue insertions interleave
differently (per node vs whole-batch), but the event clock's
(time, prio, seq) total order makes that unobservable: in-flight arrivals
rank ahead of other events at their exact (strictly future) timestamp, so
even a constructed latency == busy float tie pops identically under both
engines (netsim.events; regression-tested with an exact tie in
tests/test_netsim_engine.py). Everything else -- loss, stragglers,
rewiring, partial batches, mid-batch trace records -- is exact.

Closed-loop control
-------------------
Both engines thread an optional `repro_torch.adaptive.AdaptiveController`
(`NetSimulator(controller=...)`) through the loop: step durations and kept
message flights feed its RTracker, rewires refresh its reweighter, and
after each step event `maybe_retune` may splice a new interval into the
shared AdaptiveSchedule at the ACTIVE-node iteration frontier. A splice
invalidates cached `next_comm` answers beyond the splice point, so the
engine refreshes exactly those from the mutated schedule; active nodes'
in-flight iterations are always at or before the frontier, so no
already-charged busy time or already-made communication decision is
rewritten. (A node that already FINISHED may have run ahead of a later
splice -- its executed history is recorded in its own counters and is
deliberately not what post-hoc schedule queries describe; see
AdaptiveController.maybe_retune.) With `controller=None` none of these
branches run and the engines remain bit-identical to their uncontrolled
behavior.

Gradient / objective batching
-----------------------------
`grad_fn(i, x_i, t)` is a per-node callable by contract. The vectorized
engine PROBES it once with a stacked batch `(idx_array, x_batch, t_array)`
and keeps the batched call only if the result is bitwise identical to the
per-node loop on that batch; otherwise it falls back to the loop forever.
Callers with a gradient written in torch ops can skip the probe and hand
`NetSimulator(batch_grad_fn=torch_batch_grad(fn))` a `torch.func.vmap`
wrapper, on the card or the CPU. `eval_fn` is probed the same way at the
first trace record, so trace evaluation stops dominating
small-`eval_every` runs.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable

import numpy as np

from repro_torch.core.consensus import stale_combine_batch
from repro_torch.core.dda import SimTrace
from repro_torch.netsim.events import EventQueue
from repro_torch.netsim.node import AsyncDDANode, PushSumDDANode

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.netsim.simulator import NetSimulator

__all__ = ["ObjectEngine", "VectorizedEngine", "torch_batch_grad"]


def torch_batch_grad(grad_fn: Callable, device=None) -> Callable:
    """Wrap a per-node `grad_fn(i, x_i, t)` written in torch ops (tensors
    in, a tensor out) into the batched convention `(idx_array, x_batch,
    t_array) -> (b, d) ndarray` via `torch.func.vmap`, computed on `device`
    (None: the CUDA card, as every entry point of the port). Pass the
    result as `NetSimulator(batch_grad_fn=...)`. x is cast to float32, the
    dtype the reference's jax twin computes in with x64 off, so this path
    trades the bit-identical guarantee for speed. The gradients come back
    as host float64 numpy, which the engines consume.
    """
    import torch

    from repro_torch import resolve_device

    dev = resolve_device(device)
    f = torch.func.vmap(grad_fn, in_dims=(0, 0, 0))

    def batched(idx: np.ndarray, x: np.ndarray, t: np.ndarray) -> np.ndarray:
        g = f(torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                              device=dev),
              torch.as_tensor(np.asarray(x), dtype=torch.float32,
                              device=dev),
              torch.as_tensor(np.asarray(t), device=dev))
        return g.detach().cpu().numpy().astype(np.float64)

    return batched


# ---------------------------------------------------------------------------
# batch-capability probes (shared by both engines via NetSimulator)
# ---------------------------------------------------------------------------


class _GradBatch:
    """Resolves per-node vs batched gradient evaluation.

    Modes: "explicit" (caller-supplied batch_grad_fn), "batch" (probe found
    grad_fn itself batchable, verified bitwise), "loop" (per-node calls).
    """

    def __init__(self, grad_fn: Callable, batch_grad_fn: Callable | None):
        self.grad_fn = grad_fn
        self.batch_grad_fn = batch_grad_fn
        self.mode: str | None = "explicit" if batch_grad_fn is not None else None

    def _loop(self, idx: np.ndarray, x: np.ndarray, t: np.ndarray) -> np.ndarray:
        return np.stack([
            np.asarray(self.grad_fn(int(idx[j]), x[j], int(t[j])),
                       dtype=np.float64)
            for j in range(len(idx))])

    def __call__(self, idx: np.ndarray, x: np.ndarray, t: np.ndarray) -> np.ndarray:
        if self.mode == "explicit":
            return np.asarray(self.batch_grad_fn(idx, x, t), dtype=np.float64)
        if self.mode == "loop":
            return self._loop(idx, x, t)
        per = self._loop(idx, x, t)
        # probe once, keep batch only if bit-identical -- and only on a
        # batch of >= 2, since a scalar-style callable can accidentally
        # survive a size-1 probe (e.g. `if t > 0` is valid on a 1-element
        # array) and then crash on the first real batch
        if self.mode is None and len(idx) >= 2:
            try:
                batch = np.asarray(self.grad_fn(idx, x, t), dtype=np.float64)
                ok = batch.shape == per.shape and np.array_equal(batch, per)
            except Exception:
                ok = False
            self.mode = "batch" if ok else "loop"
        return per

    def batch_or_loop(self, idx, x, t):
        if self.mode == "batch":
            return np.asarray(self.grad_fn(idx, x, t), dtype=np.float64)
        return self(idx, x, t)


class _EvalBatch:
    """Probe whether eval_fn accepts a stacked (n, d) batch and returns one
    scalar per node; keep the batched call only if it reproduces the
    per-node loop bitwise on the probe batch."""

    def __init__(self, eval_fn: Callable[[np.ndarray], float]):
        self.eval_fn = eval_fn
        self.mode: str | None = None

    def mean(self, xhat_stack: np.ndarray) -> float:
        n = xhat_stack.shape[0]
        if self.mode == "batch":
            return float(np.mean(np.asarray(self.eval_fn(xhat_stack))))
        per = [self.eval_fn(x) for x in xhat_stack]
        if self.mode is None and n >= 2:  # see _GradBatch: size-1 probes lie
            try:
                batch = np.asarray(self.eval_fn(xhat_stack))
                ok = (batch.shape == (n,)
                      and all(float(batch[j]) == float(per[j])
                              for j in range(n)))
            except Exception:
                ok = False
            self.mode = "batch" if ok else "loop"
        return float(np.mean(per))


class _RowBatch:
    """Same probe for a row-wise map (projection): batch if bitwise equal."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self.fn = fn
        self.mode: str | None = None

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        if self.mode == "batch":
            return np.asarray(self.fn(rows), dtype=np.float64)
        per = np.stack([np.asarray(self.fn(r), dtype=np.float64)
                        for r in rows])
        if self.mode is None and len(rows) >= 2:  # see _GradBatch: a size-1
            try:                                  # probe can lie
                batch = np.asarray(self.fn(rows), dtype=np.float64)
                ok = batch.shape == per.shape and np.array_equal(batch, per)
            except Exception:
                ok = False
            self.mode = "batch" if ok else "loop"
        return per


def _record_stacks(sim: "NetSimulator", trace: SimTrace, now: float,
                   total_steps: int, n: int, xhat: np.ndarray, z: np.ndarray,
                   comm_total: int, mask: np.ndarray | None = None) -> None:
    """Shared trace-point writer; both engines feed it stacked state.

    `mask` (fault injection only) restricts the objective / disagreement
    statistics to live member rows -- a crashed node's frozen iterate must
    not be averaged into the trace point. `iters` stays normalized by the
    full n so fault-free and faulted traces share an x-axis."""
    if mask is not None:
        xhat = xhat[mask]
        z = z[mask]
    zbar = z.mean(axis=0, keepdims=True)
    diff = (z - zbar).reshape(len(z), -1)
    trace.iters.append(total_steps // n)
    trace.sim_time.append(float(now))
    trace.fvals.append(sim._eval_batch.mean(xhat))
    trace.fvals_consensus.append(float(sim.eval_fn(xhat.mean(axis=0))))
    trace.comms.append(int(comm_total // n))
    trace.disagreement.append(float(np.linalg.norm(diff, axis=-1).max()))


# ---------------------------------------------------------------------------
# object engine (reference)
# ---------------------------------------------------------------------------


class ObjectEngine:
    """Per-node reference engine: one Python object per node, one event per
    message, a heapq event clock: the original per-node event loop."""

    name = "object"

    def __init__(self, sim: "NetSimulator"):
        self.sim = sim
        self.net = sim.net
        self.nodes: list[AsyncDDANode | PushSumDDANode] = []
        self.msg_flights: list[float] = []
        self.compute_times: list[float] = []
        self.drops = 0
        self.sent = 0
        self.rewires = 0
        self.retransmits = 0
        # mean per-node error-feedback residual norm at each trace point
        # (empty when sim.compression is None)
        self.comp_res_norms: list[float] = []
        self._fr = None  # FaultRuntime when sim.faults is set
        # detail tracing resolves to one pre-computed local, so the hot
        # path carries exactly one `if tr is not None` branch per event
        # kind (the controller-hook pattern); a non-detail tracer is
        # equivalent to none at all here.
        tracer = getattr(sim, "tracer", None)
        self._tr = tracer if (tracer is not None and tracer.detail) else None

    def _make_nodes(self, x0_stack: np.ndarray) -> None:
        sim = self.sim
        self.nodes = []
        for i in range(self.net.n):
            if sim.algorithm == "pushsum":
                y0 = None if sim.pushsum_y0 is None else sim.pushsum_y0[i]
                node = PushSumDDANode(i, x0_stack[i], sim.grad_fn, sim.a_fn,
                                      sim.schedule, sim.projection, y0=y0,
                                      w_floor=sim.pushsum_w_floor,
                                      inject=sim.pushsum_inject)
            else:
                node = AsyncDDANode(i, x0_stack[i], sim.grad_fn, sim.a_fn,
                                    sim.schedule, sim.projection,
                                    compression=sim.compression)
            self.nodes.append(node)

    def _step_busy(self, i: int) -> float:
        """Wall-clock the node is occupied by its NEXT iteration: local
        gradient plus (on communication iterations) serializing k messages
        out the NIC -- eq. (9)'s 1/n + k*r, per node, per link model."""
        node = self.nodes[i]
        busy = self.net.local_step_time(i)
        if node.is_comm_next():
            busy += self.net.send_busy_time(i)
        return busy

    def run(self, x0_stack: np.ndarray, T: int, eval_every: int,
            time_limit: float) -> SimTrace:
        sim, net = self.sim, self.net
        n = net.n
        ctrl = sim.controller
        if ctrl is not None:
            ctrl.bind(net)  # resets the schedule's splice history, so it
            # must run BEFORE nodes cache their next_comm answers
        self._make_nodes(x0_stack)
        flt = None
        if sim.faults is not None:
            from repro_torch.faults.runtime import FaultRuntime
            flt = FaultRuntime(sim.faults, n, tracer=sim.tracer)
        self._fr = flt
        self._T = T
        rng = np.random.default_rng(sim.seed)
        self.q = q = EventQueue(backend="heap")
        trace = SimTrace([], [], [], [], [])
        tr = self._tr
        retry_on = (net.link.retries > 0
                    or any(l.retries > 0 for l in net.link_overrides.values()))

        for i in range(n):
            if flt is None:
                q.schedule(self._step_busy(i), "step", node=i)
            else:
                q.schedule(self._step_busy(i), "step", node=i, gen=0)
        if sim.scenario.rewire_every is not None:
            q.schedule(sim.scenario.rewire_every, "rewire")
        if flt is not None:
            flt.bind(self)
            flt.schedule_initial(q)

        total_steps = 0
        next_eval = eval_every * n
        self.active = n

        while not q.empty():
            ev = q.pop()
            if ev.time > time_limit:
                break
            if ev.kind == "step":
                i = ev.data["node"]
                if flt is not None and (not flt.alive[i]
                                        or ev.data["gen"] != flt.step_gen[i]):
                    continue  # stale generation: node crashed/left meanwhile
                node = self.nodes[i]
                step_dur = net.local_step_time(i)
                self.compute_times.append(step_dur)
                if tr is not None:
                    tr.add_span("step", ev.time - step_dur, step_dur,
                                track=f"node{i}", node=i, t=int(node.t) + 1)
                n_flights = len(self.msg_flights)
                msgs = node.finish_step(net)
                for dst, payload in msgs:
                    if flt is not None and flt.blocked[i, dst]:
                        # partitioned/flapped link: refused at send time,
                        # BEFORE any loss/jitter draw, so the optimization
                        # RNG stream is identical to the unblocked run's
                        flt.blocked_sends += 1
                        continue
                    self.sent += 1
                    flight = net.sample_flight(i, dst, rng)
                    if flight is None:
                        self.drops += 1
                        if tr is not None:
                            tr.add_instant("drop", ev.time, track="net",
                                           src=i, dst=dst)
                        if retry_on:
                            link = net.link_for(i, dst)
                            if link.retries > 0:
                                q.schedule_in(link.retry_timeout, "retry",
                                              src=i, dst=dst,
                                              payload=payload, attempt=1)
                        continue
                    self.msg_flights.append(flight)
                    if tr is not None:
                        tr.add_span("flight", ev.time, flight, track="net",
                                    src=i, dst=dst)
                    # serialization already stalled the sender (step busy);
                    # only propagation + jitter remains in the air
                    extra = max(flight - net.serialize_time(i, dst), 0.0)
                    q.schedule_in(extra, "msg", src=i, dst=dst,
                                  payload=payload)
                total_steps += 1
                if node.t < T:
                    if flt is None:
                        q.schedule_in(self._step_busy(i), "step", node=i)
                    else:
                        q.schedule_in(self._step_busy(i), "step", node=i,
                                      gen=int(flt.step_gen[i]))
                else:
                    self.active -= 1
                if total_steps >= next_eval:
                    self._record(trace, q.now, total_steps)
                    next_eval += eval_every * n
                if ctrl is not None:
                    ctrl.on_steps(np.array([i]), np.array([step_dur]))
                    ctrl.on_messages(
                        np.asarray(self.msg_flights[n_flights:]))
                    if ctrl.retune_due(q.now):
                        # frontier over STILL-ACTIVE nodes: finished ones
                        # no longer constrain the future pattern (nor do
                        # crashed/departed ones, whose t is frozen)
                        front = max(
                            (nd.t for j, nd in enumerate(self.nodes)
                             if nd.t < T and (flt is None or
                                              (flt.alive[j]
                                               and flt.member[j]))),
                            default=None)
                        cut = (ctrl.maybe_retune(q.now, front + 1)
                               if front is not None else None)
                        if cut is not None:
                            self._refresh_next_comm(cut)
            elif ev.kind == "msg":
                if flt is not None and not (flt.alive[ev.data["src"]]
                                            and flt.alive[ev.data["dst"]]):
                    continue  # landed during downtime: silently dropped
                self.nodes[ev.data["dst"]].receive(ev.data["src"],
                                                   ev.data["payload"])
            elif ev.kind == "retry":
                src, dst = ev.data["src"], ev.data["dst"]
                if flt is not None and (not flt.alive[src]
                                        or flt.blocked[src, dst]):
                    continue  # no RNG draw: state-identical on both engines
                self.sent += 1
                self.retransmits += 1
                flight = net.sample_flight(src, dst, rng)
                if flight is None:
                    self.drops += 1
                    attempt = ev.data["attempt"]
                    link = net.link_for(src, dst)
                    if attempt < link.retries:
                        q.schedule_in(
                            link.retry_timeout
                            * link.retry_backoff ** attempt,
                            "retry", src=src, dst=dst,
                            payload=ev.data["payload"], attempt=attempt + 1)
                else:
                    self.msg_flights.append(flight)
                    if tr is not None:
                        tr.add_span("flight", ev.time, flight, track="net",
                                    src=src, dst=dst, retry=True)
                    if ctrl is not None:
                        ctrl.on_messages(np.array([flight]))
                    # the sender is NOT busy-charged for a retransmit, so
                    # the full flight (serialize + propagate) is in the air
                    q.schedule_in(flight, "msg", src=src, dst=dst,
                                  payload=ev.data["payload"])
            elif ev.kind == "fault":
                flt.handle(q, ev.data)
            elif ev.kind == "rewire":
                net.rewire()
                self.rewires += 1
                if tr is not None:
                    tr.add_instant("rewire", ev.time, track="net")
                if ctrl is not None:
                    ctrl.on_rewire(net.graph)
                if self.active > 0:
                    q.schedule_in(sim.scenario.rewire_every, "rewire")

        if not trace.iters or trace.iters[-1] * n < total_steps:
            self._record(trace, q.now, total_steps)
        return trace

    def _refresh_next_comm(self, cut: int) -> None:
        """A schedule splice at `cut` invalidated cached next-comm answers
        beyond it; re-query the mutated schedule for exactly those. Values
        at or before the cut are still correct (the past is immutable under
        the mutation protocol)."""
        sched = self.sim.schedule
        for nd in self.nodes:
            if nd.next_comm > cut:
                nd.next_comm = sched.next_comm_step(nd.t)

    def _record(self, trace: SimTrace, now: float, total_steps: int) -> None:
        n = self.net.n
        xhat = np.stack([nd.xhat for nd in self.nodes])
        z = np.stack([nd.z_est for nd in self.nodes])
        comm_total = sum(nd.comm_iters for nd in self.nodes)
        if self._tr is not None:
            self._tr.add_instant("eval", now, track="net",
                                 steps=int(total_steps))
        mask = self._fr.record_mask() if self._fr is not None else None
        if self.sim.compression is not None:
            res = np.stack([nd._comp_res for nd in self.nodes])
            self.comp_res_norms.append(float(np.mean(
                np.linalg.norm(res.reshape(n, -1), axis=1))))
        _record_stacks(self.sim, trace, now, total_steps, n, xhat, z,
                       comm_total, mask=mask)

    def materialize_nodes(self) -> list:
        return self.nodes

    # -- fault-injection adapter (driven by repro_torch.faults.FaultRuntime) -------
    # Both engines expose this same surface; the runtime keeps all fault
    # bookkeeping in shared code so the engines stay bit-identical under
    # every plan. `self.active` (live unfinished nodes) is the shared
    # termination counter the runtime reads to stop rescheduling its
    # recurring events.

    def fault_state(self) -> dict:
        """Stacked copies of the mutable per-node state (the checkpoint /
        warm-start snapshot)."""
        return {"x": np.stack([nd.x for nd in self.nodes]),
                "xhat": np.stack([nd.xhat for nd in self.nodes]),
                "z": np.stack([nd.z for nd in self.nodes]),
                "t": np.array([nd.t for nd in self.nodes], dtype=np.int64),
                "comm_iters": np.array([nd.comm_iters for nd in self.nodes],
                                       dtype=np.int64)}

    def fault_apply_node(self, j: int, row: dict) -> None:
        nd = self.nodes[j]
        nd.x = np.array(row["x"], dtype=np.float64)
        nd.xhat = np.array(row["xhat"], dtype=np.float64)
        nd.z = np.array(row["z"], dtype=np.float64)
        nd.t = int(row["t"])
        nd.comm_iters = int(row["comm_iters"])
        nd.next_comm = int(row["next_comm"])

    def fault_clear_inbox(self, j: int) -> None:
        """Forget j's gossip everywhere: receivers fold the missing weight
        back into their self-loop (a deadline-degraded round) and j itself
        restarts with an empty inbox."""
        self.nodes[j].inbox.clear()
        for nd in self.nodes:
            nd.inbox.pop(j, None)

    def fault_deactivate(self, j: int) -> None:
        if self.nodes[j].t < self._T:
            self.active -= 1

    def fault_activate(self, j: int) -> None:
        if self.nodes[j].t < self._T:
            self.active += 1
            self.q.schedule_in(self._step_busy(j), "step", node=j,
                               gen=int(self._fr.step_gen[j]))

    def fault_next_comm(self, t: int) -> int:
        return int(self.sim.schedule.next_comm_step(int(t)))

    def fault_splice_graph(self, g) -> None:
        from repro_torch.core.graphs import GraphSequence
        self.net.seq = GraphSequence((g,))
        self.net.epoch = 0
        self.net._out_cache.clear()

    def fault_notify_membership(self, sub_graph, members) -> None:
        ctrl = self.sim.controller
        if ctrl is not None:
            ctrl.on_membership(sub_graph, members)

    def fault_notify_heal(self, now: float) -> None:
        ctrl = self.sim.controller
        if ctrl is not None:
            ctrl.on_partition_heal(now)


# ---------------------------------------------------------------------------
# vectorized engine
# ---------------------------------------------------------------------------


class _EdgeStore:
    """Growable per-directed-edge row store: `eid[a, b]` maps an (a, b) pair
    to a row in the value pools, allocated (zero-initialized) on first
    touch. This is how (n, n, d)-shaped per-link state (inbox values,
    push-sum sigma/rho mass) stays O(edges seen), not O(n^2 d)."""

    __slots__ = ("eid", "y", "w", "size", "_tail", "_scalar")

    def __init__(self, n: int, tail: tuple[int, ...], scalar: bool = False):
        self.eid = np.full((n, n), -1, dtype=np.int64)
        self._tail = tail
        self._scalar = scalar
        self.size = 0
        self.y = np.zeros((0,) + tail, dtype=np.float64)
        self.w = np.zeros(0, dtype=np.float64) if scalar else None

    def _ensure(self, need: int) -> None:
        cap = len(self.y)
        if need <= cap:
            return
        cap = max(16, cap)
        while cap < need:
            cap *= 2
        y = np.zeros((cap,) + self._tail, dtype=np.float64)
        y[:self.size] = self.y[:self.size]
        self.y = y
        if self._scalar:
            w = np.zeros(cap, dtype=np.float64)
            w[:self.size] = self.w[:self.size]
            self.w = w

    def rows(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Row indices for (a, b) pairs, allocating missing ones. Pairs must
        be unique within the call (callers guarantee this; duplicate-pair
        batches go through the scalar fallback paths)."""
        r = self.eid[a, b]
        miss = r < 0
        if miss.any():
            m = int(miss.sum())
            self._ensure(self.size + m)
            self.eid[a[miss], b[miss]] = np.arange(self.size, self.size + m)
            self.size += m
            r = self.eid[a, b]
        return r

    def row1(self, a: int, b: int) -> int:
        r = int(self.eid[a, b])
        if r < 0:
            self._ensure(self.size + 1)
            r = self.size
            self.eid[a, b] = r
            self.size += 1
        return r


class VectorizedEngine:
    """Struct-of-arrays engine: batched event processing over stacked node
    state. See the module docstring for the equivalence contract."""

    name = "vectorized"

    def __init__(self, sim: "NetSimulator"):
        self.sim = sim
        self.net = sim.net
        self.algorithm = sim.algorithm
        self.drops = 0
        self.sent = 0
        self.rewires = 0
        self.retransmits = 0
        # mean per-node error-feedback residual norm at each trace point
        # (empty when sim.compression is None)
        self.comp_res_norms: list[float] = []
        self._fr = None  # FaultRuntime when sim.faults is set
        self._retry_on = False
        self._flight_chunks: list[np.ndarray] = []
        self._compute_chunks: list[np.ndarray] = []
        self._a_cache: dict[float, float] = {}
        self._epoch_cache: dict[int, tuple] = {}
        self._proj = (_RowBatch(sim.projection)
                      if sim.projection is not None else None)
        self._ctrl = None  # bound per-run in run()
        self._mw_cache: tuple | None = None  # (W, S_in, Wslot, Wdiag)
        # same detail-tracing contract as ObjectEngine: one branch per
        # event BATCH here (the engine's own batching amortizes it)
        tracer = getattr(sim, "tracer", None)
        self._tr = tracer if (tracer is not None and tracer.detail) else None

    # -- observability (same contract as ObjectEngine's lists) --------------

    @property
    def msg_flights(self) -> list[float]:
        if not self._flight_chunks:
            return []
        return np.concatenate(self._flight_chunks).tolist()

    @property
    def compute_times(self) -> list[float]:
        if not self._compute_chunks:
            return []
        return np.concatenate(self._compute_chunks).tolist()

    # -- topology / timing caches -------------------------------------------

    def _rebuild_topology(self) -> None:
        net = self.net
        idx = net.epoch % len(net.seq)
        cached = self._epoch_cache.get(idx)
        if cached is None:
            g = net.seq.at(idx)
            n, k = g.n, g.degree
            S_in = np.empty((n, k), dtype=np.int64)
            S_out = np.empty((n, k), dtype=np.int64)
            ar = np.arange(n)
            for slot, perm in enumerate(g.perms):
                p = np.asarray(perm, dtype=np.int64)
                S_in[:, slot] = p          # receiver i hears from perm[i]
                S_out[p, slot] = ar        # sender perm[i] ships to i
            # NIC occupancy per full gossip round, accumulated link-by-link
            # in the object engine's out-neighbor order so the float result
            # matches its Python `sum()` bitwise.
            send_busy = np.zeros(n, dtype=np.float64)
            if net.link_overrides:
                for i in range(n):
                    busy = 0.0
                    for slot in range(k):
                        busy += net.serialize_time(i, int(S_out[i, slot]))
                    send_busy[i] = busy
            else:
                busy, s = 0.0, net.link.serialize(net.wire_bytes)
                for _ in range(k):
                    busy += s
                send_busy[:] = busy
            cached = (g, S_in, S_out, send_busy)
            self._epoch_cache[idx] = cached
        self.graph, self.S_in, self.S_out, self.send_busy = cached
        self.k = self.graph.degree

    # -- flight sampling (RNG consumed in the object engine's order) ---------

    def _sample_flights(self, srcs: np.ndarray, dsts: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keep, flight, extra) per message, node-major slot-minor order."""
        m = len(srcs)
        net, rng = self.net, self.rng
        link = net.link
        if not net.link_overrides and link.jitter == 0.0:
            if link.loss > 0.0:
                keep = rng.random(m) >= link.loss
            else:
                keep = np.ones(m, dtype=bool)
            s = link.serialize(net.wire_bytes)
            flight = s + link.latency
            extra = max(flight - s, 0.0)
            return (keep, np.full(m, flight), np.full(m, extra))
        # jitter or per-edge overrides: exact per-message sampling
        keep = np.zeros(m, dtype=bool)
        flights = np.zeros(m, dtype=np.float64)
        extras = np.zeros(m, dtype=np.float64)
        for j in range(m):
            src, dst = int(srcs[j]), int(dsts[j])
            f = net.sample_flight(src, dst, rng)
            if f is None:
                continue
            keep[j] = True
            flights[j] = f
            extras[j] = max(f - net.serialize_time(src, dst), 0.0)
        return keep, flights, extras

    def _ship(self, srcs, dsts, payload: dict[str, Any]) -> None:
        """Sample flights for a flat message batch and schedule arrival
        groups (one queue entry per distinct arrival time)."""
        fr = self._fr
        if fr is not None:
            # partitioned/flapped links refuse at send time BEFORE any
            # loss/jitter draw (matching the object engine's per-message
            # skip), keeping the optimization RNG stream untouched
            ok = ~fr.blocked[srcs, dsts]
            if not ok.all():
                fr.blocked_sends += int((~ok).sum())
                if not ok.any():
                    return
                srcs, dsts = srcs[ok], dsts[ok]
                payload = {key: (val if key == "buf" else val[ok])
                           for key, val in payload.items()}
        m = len(srcs)
        self.sent += m
        keep, flights, extras = self._sample_flights(srcs, dsts)
        n_drop = int(m - keep.sum())
        self.drops += n_drop
        if self._tr is not None and n_drop:
            self._tr.add_instant("drop", self.q.now, track="net",
                                 count=n_drop)
        if n_drop and self._retry_on:
            # queue a retry per dropped message, in message (index) order --
            # the same order the object engine's per-message loop uses
            for j in np.nonzero(~keep)[0]:
                src, dst = int(srcs[j]), int(dsts[j])
                link = self.net.link_for(src, dst)
                if link.retries <= 0:
                    continue
                pl = {key: val[j:j + 1].copy()
                      for key, val in payload.items() if key != "buf"}
                pl["buf"] = payload["buf"][int(payload["rows"][j])][None].copy()
                pl["rows"] = np.zeros(1, dtype=np.int64)
                self.q.schedule_in(link.retry_timeout, "retry", src=src,
                                   dst=dst, payload=pl, attempt=1)
        if not keep.any():
            return
        ks = np.nonzero(keep)[0]
        self._flight_chunks.append(flights[ks])
        if self._tr is not None:
            self._tr.add_spans("flight", np.full(len(ks), self.q.now),
                               flights[ks], track="net")
        if self._ctrl is not None:
            self._ctrl.on_messages(flights[ks])
        arrivals = self.q.now + extras[ks]
        times, inv = np.unique(arrivals, return_inverse=True)
        for u, tm in enumerate(times):
            sel = ks[inv == u]
            data = {key: val[sel] for key, val in payload.items()
                    if key != "buf"}
            if "buf" in payload:
                data["buf"] = payload["buf"]
            self.q.schedule(float(tm), "msgs", srcs=srcs[sel],
                            dsts=dsts[sel], **data)

    # -- stepsize (scalar calls, scattered to the batch) ---------------------

    def _a_batch(self, t_new: np.ndarray) -> np.ndarray:
        uniq, inv = np.unique(t_new, return_inverse=True)
        vals = np.empty(len(uniq), dtype=np.float64)
        for j, u in enumerate(uniq):
            u = float(u)
            a = self._a_cache.get(u)
            if a is None:
                a = float(self.sim.a_fn(u))
                self._a_cache[u] = a
            vals[j] = a
        return vals[inv]

    def _col(self, v: np.ndarray) -> np.ndarray:
        return v.reshape(v.shape[0], *([1] * len(self.tail)))

    # -- lifecycle ------------------------------------------------------------

    def _init_state(self, x0_stack: np.ndarray) -> None:
        sim, n = self.sim, self.net.n
        self.n = n
        self.tail = x0_stack.shape[1:]
        self.x = x0_stack.copy()
        self.xhat = x0_stack.copy()
        self.t = np.zeros(n, dtype=np.int64)
        self.next_comm = np.full(n, sim.schedule.next_comm_step(0),
                                 dtype=np.int64)
        self.comm_iters = np.zeros(n, dtype=np.int64)
        self.local_step = np.array(
            [spec.scale / n for spec in self.net.node_specs],
            dtype=np.float64)
        if self.algorithm == "pushsum":
            self.y = (np.zeros_like(self.x) if sim.pushsum_y0 is None
                      else np.array(sim.pushsum_y0, dtype=np.float64))
            self.w = np.ones(n, dtype=np.float64)
            self.w_floor = sim.pushsum_w_floor
            self.sigma = _EdgeStore(n, self.tail, scalar=True)
            self.rho = _EdgeStore(n, self.tail, scalar=True)
        else:
            self.z = np.zeros_like(self.x)
            self.stamp = np.zeros((n, n), dtype=np.int64)
            self.val = _EdgeStore(n, self.tail)
            # sender-side error-feedback residuals (compressed gossip)
            self.comp_res = (np.zeros_like(self.x)
                             if sim.compression is not None else None)

    def _z_est_all(self) -> np.ndarray:
        if self.algorithm == "pushsum":
            return self.y / self._col(np.maximum(self.w, self.w_floor))
        return self.z

    def _schedule_steps(self, nodes: np.ndarray, fire: np.ndarray) -> None:
        """One 'steps' entry per distinct fire time (node order within).
        Under fault injection every entry snapshots each node's step
        generation so a crash/leave between scheduling and firing renders
        the entry stale (the object engine's per-event gen check)."""
        times, inv = np.unique(fire, return_inverse=True)
        fr = self._fr
        for u, tm in enumerate(times):
            sel = nodes[inv == u]
            if fr is None:
                self.q.schedule(float(tm), "steps", nodes=sel)
            else:
                self.q.schedule(float(tm), "steps", nodes=sel,
                                gens=fr.step_gen[sel].copy())

    # -- main loop ------------------------------------------------------------

    def run(self, x0_stack: np.ndarray, T: int, eval_every: int,
            time_limit: float) -> SimTrace:
        sim = self.sim
        n = self.net.n
        ctrl = self._ctrl = sim.controller
        if ctrl is not None:
            ctrl.bind(self.net)  # resets the schedule's splice history, so
            # it must run BEFORE _init_state caches next_comm answers
        self._init_state(x0_stack)
        self._rebuild_topology()
        self.rng = np.random.default_rng(sim.seed)
        self.q = q = EventQueue(backend="calendar")
        trace = SimTrace([], [], [], [], [])
        self._T = T
        net = self.net
        self._retry_on = (net.link.retries > 0
                          or any(l.retries > 0
                                 for l in net.link_overrides.values()))
        flt = None
        if sim.faults is not None:
            from repro_torch.faults.runtime import FaultRuntime
            flt = FaultRuntime(sim.faults, n, tracer=sim.tracer)
        self._fr = flt

        nodes0 = np.arange(n, dtype=np.int64)
        busy0 = self.local_step + np.where(
            self.t + 1 == self.next_comm, self.send_busy, 0.0)
        self._schedule_steps(nodes0, busy0)
        if sim.scenario.rewire_every is not None:
            q.schedule(sim.scenario.rewire_every, "rewire")
        if flt is not None:
            flt.bind(self)
            flt.schedule_initial(q)

        self.total_steps = 0
        self.next_eval = eval_every * n
        self.active = n

        while not q.empty():
            ev = q.pop()
            if ev.time > time_limit:
                break
            if ev.kind == "steps":
                nodes = ev.data["nodes"]
                if flt is None:
                    # coalesce same-time step entries (consecutive by seq)
                    while (not q.empty() and q.peek().kind == "steps"
                           and q.peek().time == ev.time):
                        nodes = np.concatenate(
                            [nodes, q.pop().data["nodes"]])
                else:
                    # safe to coalesce under faults too: a same-time
                    # "fault" event (prio 1) pops BEFORE any "steps"
                    # (prio 3), so no fault can interleave mid-batch
                    gens = ev.data["gens"]
                    while (not q.empty() and q.peek().kind == "steps"
                           and q.peek().time == ev.time):
                        nxt = q.pop().data
                        nodes = np.concatenate([nodes, nxt["nodes"]])
                        gens = np.concatenate([gens, nxt["gens"]])
                    live = flt.alive[nodes] & (gens == flt.step_gen[nodes])
                    if not live.all():
                        nodes = nodes[live]
                        if len(nodes) == 0:
                            continue  # all stale: object engine skips too
                self._on_steps(nodes, T, trace, eval_every * n)
                if ctrl is not None and ctrl.retune_due(q.now):
                    alive = self.t < T  # frontier over still-active nodes
                    if flt is not None:
                        alive &= flt.alive & flt.member
                    cut = (ctrl.maybe_retune(
                        q.now, int(self.t[alive].max()) + 1)
                        if alive.any() else None)
                    if cut is not None:
                        stale = self.next_comm > cut
                        if stale.any():
                            self.next_comm[stale] = \
                                sim.schedule.next_comm_step_batch(
                                    self.t[stale])
            elif ev.kind == "msgs":
                data = ev.data
                if flt is not None:
                    keep = flt.alive[data["srcs"]] & flt.alive[data["dsts"]]
                    if not keep.all():
                        if not keep.any():
                            continue  # whole batch landed during downtime
                        data = {key: (val if key == "buf" else val[keep])
                                for key, val in data.items()}
                self._on_msgs(data)
            elif ev.kind == "retry":
                src, dst = ev.data["src"], ev.data["dst"]
                if flt is not None and (not flt.alive[src]
                                        or flt.blocked[src, dst]):
                    continue  # no RNG draw: state-identical on both engines
                self.sent += 1
                self.retransmits += 1
                flight = net.sample_flight(src, dst, self.rng)
                if flight is None:
                    self.drops += 1
                    attempt = ev.data["attempt"]
                    link = net.link_for(src, dst)
                    if attempt < link.retries:
                        q.schedule_in(
                            link.retry_timeout
                            * link.retry_backoff ** attempt,
                            "retry", src=src, dst=dst,
                            payload=ev.data["payload"], attempt=attempt + 1)
                else:
                    self._flight_chunks.append(np.array([flight]))
                    if self._tr is not None:
                        self._tr.add_span("flight", ev.time, flight,
                                          track="net", src=src, dst=dst,
                                          retry=True)
                    if ctrl is not None:
                        ctrl.on_messages(np.array([flight]))
                    # full flight in the air: no busy charge on retransmit
                    q.schedule_in(flight, "msgs",
                                  srcs=np.array([src], dtype=np.int64),
                                  dsts=np.array([dst], dtype=np.int64),
                                  **ev.data["payload"])
            elif ev.kind == "fault":
                flt.handle(q, ev.data)
            elif ev.kind == "rewire":
                self.net.rewire()
                self._rebuild_topology()
                self.rewires += 1
                if self._tr is not None:
                    self._tr.add_instant("rewire", ev.time, track="net")
                if ctrl is not None:
                    ctrl.on_rewire(self.net.graph)
                if self.active > 0:
                    q.schedule_in(sim.scenario.rewire_every, "rewire")

        if not trace.iters or trace.iters[-1] * n < self.total_steps:
            self._record(trace, q.now, self.total_steps)
        return trace

    def _record(self, trace: SimTrace, now: float, total_steps: int) -> None:
        if self._tr is not None:
            self._tr.add_instant("eval", now, track="net",
                                 steps=int(total_steps))
        mask = self._fr.record_mask() if self._fr is not None else None
        if self.sim.compression is not None:
            self.comp_res_norms.append(float(np.mean(np.linalg.norm(
                self.comp_res.reshape(self.n, -1), axis=1))))
        _record_stacks(self.sim, trace, now, total_steps, self.n, self.xhat,
                       self._z_est_all(), int(self.comm_iters.sum()),
                       mask=mask)

    # -- step processing ------------------------------------------------------

    def _on_steps(self, nodes: np.ndarray, T: int, trace: SimTrace,
                  eval_every_steps: int) -> None:
        """Drain a same-time batch of node steps, splitting at trace-record
        boundaries so a mid-batch `total_steps >= next_eval` crossing
        records exactly the state the object engine would have."""
        start, b = 0, len(nodes)
        while start < b:
            room = self.next_eval - self.total_steps
            chunk = nodes[start:start + min(room, b - start)]
            self._process_chunk(chunk, T)
            self.total_steps += len(chunk)
            start += len(chunk)
            if self.total_steps >= self.next_eval:
                self._record(trace, self.q.now, self.total_steps)
                self.next_eval += eval_every_steps

    def _process_chunk(self, due: np.ndarray, T: int) -> None:
        sim, now = self.sim, self.q.now
        i = due
        self._compute_chunks.append(self.local_step[i])
        if self._tr is not None:
            durs = self.local_step[i]
            self._tr.add_spans("step", now - durs, durs,
                               tracks=[f"node{j}" for j in i])
        if self._ctrl is not None:
            self._ctrl.on_steps(i, self.local_step[i])
        t_old = self.t[i]
        t_new = t_old + 1
        grads = sim._grad_batch.batch_or_loop(i, self.x[i], t_old)
        comm = t_new == self.next_comm[i]
        any_comm = bool(comm.any())
        if any_comm:
            ci = i[comm]
            if self.algorithm == "pushsum":
                self._comm_pushsum(ci)
            else:
                self._comm_dda(ci, t_new[comm], grads[comm])
            self.next_comm[ci] = sim.schedule.next_comm_step_batch(
                t_new[comm])
            self.comm_iters[ci] += 1
        if self.algorithm == "pushsum":
            if sim.pushsum_inject == "scaled":
                # w-scaled injection: a node holding little mass injects
                # proportionally little gradient (see PushSumDDANode)
                self.y[i] = self.y[i] + self._col(self.w[i]) * grads
            else:
                self.y[i] = self.y[i] + grads
            z_rows = self.y[i] / self._col(np.maximum(self.w[i],
                                                      self.w_floor))
        else:
            if (~comm).any():
                ni = i[~comm]
                self.z[ni] = self.z[ni] + grads[~comm]
            z_rows = self.z[i]
        a_t = self._a_batch(t_new)
        x_new = -self._col(a_t) * z_rows
        if self._proj is not None:
            x_new = self._proj(x_new)
        self.xhat[i] = (self._col(t_old) * self.xhat[i] + x_new) \
            / self._col(t_new)
        self.x[i] = x_new
        self.t[i] = t_new
        # reschedule survivors, grouped by their next fire time
        alive = t_new < T
        self.active -= int((~alive).sum())
        if alive.any():
            ai = i[alive]
            comm_next = (t_new[alive] + 1) == self.next_comm[ai]
            busy = self.local_step[ai] + np.where(comm_next,
                                                  self.send_busy[ai], 0.0)
            self._schedule_steps(ai, now + busy)

    def _mix_weight_slots(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Per-slot stale-mix weights from `Network.mix_weights`, or None
        when no reweighted P is installed (the uniform fast path).

        Returns ((n, k) slot weights, (n,) self weights), folded through
        the shared `core.graphs.mix_weight_slots` convention (W[i, src] /
        multiplicity per slot) -- the same fold `AsyncDDANode._stale_mix`
        and the dense simulator's sparse gossip apply, keeping the engines
        and execution modes equivalent. Cached on the (W, S_in) object
        pair: a retune installs a new W, a rewire a new S_in; both
        invalidate.
        """
        W = self.net.mix_weights
        if W is None:
            return None
        hit = self._mw_cache
        if hit is None or hit[0] is not W or hit[1] is not self.S_in:
            from repro_torch.core.graphs import mix_weight_slots
            w_slot, w_self = mix_weight_slots(W, self.S_in)
            self._mw_cache = hit = (W, self.S_in, w_slot, w_self)
        return hit[2], hit[3]

    def _comm_dda(self, ci: np.ndarray, stamps: np.ndarray,
                  grads: np.ndarray) -> None:
        """Communication iteration for a batch of stale-gossip DDA nodes:
        snapshot pre-mix z, ship it, then mix-with-latest + gradient."""
        k = self.k
        comp = self.sim.compression
        if comp is None:
            buf = self.z[ci].copy()  # one shared snapshot for all k messages
        else:
            # sender-side error feedback. `compress_np` is a pure function
            # of (row, node, stamp) -- per-message RNG is seeded from the
            # (compressor seed, node, stamp) triple, never drawn from the
            # engine stream -- so this row-at-a-time loop produces exactly
            # the payloads the object engine's per-node path does,
            # regardless of event interleaving (bit-identity contract).
            corrected = self.z[ci] + self.comp_res[ci]
            buf = np.stack([
                comp.compress_np(corrected[j], int(ci[j]), int(stamps[j]))
                for j in range(len(ci))])
            if comp.error_feedback:
                self.comp_res[ci] = corrected - buf
        # batched stale mix: accumulate in-neighbor slots in slot order,
        # folding never-delivered neighbors back into the self weight
        g = self.graph
        mw = self._mix_weight_slots()
        if mw is None:
            acc = np.zeros_like(buf)
            missing = np.zeros(len(ci), dtype=np.int64)
            for slot in range(k):
                srcs = self.S_in[ci, slot]
                st = self.stamp[ci, srcs]
                has = st > 0
                if has.any():
                    rows = self.val.eid[ci, srcs]
                    vals = self.val.y[np.where(has, rows, 0)]
                    acc += np.where(self._col(has), vals, 0.0)
                missing += ~has
            sw = g.self_weight + missing * g.edge_weight
            mixed = stale_combine_batch(self.z[ci], g.edge_weight * acc, sw)
        else:
            Wslot, Wdiag = mw
            acc = np.zeros_like(buf)
            sw = Wdiag[ci].copy()
            for slot in range(k):
                srcs = self.S_in[ci, slot]
                st = self.stamp[ci, srcs]
                has = st > 0
                w = Wslot[ci, slot]
                if has.any():
                    rows = self.val.eid[ci, srcs]
                    vals = self.val.y[np.where(has, rows, 0)]
                    acc += np.where(self._col(has),
                                    self._col(w) * vals, 0.0)
                sw += np.where(has, 0.0, w)
            mixed = stale_combine_batch(self.z[ci], acc, sw)
        self.z[ci] = mixed + grads
        srcs = np.repeat(ci, k)
        dsts = self.S_out[ci].ravel()
        self._ship(srcs, dsts, {
            "buf": buf,
            "rows": np.repeat(np.arange(len(ci), dtype=np.int64), k),
            "stamps": np.repeat(stamps, k)})

    def _comm_pushsum(self, ci: np.ndarray) -> None:
        """Communication iteration for a batch of push-sum nodes: split mass
        equally over self + out-links, bump each link's cumulative sigma,
        and ship the post-bump cumulative totals."""
        k = self.k
        share = 1.0 / (k + 1)
        y_sh = self.y[ci] * share
        w_sh = self.w[ci] * share
        b = len(ci)
        snap_y = np.empty((b, k) + self.tail, dtype=np.float64)
        snap_w = np.empty((b, k), dtype=np.float64)
        for slot in range(k):
            d_s = self.S_out[ci, slot]
            rows = self.sigma.rows(ci, d_s)
            self.sigma.y[rows] += y_sh
            self.sigma.w[rows] += w_sh
            snap_y[:, slot] = self.sigma.y[rows]
            snap_w[:, slot] = self.sigma.w[rows]
        self.y[ci] = y_sh
        self.w[ci] = w_sh
        srcs = np.repeat(ci, k)
        dsts = self.S_out[ci].ravel()
        self._ship(srcs, dsts, {
            "buf": snap_y.reshape((b * k,) + self.tail),
            "rows": np.arange(b * k, dtype=np.int64),
            "w": snap_w.ravel()})

    # -- message arrival ------------------------------------------------------

    def _on_msgs(self, data: dict[str, Any]) -> None:
        srcs, dsts = data["srcs"], data["dsts"]
        m = len(srcs)
        pairs = dsts.astype(np.int64) * self.n + srcs
        unique = len(np.unique(pairs)) == m
        if self.algorithm == "pushsum":
            self._recv_pushsum(srcs, dsts, data["buf"], data["rows"],
                               data["w"], unique)
        else:
            self._recv_dda(srcs, dsts, data["buf"], data["rows"],
                           data["stamps"], unique)

    def _recv_dda(self, srcs, dsts, buf, rows, stamps, unique: bool) -> None:
        if not unique:  # same link twice in one arrival batch: exact order
            for j in range(len(srcs)):
                s, d, st = int(srcs[j]), int(dsts[j]), int(stamps[j])
                if st > self.stamp[d, s]:
                    r = self.val.row1(d, s)
                    self.val.y[r] = buf[rows[j]]
                    self.stamp[d, s] = st
            return
        cur = self.stamp[dsts, srcs]
        upd = stamps > cur
        if not upd.any():
            return
        ds, ss = dsts[upd], srcs[upd]
        r = self.val.rows(ds, ss)
        self.val.y[r] = buf[rows[upd]]
        self.stamp[ds, ss] = stamps[upd]

    def _recv_pushsum(self, srcs, dsts, buf, rows, w, unique: bool) -> None:
        if not unique:
            for j in range(len(srcs)):
                s, d = int(srcs[j]), int(dsts[j])
                r = self.rho.row1(s, d)
                S_y, S_w = buf[rows[j]], float(w[j])
                if S_w >= self.rho.w[r]:
                    self.y[d] = self.y[d] + (S_y - self.rho.y[r])
                    self.w[d] += S_w - self.rho.w[r]
                    self.rho.y[r] = S_y
                    self.rho.w[r] = S_w
            return
        r = self.rho.rows(srcs, dsts)
        ok = w >= self.rho.w[r]  # ignore out-of-order older messages
        if not ok.any():
            return
        rr = r[ok]
        S_y = buf[rows[ok]]
        S_w = w[ok]
        d_ok = dsts[ok]
        np.add.at(self.y, d_ok, S_y - self.rho.y[rr])
        np.add.at(self.w, d_ok, S_w - self.rho.w[rr])
        self.rho.y[rr] = S_y
        self.rho.w[rr] = S_w

    # -- fault-injection adapter (driven by repro_torch.faults.FaultRuntime) -------
    # Mirrors ObjectEngine's surface; every method performs the exact same
    # float ops on the SoA rows the object engine performs on its node
    # objects, so fault handling preserves the bit-identity contract.

    def fault_state(self) -> dict:
        return {"x": self.x.copy(), "xhat": self.xhat.copy(),
                "z": self.z.copy(), "t": self.t.copy(),
                "comm_iters": self.comm_iters.copy()}

    def fault_apply_node(self, j: int, row: dict) -> None:
        self.x[j] = row["x"]
        self.xhat[j] = row["xhat"]
        self.z[j] = row["z"]
        self.t[j] = int(row["t"])
        self.comm_iters[j] = int(row["comm_iters"])
        self.next_comm[j] = int(row["next_comm"])

    def fault_clear_inbox(self, j: int) -> None:
        # stamp == 0 reads as "never delivered": receivers fold j's weight
        # into their self-loop and j restarts with an empty inbox (the
        # pooled values go stale-unreachable until a fresh stamp lands)
        self.stamp[j, :] = 0
        self.stamp[:, j] = 0

    def fault_deactivate(self, j: int) -> None:
        if self.t[j] < self._T:
            self.active -= 1

    def fault_activate(self, j: int) -> None:
        if self.t[j] < self._T:
            self.active += 1
            busy = self.local_step[j] + (
                self.send_busy[j]
                if self.t[j] + 1 == self.next_comm[j] else 0.0)
            self.q.schedule_in(
                float(busy), "steps",
                nodes=np.array([j], dtype=np.int64),
                gens=np.array([self._fr.step_gen[j]], dtype=np.int64))

    def fault_next_comm(self, t: int) -> int:
        return int(self.sim.schedule.next_comm_step(int(t)))

    def fault_splice_graph(self, g) -> None:
        from repro_torch.core.graphs import GraphSequence
        self.net.seq = GraphSequence((g,))
        self.net.epoch = 0
        self.net._out_cache.clear()
        self._epoch_cache.clear()
        self._mw_cache = None
        self._rebuild_topology()

    def fault_notify_membership(self, sub_graph, members) -> None:
        if self._ctrl is not None:
            self._ctrl.on_membership(sub_graph, members)

    def fault_notify_heal(self, now: float) -> None:
        if self._ctrl is not None:
            self._ctrl.on_partition_heal(now)

    # -- interop with the object world ---------------------------------------

    def materialize_nodes(self) -> list:
        """Build per-node objects mirroring the SoA state, so diagnostics
        written against the object engine (`pushsum_mass_audit`, direct
        `.z_est` reads) keep working after a vectorized run."""
        sim, n = self.sim, self.n
        nodes: list[AsyncDDANode | PushSumDDANode] = []
        for i in range(n):
            if self.algorithm == "pushsum":
                node = PushSumDDANode(i, self.x[i], sim.grad_fn, sim.a_fn,
                                      sim.schedule, sim.projection,
                                      w_floor=self.w_floor,
                                      inject=sim.pushsum_inject)
                node.y = self.y[i].copy()
                node.w = float(self.w[i])
                for dst in np.nonzero(self.sigma.eid[i] >= 0)[0]:
                    r = self.sigma.eid[i, dst]
                    node.sigma_y[int(dst)] = self.sigma.y[r].copy()
                    node.sigma_w[int(dst)] = float(self.sigma.w[r])
                for src in np.nonzero(self.rho.eid[:, i] >= 0)[0]:
                    r = self.rho.eid[src, i]
                    node.rho_y[int(src)] = self.rho.y[r].copy()
                    node.rho_w[int(src)] = float(self.rho.w[r])
            else:
                node = AsyncDDANode(i, self.x[i], sim.grad_fn, sim.a_fn,
                                    sim.schedule, sim.projection,
                                    compression=sim.compression)
                node.z = self.z[i].copy()
                if sim.compression is not None:
                    node._comp_res = self.comp_res[i].copy()
                for src in np.nonzero(self.stamp[i] > 0)[0]:
                    r = self.val.eid[i, src]
                    node.inbox[int(src)] = (int(self.stamp[i, src]),
                                            self.val.y[r].copy())
            node.x = self.x[i].copy()
            node.xhat = self.xhat[i].copy()
            node.t = int(self.t[i])
            node.next_comm = int(self.next_comm[i])
            node.comm_iters = int(self.comm_iters[i])
            nodes.append(node)
        return nodes
