"""Distributed Dual Averaging (DDA) on one device, in PyTorch -- the port of
the dense `DDASimulator` of `repro.core.dda` (paper eqs. 3-5).

Per node i, at iteration t (1-indexed):

    z_i(t)   = sum_j p_ij z_j(t-1) + g_i(t-1)         (consensus + subgradient)
    x_i(t)   = argmin_x { <z_i(t), x> + psi(x)/a(t) } (proximal step)
    xhat_i(t)= ((t-1) xhat_i(t-1) + x_i(t)) / t       (running average)

with psi(x) = 0.5 ||x||^2 the proximal step is x = Proj_X(-a(t) z) (paper
V.A). On cheap iterations (no communication) the consensus sum is replaced
by z_i(t) = z_i(t-1) + g_i(t-1) (paper IV.A).

With a compressor attached, the messages a node sends are compressed with
error feedback: it sends C(z_i + res_i) and keeps res_i <- (z_i + res_i) -
sent; its own z_i is always mixed exactly ([beyond paper], the reference's
`repro.compress`; the wire ratio c scales the time axis's r to r*c).

Nodes are a stacked leading axis of (n, d) tensors on one device. On a
k-regular graph the consensus round is a hand-written kernel, O(nkd): the
gossip mix (`kernels.ops.gossip_gather_mix_impl`, K1), uncompressed or with
a quantized message stack, or the compress-mix (`kernels.ops.
compress_mix_impl`, K2) under a sparsifier. Otherwise it is the dense
P @ z matmul.

The run program (the counterpart of the reference's scanned program and of
its vmap over sweep lanes, `run_batch`) holds B lanes as a carry of
(n, B, d) buffers updated in place, and a shared iteration counter t. The
mix sees the carry as one (n, B*d) state, in which every column mixes on
its own, so a lane's mixed values are its solo run's bit for bit. The
problem's closures, the compressors and the trace statistics run per lane
(`torch.func.vmap` over dim 1). The comm pattern is host data
(`CommSchedule.comm_mask`): each iteration is the body with communication
or the one without, picked on the host, and in a batch a lane that does
not communicate keeps its z and residual (`torch.where` on its flag, read
on the device), which is what the reference's vmapped `lax.cond` computes.

On a CUDA card the three bodies (an iteration with and without
communication, and the trace statistics) are captured as CUDA graphs once
per shape and replayed: the counterpart of the reference's compile per
shape. A problem whose closures read the device back to the host cannot be
captured and says so (`DDASimulator(capture=False)`); its runs, and every
run on the CPU, call the same bodies eagerly. `last_loop` records which.
A capture runs alone on the card (`DEVICE_LOCK`), so threads that share
the process (the experiment server's) may run and capture side by side.

`DDAState`, `dda_init` and `dda_local_step` are the reference's per-node
pytree step (a cheap iteration, z <- z + g, on nested dicts and lists of
tensors). Its expensive twin `dda_mix_step` mixes over a shard_map axis
across chips and comes with the multi-card slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import threading
import time
import weakref
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.utils._pytree as _pytree

from repro_torch import resolve_device
from repro_torch.core import consensus as _cons
from repro_torch.core.graphs import CommGraph, mix_weight_slots
from repro_torch.core.schedules import CommSchedule, EveryIteration

__all__ = [
    "DEVICE_LOCK",
    "DDAState",
    "DDASimulator",
    "SegmentStats",
    "SimTrace",
    "TRACE_FIELDS",
    "dda_init",
    "dda_local_step",
    "json_sanitize",
    "stepsize_sqrt",
    "trace_time_to_reach",
]

#: the carry of one run: (z, x, xhat, res, t), as the reference's scan carry
State = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


class _DeviceLock:
    """The process-wide rule that keeps a CUDA graph capture alone on the
    card. In the default ("global") capture mode another thread's
    potentially unsafe CUDA call (an allocation, a synchronize, a copy to
    the host) breaks a capture, and a graph freed during a capture
    invalidates it. So a capture, and the release of captured graphs, hold
    this lock exclusively; the port's entry points hold it shared around
    the rest of their device work (a run's build, its replays or eager
    bodies, its readbacks), so runs of different simulators still replay
    side by side.

    Reentrant in each thread: a shared hold inside a shared or exclusive
    one adds nothing, and a thread that asks for the exclusive hold while
    it holds a shared one (a capture starts inside a run) gives the shared
    one up while it waits and takes it back after. A waiting exclusive
    hold keeps new shared ones out. A thread holding this lock shared must
    not wait on another lock whose holder may ask for it exclusively.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0      # threads holding it shared
        self._writer = None    # the thread holding it exclusively
        self._waiting = 0      # threads waiting to hold it exclusively
        self._local = threading.local()

    def _depth(self):
        held = self._local
        if not hasattr(held, "shared"):
            held.shared = held.exclusive = 0
        return held

    @contextlib.contextmanager
    def shared(self):
        held = self._depth()
        outer = not (held.shared or held.exclusive)
        if outer:
            with self._cond:
                while self._writer is not None or self._waiting:
                    self._cond.wait()
                self._readers += 1
        held.shared += 1
        try:
            yield
        finally:
            held.shared -= 1
            if outer:
                with self._cond:
                    self._readers -= 1
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        held = self._depth()
        if held.exclusive:
            held.exclusive += 1
            try:
                yield
            finally:
                held.exclusive -= 1
            return
        with self._cond:
            if held.shared:
                self._readers -= 1
                self._cond.notify_all()
            self._waiting += 1
            try:
                while self._writer is not None or self._readers:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._writer = threading.get_ident()
        held.exclusive = 1
        try:
            yield
        finally:
            held.exclusive = 0
            with self._cond:
                self._writer = None
                if held.shared:
                    self._readers += 1
                self._cond.notify_all()


#: the one `_DeviceLock` of the process
DEVICE_LOCK = _DeviceLock()


class SegmentStats(NamedTuple):
    """One trace point of a run, on the host: the mean local objective,
    the objective at the mean, the disagreement and the mean per-node
    residual norm (zero uncompressed)."""

    fval: float
    fval_consensus: float
    disagreement: float
    res_norm: float


def stepsize_sqrt(A: float, q: float = 0.5) -> Callable:
    """a(t) = A / max(t, 1)^q.

    A tensor `t` (the simulator's float32 iteration counter) is computed in
    its own dtype, as the reference computes it on a traced float32 scalar:
    a double computed on the host would differ by an ulp per step. Host
    floats and numpy arrays take the numpy path, in full precision.
    """
    def a(t):
        if isinstance(t, torch.Tensor):
            return torch.full_like(t, A) / torch.clamp(t, min=1.0) ** q
        return A / np.maximum(t, 1.0) ** q
    return a


class DDAState(NamedTuple):
    z: Any              # accumulated dual (subgradient) direction
    x: Any              # current primal iterate
    xhat: Any           # running average (the algorithm's output)
    t: torch.Tensor     # iteration counter (float32 scalar)


def dda_init(x0) -> DDAState:
    """z = 0, x = xhat = x0, t = 0 (float32, on x0's device)."""
    leaves = _pytree.tree_leaves(x0)
    device = leaves[0].device if leaves else None
    return DDAState(z=_pytree.tree_map(torch.zeros_like, x0), x=x0, xhat=x0,
                    t=torch.zeros((), dtype=torch.float32, device=device))


def _prox(z, a_t: torch.Tensor, projection: Callable | None):
    x = _pytree.tree_map(lambda zl: (-a_t * zl).to(zl.dtype), z)
    return projection(x) if projection is not None else x


def _advance(state: DDAState, z_new, a_fn, projection) -> DDAState:
    """x = Proj(-a(t+1) z), xhat = (t xhat + x) / (t + 1): each product
    rounded on its own (no fused multiply-add), as the simulator rounds."""
    t_new = state.t + 1.0
    x_new = _prox(z_new, a_fn(t_new), projection)
    xhat_new = _pytree.tree_map(lambda h, x: (state.t * h + x) / t_new,
                                state.xhat, x_new)
    return DDAState(z=z_new, x=x_new, xhat=xhat_new, t=t_new)


def dda_local_step(state: DDAState, grad, a_fn,
                   projection: Callable | None = None) -> DDAState:
    """Cheap iteration: z <- z + g (no communication), then the prox and
    the running average. New tensors; the state given is left as it is."""
    z_new = _pytree.tree_map(torch.add, state.z, grad)
    return _advance(state, z_new, a_fn, projection)


@dataclasses.dataclass
class SimTrace:
    """Evaluation trace with the paper's simulated time model attached."""

    iters: list[int]
    sim_time: list[float]       # cumulative time units: sum of 1/n + k r 1{comm}
    fvals: list[float]          # Fbar(t) = (1/n) sum_i F(xhat_i) (paper Fig 1/2)
    comms: list[int]            # cumulative communication rounds H_t
    disagreement: list[float]   # max_i ||z_i - z_bar||
    fvals_consensus: list[float] = dataclasses.field(default_factory=list)
    # F at the consensus average xhat_bar (not what the paper plots, but
    # useful to separate optimization error from network disagreement)


#: the canonical field list, derived from the dataclass so equality
#: assertions and result writers can never drift from SimTrace itself
TRACE_FIELDS = tuple(f.name for f in dataclasses.fields(SimTrace))


def json_sanitize(obj):
    """Strict-RFC JSON sanitizer for trace/result payloads: np scalars ->
    Python numbers, inf/nan -> null. A diverged or never-reached-target run
    is a legal result (tta = inf, blown-up fvals), and the files carrying
    it must stay readable by jq/JSON.parse, which reject Infinity/NaN."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, (float, np.floating)):
        v = float(obj)
        return v if math.isfinite(v) else None
    if isinstance(obj, np.integer):
        return int(obj)
    return obj


def trace_time_to_reach(trace: SimTrace, eps_value: float,
                        use_consensus: bool = False) -> float:
    """First simulated time at which the objective reaches eps_value.

    Default (`use_consensus=False`) scans `trace.fvals`, i.e.
    Fbar(t) = (1/n) sum_i F(xhat_i) -- the per-node mean the paper's
    Fig. 1/2 time-to-accuracy curves are read from. `use_consensus=True`
    scans `trace.fvals_consensus` (F at the consensus average xhat_bar).
    """
    fvals = trace.fvals_consensus if use_consensus else trace.fvals
    for tt, fv in zip(trace.sim_time, fvals):
        if fv <= eps_value:
            return tt
    return float("inf")


class DDASimulator:
    """Runs DDA with n nodes as a stacked leading axis on one device.

    Args:
      subgrad_fn: (x_stack[n, ...], t, key) -> g_stack[n, ...]; node i's
        subgradient of f_i at x_i. `key` is always None: no registered
        problem draws random numbers.
      eval_fn: x[...] -> 0-d tensor F(x) on the FULL objective, written in
        torch ops (it is vmapped over the nodes with `torch.func.vmap`).
      graph: communication topology (mixing matrix P taken from it).
      schedule: communication schedule (every / periodic-h / sparse-p).
      a_fn: stepsize a(t), called with the float32 counter tensor.
      projection: optional Proj_X applied after the prox step (stacked).
      r: communication/computation tradeoff for the simulated time axis.
      mix: "auto" | "dense" | "sparse", as in the reference. "sparse" is the
        k-regular gossip-mix kernel (its plain version for CPU tensors);
        "auto" picks it whenever the graph's permutation edge set is
        materially sparser than complete (k + 1 < n) and any `mix_weights`
        lies on the edge set, and the dense matmul otherwise. The resolved
        choice is `self.mix_mode`.
      mix_weights: optional (n, n) mixing-matrix override, folded into
        per-edge weight vectors on the sparse path (slot weight W[i, src] /
        multiplicity, `graphs.mix_weight_slots`).
      device: where the state lives; None means the CUDA card, and raises
        without one (see `repro_torch.resolve_device`).
      compression: a built `repro_torch.compress.Compressor` (or None). The
        transmitted messages are compressed with error feedback kept in
        the carry; on the sparse path sparsifiers (`topk`/`randk`) mix
        through K2 and quantizers ship a dequantized message stack through
        K1. The diagonal always mixes the node's exact own z.
        `self.wire_ratio(d)` is the byte model for the effective tradeoff
        r -> r*c. A "none" compressor is the uncompressed run.
      compress_keep: legacy alias, `compress_keep=f` is exactly
        `compression=TopK(keep=f)`. Mutually exclusive with `compression`.
      capture: whether runs on a CUDA card may be captured as CUDA graphs.
        False for closures that read the device back to the host (which a
        capture forbids); those runs call the same bodies eagerly.
    """

    def __init__(self, subgrad_fn, eval_fn, graph: CommGraph,
                 schedule: CommSchedule | None = None,
                 a_fn=None, projection=None, r: float = 0.0,
                 compress_keep: float | None = None,
                 mix: str = "auto",
                 mix_weights: np.ndarray | None = None,
                 compression=None, *, device=None, capture: bool = True):
        if compress_keep is not None and compression is not None:
            raise ValueError("pass either compression or the legacy "
                             "compress_keep alias, not both")
        if compress_keep is not None:
            # imported here: repro_torch.compress imports the experiments
            # registry, which imports this module
            from repro_torch.compress import TopK
            compression = TopK(keep=float(compress_keep))
        self.compress_keep = compress_keep
        # "none" normalizes to no compression, so the uncompressed run is
        # K1's path unchanged
        if compression is not None and compression.kind == "none":
            compression = None
        self.compression = compression
        self.device = resolve_device(device)
        self.subgrad_fn = subgrad_fn
        self.eval_fn = eval_fn
        self.graph = graph
        self.schedule = schedule or EveryIteration()
        self.a_fn = a_fn or stepsize_sqrt(1.0)
        self.projection = projection
        self.r = float(r)
        self.mix_weights = (None if mix_weights is None
                            else np.asarray(mix_weights, np.float64))
        self.mix_mode = self._resolve_mix_mode(mix)
        if self.mix_mode == "sparse":
            S_in, w_self, w_edge = self._sparse_weights()
            self._S_in = torch.as_tensor(S_in, device=self.device)
            self._w_self = w_self
            self._w_edge = w_edge
        else:
            P_host = (self.mix_weights if self.mix_weights is not None
                      else graph.mixing_matrix())
            self._P = torch.as_tensor(P_host, dtype=torch.float32,
                                      device=self.device)
            # off-diagonal mixing applies to RECEIVED (possibly compressed)
            # messages; the diagonal always uses the node's exact own state
            self._P_diag = torch.diagonal(self._P).clone()
            self._P_off = self._P - torch.diag(self._P_diag)
        #: per-segment mean per-node error-feedback residual norms of the
        #: last scanned run (np (S,); zeros when uncompressed)
        self.last_res_norms: np.ndarray | None = None
        #: per-run wall split read by the experiments runner: `compile_s`
        #: is the first-use build of the kernel library, `execute_s` the
        #: iteration loop, `eval_s` the per-segment trace readback of
        #: loop="segment"
        self.last_timings: dict[str, float] = {
            "compile_s": 0.0, "execute_s": 0.0, "eval_s": 0.0}
        self.capture = bool(capture)
        #: how the last run ran: "graph" (replayed CUDA graphs) or "eager"
        self.last_loop: str | None = None
        #: run programs by (x0 shape, dtype, lanes), each with its buffers
        #: and, once captured, its graphs: captured once per shape
        self._programs: dict[tuple, _LaneProgram] = {}
        #: the one-lane program a closed loop drives (`start_closed_loop`)
        self._loop_prog: _LaneProgram | None = None

    def wire_ratio(self, d: int) -> float:
        """Bytes-on-wire fraction c for a d-float message under the
        attached compressor (1.0 uncompressed) -- the multiplier for the
        paper's effective tradeoff r -> r*c."""
        return (1.0 if self.compression is None
                else self.compression.wire_ratio(int(d)))

    # -- mix-mode resolution -------------------------------------------------

    def _resolve_mix_mode(self, mix: str) -> str:
        if mix not in ("auto", "dense", "sparse"):
            raise ValueError(f"mix must be auto/dense/sparse, got {mix!r}")
        if mix == "dense":
            return "dense"
        reasons = []
        if not self.graph.perms:
            reasons.append("graph has no permutation edge set")
        elif self.graph.degree + 1 >= self.graph.n:
            reasons.append("graph is (near-)complete: the matmul moves "
                           "less memory than a degree-(n-1) gather")
        if self.mix_weights is not None and not self._edge_supported():
            reasons.append("mix_weights has weight outside the graph's "
                           "edge support (non-regular P)")
        if reasons:
            if mix == "sparse":
                raise ValueError("sparse mix unavailable: "
                                 + "; ".join(reasons))
            return "dense"
        return "sparse"

    def _edge_supported(self) -> bool:
        """True if mix_weights only places weight on self-loops + edges."""
        W = self.mix_weights
        n = self.graph.n
        allowed = np.eye(n, dtype=bool)
        for perm in self.graph.perms:
            allowed[np.arange(n), np.asarray(perm)] = True
        return not np.any((W != 0.0) & ~allowed)

    def _sparse_weights(self):
        """(S_in, w_self, w_edge) for the gather path. S_in[i, j] is the
        node whose value node i receives in permutation slot j. Uniform
        weights stay scalars (Python floats holding the float32 values),
        so the plain version scales the SUM of the gathers once as the
        reference does; a `mix_weights` override becomes float32 vectors
        through `graphs.mix_weight_slots`."""
        g = self.graph
        S_in = np.stack([np.asarray(p, dtype=np.int64) for p in g.perms],
                        axis=1)  # (n, k)
        if self.mix_weights is None:
            return (S_in, float(np.float32(g.self_weight)),
                    float(np.float32(g.edge_weight)))
        w_slot, w_self = mix_weight_slots(self.mix_weights, S_in)
        return (S_in,
                torch.as_tensor(w_self, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(w_slot, dtype=torch.float32,
                                device=self.device))

    # -- the iteration -------------------------------------------------------

    def _mix(self, z: torch.Tensor, res: torch.Tensor, t: torch.Tensor,
             lanes: Callable | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """One consensus round: (mixed z, new residual). Under compression
        the messages are the corrected `z + res`, compressed, and the
        residual keeps what was not sent; `t` is the round's iteration
        counter, which the randomized compressors fold into their key.
        `lanes(fn, corrected)` applies a compressor per lane of a (n, B, d)
        carry (`_LaneProgram.lanes`); None for a one-run (n, d) state."""
        comp = self.compression
        if lanes is None:
            lanes = _solo
        if self.mix_mode == "sparse":
            from repro_torch.kernels import ops as _kops
            if comp is None:
                return _kops.gossip_gather_mix_impl(
                    z, self._S_in, self._w_self, self._w_edge), res
            corrected = z + res
            if comp.is_sparsifier:
                # the 0/1 support rides K2; the masked stack is formed
                # only for the residual
                mask = lanes(lambda c: comp.support_mask_torch(c, t),
                             corrected)
                mixed = _kops.compress_mix_impl(
                    z, corrected, mask, self._S_in, self._w_self,
                    self._w_edge)
                sent = corrected * mask
            else:
                sent = lanes(lambda c: comp.compress_torch(c, t),
                             corrected)
                mixed = _kops.gossip_gather_mix_impl(
                    z, self._S_in, self._w_self, self._w_edge, msg=sent)
        else:
            if comp is None:
                return _cons.mix_dense(z, self._P), res
            corrected = z + res
            sent = lanes(lambda c: comp.compress_torch(c, t), corrected)
            diag = self._P_diag.reshape((-1,) + (1,) * (z.dim() - 1))
            mixed = diag * z + _cons.mix_dense(sent, self._P_off)
        new_res = corrected - sent if comp.error_feedback else res
        return mixed, new_res

    def _segment(self, z, x, xhat, res, t, comm_mask) -> State:
        """Run `len(comm_mask)` iterations from the carry (z, x, xhat, res,
        t); t is the float32 0-d count of iterations already done. The
        counterpart of the reference's jitted `_segment`, minus its RNG keys
        (no registered problem reads them; the compressors derive theirs
        from t). A thin wrapper over the one-lane program run eagerly: it
        loads the carry, steps the program's bodies and hands back a copy
        of the carry, so there is one DDA iteration,
        `_LaneProgram._iterate`."""
        prog = self._program(z, 1, len(comm_mask), eager=True)
        prog.resume((z, x, xhat, res, t))
        for comm in comm_mask:
            prog.step("comm" if comm else "idle")
        return prog.carry()

    def _stats(self, z: torch.Tensor, xhat: torch.Tensor,
               res: torch.Tensor) -> torch.Tensor:
        """(Fbar, F(xhat_bar), disagreement, mean residual norm) of one
        run's (n, ...) z, xhat and res, on the device. The last is the mean
        over nodes of sqrt(sum(res_i ** 2)), the reference's order: the
        compression block's trajectory (zeros uncompressed)."""
        fv = torch.mean(torch.func.vmap(self.eval_fn)(xhat))
        fvc = self.eval_fn(torch.mean(xhat, dim=0))
        rn = torch.mean(torch.sqrt(torch.sum(
            res.reshape(res.shape[0], -1) ** 2, dim=-1)))
        return torch.stack([fv, fvc, _cons.disagreement(z), rn])

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- run loops -----------------------------------------------------------

    def run(self, x0_stack: torch.Tensor, T: int, eval_every: int = 25,
            seed: int = 0, loop: str = "scan") -> SimTrace:
        """Run T iterations, evaluating every `eval_every`.

        loop="scan" (default) is the run program at one lane (see the
        module docstring): captured on a CUDA card unless the simulator
        was built with capture=False, its trace statistics kept on the
        device and copied back once, after the last iteration.
        loop="segment" steps the same one-lane program eagerly (no graphs)
        and copies the statistics back after every segment, charging that
        readback to `last_timings["eval_s"]`. Both give the same trace, but
        only loop="scan" keeps `last_res_norms`, as in the reference, whose
        segment loop does not compute them. `seed` is accepted for the
        reference's signature; no registered problem draws random numbers.
        """
        self._check_x0(x0_stack)
        if loop not in ("scan", "segment"):
            raise ValueError(f"loop must be 'scan' or 'segment', got {loop!r}")
        self._reset_timings()
        if T == 0:  # an empty trace, as the reference returns
            return SimTrace([], [], [], [], [])
        mask_full = np.asarray(self.schedule.comm_mask(0, T), dtype=bool)
        # compressed messages are cheaper on the wire: the time axis charges
        # the effective tradeoff r*c
        r_eff = self.r * self.wire_ratio(int(np.prod(x0_stack.shape[1:])))
        if loop == "segment":
            fv, fvc, dis = self._run_segment_loop(x0_stack, T, eval_every,
                                                  mask_full)
            return self._assemble_trace(mask_full, T, eval_every, r_eff,
                                        fv, fvc, dis)
        fv, fvc, dis, rn = self._run_lanes(x0_stack, T, eval_every,
                                           mask_full[None])
        self.last_res_norms = rn[0]
        return self._assemble_trace(mask_full, T, eval_every, r_eff,
                                    fv[0], fvc[0], dis[0])

    def run_batch(self, x0_stack: torch.Tensor, T: int, eval_every: int,
                  masks: np.ndarray, seeds, rs=None) -> list[SimTrace]:
        """Run B independent lanes of this simulator as ONE program.

        Lanes share the problem closures, graph, stepsize and iteration
        count but may differ in comm pattern (`masks`, shape (B, T): sweep
        axes like `schedule.params.h` are data here), seed and time charge
        (`rs`, host-side only). The executor behind
        `repro_torch.experiments.run_sweep(parallel="vmap")`: one capture
        and one replayed program for a whole sweep grid. `seeds` is
        accepted for the reference's signature; no registered problem draws
        random numbers. `last_res_norms` becomes (B, S).
        """
        self._check_x0(x0_stack)
        masks = np.asarray(masks, dtype=bool)
        B = masks.shape[0]
        if masks.shape != (B, T):
            raise ValueError(f"masks must be (B, T={T}), got {masks.shape}")
        if len(seeds) != B:
            raise ValueError(f"{len(seeds)} seeds for {B} lanes")
        c = self.wire_ratio(int(np.prod(x0_stack.shape[1:])))
        rs = ([self.r * c] * B if rs is None
              else [float(r) * c for r in rs])
        if len(rs) != B:
            raise ValueError(f"{len(rs)} rs for {B} lanes")
        self._reset_timings()
        if T == 0:  # empty traces, as the reference returns
            return [SimTrace([], [], [], [], []) for _ in range(B)]
        fv, fvc, dis, rn = self._run_lanes(x0_stack, T, eval_every, masks)
        self.last_res_norms = rn
        return [self._assemble_trace(masks[b], T, eval_every, rs[b],
                                     fv[b], fvc[b], dis[b])
                for b in range(B)]

    def _check_x0(self, x0_stack: torch.Tensor) -> None:
        if x0_stack.shape[0] != self.graph.n:
            raise ValueError("x0 must be stacked (n, ...)")
        if x0_stack.device != self.device:
            raise ValueError(f"x0 lies on {x0_stack.device}, the simulator "
                             f"on {self.device}")

    def _reset_timings(self) -> None:
        self.last_timings = {"compile_s": 0.0, "execute_s": 0.0,
                             "eval_s": 0.0}
        self.last_res_norms = None
        self.last_loop = None

    def _load_library(self) -> None:
        """Build or load the mix kernel's library (the first use's build
        is charged to `compile_s`)."""
        if self.mix_mode == "sparse" and self.device.type == "cuda":
            t0 = time.perf_counter()
            self._kernel().library()
            self.last_timings["compile_s"] += time.perf_counter() - t0

    def _run_segment_loop(self, x0_stack, T, eval_every, mask_full):
        """loop="segment": the one-lane program run eagerly, its statistics
        read back after each segment. Returns (fv, fvc, dis), each (S,)."""
        prog = self._program(x0_stack, 1, T, eager=True)
        self.last_loop = "eager"
        self._synchronize()
        t0 = time.perf_counter()
        prog.load(x0_stack, mask_full[None])
        stats = []
        done = 0
        while done < T:
            seg = min(eval_every, T - done)
            for comm in mask_full[done:done + seg]:
                prog.step("comm" if comm else "idle")
            done += seg
            t_eval = time.perf_counter()
            prog.step("stats")
            stats.append(prog.stat[0].to("cpu", copy=True))
            self.last_timings["eval_s"] += time.perf_counter() - t_eval
        fv, fvc, dis, _ = torch.stack(stats).numpy().T
        self._synchronize()
        self.last_timings["execute_s"] = time.perf_counter() - t0
        return fv, fvc, dis

    def _program(self, x0_stack: torch.Tensor, B: int, T: int,
                 eager: bool = False) -> "_LaneProgram":
        """The run program for B lanes at x0's shape, built at its first
        use and on a card captured (unless `capture` is off, or `eager`
        asks for the program that `_segment` and loop="segment" step
        without graphs): the kernel library's load, the warm-up and the
        capture are charged to `compile_s`, once. A batch program is built
        anew only when its flag buffer is shorter than T."""
        key = (tuple(x0_stack.shape), x0_stack.dtype, B) + (
            ("eager",) if eager else ())
        prog = self._programs.get(key)
        if prog is None or (B > 1 and prog.rows < T):
            self._load_library()
            prog = _LaneProgram(self, x0_stack, B, T)
            if (not eager and self.capture
                    and self.device.type == "cuda"):
                t0 = time.perf_counter()
                # alone on the card: the capture, and the free of the
                # program it replaces
                with DEVICE_LOCK.exclusive():
                    prog.capture()
                    self._programs[key] = prog
                self.last_timings["compile_s"] += time.perf_counter() - t0
            else:
                self._programs[key] = prog
        return prog

    def release(self) -> None:
        """Free the run programs and their captured graphs, holding
        `DEVICE_LOCK` exclusively, so no capture of another thread sees a
        graph freed. The simulator stays usable: its next run builds (and
        captures) its programs anew. A caller that drops a simulator which
        ran on a card while another thread may capture releases it first;
        the experiments runner and the serving cache do."""
        with DEVICE_LOCK.exclusive():
            self._programs.clear()
            self._loop_prog = None

    def _run_lanes(self, x0_stack, T, eval_every, masks):
        """Drive the run program over (B, T) comm masks. Returns (fv, fvc,
        dis, rn), each (B, S)."""
        B = masks.shape[0]
        prog = self._program(x0_stack, B, T)
        self.last_loop = "eager" if prog.graphs is None else "graph"
        self._synchronize()
        t0 = time.perf_counter()
        prog.load(x0_stack, masks)
        any_comm = masks.any(axis=0)
        stats = torch.empty((-(-T // eval_every), B, 4), dtype=torch.float32,
                            device=self.device)
        done = idx = 0
        while done < T:
            seg = min(eval_every, T - done)
            for comm in any_comm[done:done + seg]:
                prog.step("comm" if comm else "idle")
            prog.step("stats")
            stats[idx].copy_(prog.stat)
            done += seg
            idx += 1
        out = stats.cpu().numpy().transpose(2, 1, 0)  # (4, B, S)
        prog.count_replays()
        self._synchronize()
        self.last_timings["execute_s"] = time.perf_counter() - t0
        return out

    # -- the closed loop's chunk driver --------------------------------------

    def start_closed_loop(self, x0_stack: torch.Tensor, T: int) -> None:
        """Ready a one-lane run of T iterations from x0 for a driver that
        picks each chunk's body as it goes (the closed loop,
        `experiments.runner._dense_adaptive_run`): the run program built
        at its first use (captured on a card unless `capture` is off; its
        build charged to `last_timings["compile_s"]`), loaded, and the
        device synchronized, so the first timed chunk (at h0 = 1 the
        controller's only plain sample) carries no set-up: neither the
        load, nor a graph's first replay (`_LaneProgram.capture` replays
        each graph once), nor the first replay after the load's kernels,
        which is slower than any later one (on an H100,
        `scripts/profile_torch_closed_loop.py`) and is made here with the
        statistics body, which writes only `stat`."""
        self._check_x0(x0_stack)
        self._reset_timings()
        prog = self._program(x0_stack, 1, T)
        self.last_loop = "eager" if prog.graphs is None else "graph"
        prog.load(x0_stack)
        if prog.graphs is not None:
            prog.graphs["stats"].replay()
        self._synchronize()
        self._loop_prog = prog

    def run_chunk(self, comm: bool, chunk: int) -> None:
        """`chunk` iterations of the closed loop's run, all with or all
        without communication, then a device synchronize: what the closed
        loop times as one chunk, and the seam a test wraps to charge a
        fake clock."""
        body = "comm" if comm else "idle"
        for _ in range(chunk):
            self._loop_prog.step(body)
        self._synchronize()

    def segment_stats(self) -> SegmentStats:
        """The closed loop's trace statistics at this point of its run,
        read back to the host."""
        prog = self._loop_prog
        prog.step("stats")
        return SegmentStats(*prog.stat[0].tolist())

    def end_closed_loop(self) -> None:
        """Count the closed loop's launches from its replays
        (`_LaneProgram.count_replays`, as `run` does) and let go of its
        program."""
        self._loop_prog.count_replays()
        self._loop_prog = None

    def _kernel(self):
        """The kernel module the sparse mix launches: K2 under a
        sparsifier, K1 otherwise."""
        if self.compression is not None and self.compression.is_sparsifier:
            from repro_torch.kernels import compress_mix
            return compress_mix
        from repro_torch.kernels import gossip_mix
        return gossip_mix

    def _assemble_trace(self, mask_full, T, eval_every, r,
                        fv, fvc, dis) -> SimTrace:
        """Host bookkeeping: the simulated time axis (eq. 9 charges) from
        the precomputed comm mask, accumulated segment-by-segment in the
        exact float order of the reference."""
        n, k = self.graph.n, self.graph.degree
        trace = SimTrace([], [], [], [], [])
        sim_time = 0.0
        comm_total = 0
        done = 0
        idx = 0
        while done < T:
            seg = min(eval_every, T - done)
            n_comm = int(mask_full[done:done + seg].sum())
            done += seg
            comm_total += n_comm
            sim_time += seg * (1.0 / n) + n_comm * k * r
            trace.iters.append(done)
            trace.sim_time.append(sim_time)
            trace.fvals.append(float(fv[idx]))
            trace.fvals_consensus.append(float(fvc[idx]))
            trace.comms.append(comm_total)
            trace.disagreement.append(float(dis[idx]))
            idx += 1
        return trace


def _solo(fn, *args):
    """`_mix`'s per-lane map for a one-run (n, d) state: fn itself."""
    return fn(*args)


# ---------------------------------------------------------------------------
# the run program
# ---------------------------------------------------------------------------


class _LaneProgram:
    """A run's carry for B lanes, as (n, B, ...) buffers updated in place
    (z, x, xhat, res; the shared counter t), and the three bodies that
    update it: one iteration with communication ("comm"), one without
    ("idle"), and the trace statistics of every lane ("stats", into the
    (B, 4) buffer `stat`).

    In a batch the comm body runs at every iteration where any lane
    communicates; each lane's flag is read on the device from `flags`
    (the (T, B) masks) at the counter `it`, so no mask is read on the host
    inside a body. A one-lane program has neither: the host picks the body.

    `capture()` records each body as a CUDA graph; `step` then replays it.
    The kernel wrappers count their launches in Python, which a replay does
    not run: so the launches each graph holds are recorded at its capture
    (every counter of `kernels.counters`), and `count_replays` adds them
    once for each replay.
    """

    BODIES = ("comm", "idle", "stats")
    #: passes over the bodies before the capture (their launches are run
    #: but not counted)
    WARMUP = 2

    def __init__(self, sim: DDASimulator, x0_stack: torch.Tensor, B: int,
                 T: int):
        # a weak reference: the simulator holds its programs, and a cycle
        # would leave a dropped simulator's graphs to the garbage
        # collector, which may run inside a later capture, where freeing a
        # graph is not allowed
        self.sim, self.B = weakref.proxy(sim), B
        n, rest = x0_stack.shape[0], tuple(x0_stack.shape[1:])
        like = dict(dtype=x0_stack.dtype, device=x0_stack.device)
        self.z, self.x, self.xhat, self.res = (
            torch.zeros((n, B) + rest, **like) for _ in range(4))
        self.t = torch.zeros((), dtype=torch.float32, device=sim.device)
        self.rows = T if B > 1 else 0
        self.flags = torch.zeros((self.rows, B), dtype=torch.bool,
                                 device=sim.device)
        self.it = torch.zeros((1,), dtype=torch.int64, device=sim.device)
        self.stat = torch.zeros((B, 4), dtype=torch.float32,
                                device=sim.device)
        self.graphs: dict[str, torch.cuda.CUDAGraph] | None = None
        self._launches: dict[str, dict[tuple, int]] = {}
        self._replays = dict.fromkeys(self.BODIES, 0)

    def lanes(self, fn, *args):
        """fn over each lane (dim 1) of the (n, B, ...) tensors `args`, its
        per-lane results stacked at dim 1. At B = 1 fn gets the lane
        itself, so a one-lane program issues the solo run's ops."""
        if self.B == 1:
            return fn(*(a[:, 0] for a in args)).unsqueeze(1)
        return torch.func.vmap(fn, in_dims=1, out_dims=1)(*args)

    def load(self, x0_stack: torch.Tensor,
             masks: np.ndarray | None = None) -> None:
        """Start a run from x0 (every lane) under the (B, T) comm masks (a
        one-lane program reads none: the host picks its bodies)."""
        for buf in (self.z, self.res, self.t, self.it):
            buf.zero_()
        for buf in (self.x, self.xhat):
            buf.copy_(x0_stack.unsqueeze(1).expand_as(buf))
        if self.B > 1:
            T = masks.shape[1]
            self.flags[:T].copy_(torch.as_tensor(masks.T.copy()))

    def resume(self, carry: State) -> None:
        """Continue a one-lane run from its carry (z, x, xhat, res, t),
        each (n, ...) but t, the 0-d count of iterations done."""
        if self.B != 1:
            raise ValueError("resume takes the carry of a one-lane run")
        for buf, v in zip((self.z, self.x, self.xhat, self.res), carry[:4]):
            buf.copy_(v.unsqueeze(1))
        self.t.copy_(carry[4])

    def carry(self) -> State:
        """A copy of a one-lane run's carry (z, x, xhat, res, t)."""
        return tuple(b[:, 0].clone() for b in (
            self.z, self.x, self.xhat, self.res)) + (self.t.clone(),)

    def _iterate(self, comm: bool) -> None:
        """One DDA iteration of every lane: the only one in the module,
        behind `run`, `run_batch`, `_segment` and the closed loop."""
        sim, z, x, xhat, res, t = (self.sim, self.z, self.x, self.xhat,
                                   self.res, self.t)
        g = self.lanes(lambda xl: sim.subgrad_fn(xl, t, None), x)
        if comm:
            mixed, new_res = sim._mix(z, res, t, self.lanes)
            if self.B > 1:  # a lane that does not communicate keeps z, res
                on = self.flags.index_select(0, self.it).reshape(
                    (1, self.B) + (1,) * (z.dim() - 2))
                mixed = torch.where(on, mixed, z)
                if new_res is not res:
                    new_res = torch.where(on, new_res, res)
            if new_res is not res:
                res.copy_(new_res)
            torch.add(mixed, g, out=z)
        else:
            z.add_(g)
        t_new = t + 1.0
        neg_a = -sim.a_fn(t_new)
        if sim.projection is None:
            torch.mul(neg_a, z, out=x)
        else:
            x.copy_(self.lanes(sim.projection, neg_a * z))
        torch.div(t * xhat + x, t_new, out=xhat)
        t.copy_(t_new)
        if self.B > 1:
            self.it.add_(1)

    def _stats(self) -> None:
        # lane by lane, each on a contiguous (n, ...) copy, as a one-lane
        # program reduces its run: a reduction over a strided lane of the
        # carry may add in another order on the card, and a lane's
        # statistics are its solo run's bit for bit only this way
        for b in range(self.B):
            self.stat[b].copy_(self.sim._stats(
                *(a[:, b].contiguous() for a in (self.z, self.xhat,
                                                 self.res))))

    def _body(self, name: str):
        # made at each call, not stored: stored closures over self would
        # make a cycle that leaves the program's graphs to the collector
        return {"comm": lambda: self._iterate(True),
                "idle": lambda: self._iterate(False),
                "stats": self._stats}[name]

    def capture(self) -> None:
        """Warm every body up on the buffers (before any run has loaded
        them, so on no run's state; the warm-up's launches are not
        counted), then capture each as a CUDA graph, into one memory pool,
        recording the launches it holds, and replay each graph once."""
        from repro_torch.kernels import counters

        # the caller holds DEVICE_LOCK exclusively; the counters' lock,
        # held throughout, keeps the launches between a snapshot and its
        # restore this capture's own
        with counters.LOCK:
            before = counters.snapshot()
            current = torch.cuda.current_stream(self.sim.device)
            side = torch.cuda.Stream(self.sim.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    for name in self.BODIES:
                        self._body(name)()
                        self.it.zero_()
            current.wait_stream(side)
            counters.restore(before)
            pool = torch.cuda.graph_pool_handle()
            graphs = {}
            # no collection inside a capture: it may free another graph
            # there
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                for name in self.BODIES:
                    graphs[name] = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graphs[name], pool=pool):
                        self._body(name)()
                    self._launches[name] = counters.delta(
                        before, counters.snapshot())
                    counters.restore(before)
            finally:
                if gc_was_on:
                    gc.enable()
        # a graph's first replay also uploads it to the card: made here,
        # on no run's state and not counted, so no run times it
        for name in self.BODIES:
            graphs[name].replay()
        torch.cuda.synchronize(self.sim.device)
        self.graphs = graphs

    def step(self, name: str) -> None:
        """Run one body: replay its graph, or call it eagerly."""
        if self.graphs is None:
            self._body(name)()
        else:
            self.graphs[name].replay()
            self._replays[name] += 1

    def count_replays(self) -> None:
        """Add each graph's launches once for each replay since the last
        call to the wrappers' counters."""
        if self.graphs is None:
            return
        from repro_torch.kernels import counters

        for name, k in self._replays.items():
            counters.add(self._launches[name], k)
        self._replays = dict.fromkeys(self.BODIES, 0)
