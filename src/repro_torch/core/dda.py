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
P @ z matmul. The comm pattern is host data (`CommSchedule.comm_mask`), so
the reference's `lax.cond` is a Python `if` that never waits for the device,
and the trace statistics stay on the device until one copy at the end of
the run. The vmapped `run_batch` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import consensus as _cons
from repro_torch.core.graphs import CommGraph, mix_weight_slots
from repro_torch.core.schedules import CommSchedule, EveryIteration

__all__ = [
    "DDASimulator",
    "SimTrace",
    "TRACE_FIELDS",
    "json_sanitize",
    "stepsize_sqrt",
    "trace_time_to_reach",
]

#: the carry of one run: (z, x, xhat, res, t), as the reference's scan carry
State = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


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
    """

    def __init__(self, subgrad_fn, eval_fn, graph: CommGraph,
                 schedule: CommSchedule | None = None,
                 a_fn=None, projection=None, r: float = 0.0,
                 compress_keep: float | None = None,
                 mix: str = "auto",
                 mix_weights: np.ndarray | None = None,
                 compression=None, *, device=None):
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

    def _mix(self, z: torch.Tensor, res: torch.Tensor, t: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """One consensus round: (mixed z, new residual). Under compression
        the messages are the corrected `z + res`, compressed, and the
        residual keeps what was not sent; `t` is the round's iteration
        counter, which the randomized compressors fold into their key."""
        comp = self.compression
        if self.mix_mode == "sparse":
            from repro_torch.kernels import ops as _kops
            if comp is None:
                return _kops.gossip_gather_mix_impl(
                    z, self._S_in, self._w_self, self._w_edge), res
            corrected = z + res
            if comp.is_sparsifier:
                # the 0/1 support rides K2; the masked stack is formed
                # only for the residual
                mask = comp.support_mask_torch(corrected, t)
                mixed = _kops.compress_mix_impl(
                    z, corrected, mask, self._S_in, self._w_self,
                    self._w_edge)
                sent = corrected * mask
            else:
                sent = comp.compress_torch(corrected, t)
                mixed = _kops.gossip_gather_mix_impl(
                    z, self._S_in, self._w_self, self._w_edge, msg=sent)
        else:
            if comp is None:
                return _cons.mix_dense(z, self._P), res
            corrected = z + res
            sent = comp.compress_torch(corrected, t)
            mixed = (self._P_diag[:, None] * z
                     + _cons.mix_dense(sent, self._P_off))
        new_res = corrected - sent if comp.error_feedback else res
        return mixed, new_res

    def _segment(self, z, x, xhat, res, t, comm_mask) -> State:
        """Run `len(comm_mask)` iterations from the carry (z, x, xhat, res,
        t); t is the float32 0-d count of iterations already done. The
        counterpart of the reference's jitted `_segment`, minus its RNG keys
        (no registered problem reads them; the compressors derive theirs
        from t)."""
        for comm in comm_mask:
            g = self.subgrad_fn(x, t, None)
            if comm:
                z_mixed, res = self._mix(z, res, t)
            else:
                z_mixed = z
            z = z_mixed + g
            t_new = t + 1.0
            a_t = self.a_fn(t_new)
            x_new = -a_t * z
            if self.projection is not None:
                x_new = self.projection(x_new)
            xhat = (t * xhat + x_new) / t_new
            x, t = x_new, t_new
        return z, x, xhat, res, t

    def _trace_stats(self, state: State) -> torch.Tensor:
        """(Fbar, F(xhat_bar), disagreement, mean residual norm) of a
        carry, on the device. The last is the mean over nodes of
        sqrt(sum(res_i ** 2)), the reference's order: the compression
        block's trajectory (zeros uncompressed)."""
        z, _, xhat, res, _ = state
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

        loop="scan" (default) keeps each segment's trace statistics on the
        device and copies them back once, after the last iteration.
        loop="segment" copies them back after every segment and charges
        that readback to `last_timings["eval_s"]`. Both give the same
        trace, but only loop="scan" keeps `last_res_norms`, as in the
        reference, whose segment loop does not compute them. `seed` is
        accepted for the reference's signature; no registered problem
        draws random numbers.
        """
        if x0_stack.shape[0] != self.graph.n:
            raise ValueError("x0 must be stacked (n, ...)")
        if x0_stack.device != self.device:
            raise ValueError(f"x0 lies on {x0_stack.device}, the simulator "
                             f"on {self.device}")
        if loop not in ("scan", "segment"):
            raise ValueError(f"loop must be 'scan' or 'segment', got {loop!r}")
        self.last_timings = {"compile_s": 0.0, "execute_s": 0.0,
                             "eval_s": 0.0}
        self.last_res_norms = None
        if T == 0:  # an empty trace, as the reference returns
            return SimTrace([], [], [], [], [])
        if self.mix_mode == "sparse" and self.device.type == "cuda":
            t0 = time.perf_counter()
            self._kernel().library()
            self.last_timings["compile_s"] = time.perf_counter() - t0
        mask_full = np.asarray(self.schedule.comm_mask(0, T), dtype=bool)

        self._synchronize()
        t0 = time.perf_counter()
        state = (torch.zeros_like(x0_stack), x0_stack, x0_stack,
                 torch.zeros_like(x0_stack),
                 torch.zeros((), dtype=torch.float32, device=self.device))
        stats = []
        done = 0
        while done < T:
            seg = min(eval_every, T - done)
            state = self._segment(*state, mask_full[done:done + seg])
            done += seg
            if loop == "scan":
                stats.append(self._trace_stats(state))
            else:
                t_eval = time.perf_counter()
                stats.append(self._trace_stats(state).cpu())
                self.last_timings["eval_s"] += time.perf_counter() - t_eval
        fv, fvc, dis, rn = torch.stack(stats).cpu().numpy().T
        self._synchronize()
        self.last_timings["execute_s"] = time.perf_counter() - t0
        if loop == "scan":
            self.last_res_norms = rn
        # compressed messages are cheaper on the wire: the time axis charges
        # the effective tradeoff r*c
        r_eff = self.r * self.wire_ratio(int(np.prod(x0_stack.shape[1:])))
        return self._assemble_trace(mask_full, T, eval_every, r_eff,
                                    fv, fvc, dis)

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
