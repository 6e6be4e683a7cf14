"""Asynchronous DDA nodes for the event-driven cluster simulator.

Two variants, both host-side (numpy state; gradients may come from torch
closures via the simulator's `grad_fn`):

  * `AsyncDDANode`   -- stale-gossip DDA. Mixing mirrors the reference's
    `repro.core.consensus.mix_stale`: a communication iteration mixes with
    the LATEST values already received from each in-neighbor (one-or-more
    rounds stale, depending on link delay) via the shared
    `consensus.stale_combine`; the weight of any neighbor that has never
    delivered (or whose message was dropped) folds back into the self
    weight, keeping every update a convex combination exactly like a
    deadline-degraded round.

  * `PushSumDDANode` -- push-sum dual averaging with per-link cumulative
    mass counters (the sigma/rho construction of robust ratio consensus).
    Messages carry the cumulative mass ever sent on the link, so a dropped
    packet's mass is automatically recovered by the next successful one:
    total (value, weight) mass is conserved under arbitrary i.i.d. drops
    and directed/time-varying links -- the regime where plain stale gossip
    loses doubly-stochasticity. Estimates are the ratio y/w.

Iteration bookkeeping matches core.dda exactly (1-indexed iterations,
z <- mix(z) + g, x = -a(t) z, running xhat average), so traces are
comparable with `DDASimulator` runs step-for-step.

These classes are the OBJECT-engine representation (netsim.engine
ObjectEngine drives them one event at a time) and the interop surface of
the vectorized engine: after a vectorized run, `NetSimulator.nodes`
materializes equivalent instances from the struct-of-arrays state, so
diagnostics written against per-node objects (`pushsum_mass_audit`, direct
`.z_est` reads) work over either backend.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.core.consensus import stale_combine
from repro_torch.core.schedules import CommSchedule, EveryIteration
from repro_torch.netsim.network import Network

__all__ = ["AsyncDDANode", "PushSumDDANode", "pushsum_mass_audit"]

GradFn = Callable[[int, np.ndarray, int], np.ndarray]


class _NodeBase:
    def __init__(self, i: int, x0: np.ndarray, grad_fn: GradFn,
                 a_fn: Callable[[float], float],
                 schedule: CommSchedule | None = None,
                 projection: Callable[[np.ndarray], np.ndarray] | None = None):
        self.i = i
        self.x = np.array(x0, dtype=np.float64)
        self.xhat = self.x.copy()
        self.t = 0
        self.grad_fn = grad_fn
        self.a_fn = a_fn
        self.schedule = schedule or EveryIteration()
        self.projection = projection
        self.next_comm = self.schedule.next_comm_step(0)
        self.comm_iters = 0

    def is_comm_next(self) -> bool:
        """Will the iteration about to run (t+1) communicate?"""
        return self.t + 1 == self.next_comm

    def _advance(self, z_est: np.ndarray) -> None:
        t_new = self.t + 1
        a_t = float(self.a_fn(float(t_new)))
        x_new = -a_t * z_est
        if self.projection is not None:
            x_new = self.projection(x_new)
        self.xhat = (self.t * self.xhat + x_new) / t_new
        self.x = x_new
        self.t = t_new

    def finish_step(self, net: Network) -> list[tuple[int, Any]]:
        """Complete iteration t+1; returns (dst, payload) messages to ship."""
        raise NotImplementedError

    def receive(self, src: int, payload: Any) -> None:
        raise NotImplementedError

    @property
    def z_est(self) -> np.ndarray:
        """Current dual estimate (for disagreement diagnostics)."""
        raise NotImplementedError


class AsyncDDANode(_NodeBase):
    def __init__(self, i, x0, grad_fn, a_fn, schedule=None, projection=None,
                 compression=None):
        super().__init__(i, x0, grad_fn, a_fn, schedule, projection)
        self.z = np.zeros_like(self.x)
        # latest value per in-neighbor: src -> (sender iteration stamp, z)
        self.inbox: dict[int, tuple[int, np.ndarray]] = {}
        # Optional `repro_torch.compress.Compressor`: outgoing payloads are
        # compressed with error feedback (the residual lives HERE, on the
        # sender), while the node's own z stays exact -- mirroring
        # DDASimulator's diagonal semantics where compression only touches
        # what crosses the wire. `compress_np` is a pure function of
        # (message, node, stamp), so the vectorized engine reproduces these
        # payloads bit-for-bit regardless of event interleaving.
        self.compression = compression
        self._comp_res = (None if compression is None
                          else np.zeros_like(self.x))

    @property
    def z_est(self) -> np.ndarray:
        return self.z

    def _stale_mix(self, net: Network) -> np.ndarray:
        g = net.graph
        W = net.mix_weights
        if W is None:
            acc = np.zeros_like(self.z)
            missing = 0
            for src in net.in_neighbors(self.i):
                entry = self.inbox.get(src)
                if entry is None:
                    missing += 1
                else:
                    acc += entry[1]
            # fold undelivered neighbors' weight into self: row stays
            # stochastic
            sw = g.self_weight + missing * g.edge_weight
            return stale_combine(self.z, g.edge_weight * acc, sw)
        # reweighted gossip: per-edge weights W[i, src] instead of the
        # uniform edge weight. W[i, src] is the TOTAL weight of the (i, src)
        # pair, so a src occupying multiple permutation slots contributes
        # W[i, src] / multiplicity per slot -- identical totals either way,
        # and the same convention the vectorized engine applies.
        in_nb = net.in_neighbors(self.i)
        mult: dict[int, int] = {}
        for src in in_nb:
            mult[src] = mult.get(src, 0) + 1
        acc = np.zeros_like(self.z)
        sw = float(W[self.i, self.i])
        for src in in_nb:
            w = float(W[self.i, src]) / mult[src]
            entry = self.inbox.get(src)
            if entry is None:
                sw += w
            else:
                acc += w * entry[1]
        return stale_combine(self.z, acc, sw)

    def finish_step(self, net: Network) -> list[tuple[int, Any]]:
        t_new = self.t + 1
        grad = np.asarray(self.grad_fn(self.i, self.x, self.t),
                          dtype=np.float64)
        msgs: list[tuple[int, Any]] = []
        if t_new == self.next_comm:
            comp = self.compression
            if comp is None:
                buf = self.z.copy()  # ship pre-mix z (mix_stale)
            else:
                corrected = self.z + self._comp_res
                buf = comp.compress_np(corrected, self.i, t_new)
                if comp.error_feedback:
                    self._comp_res = corrected - buf
            payload = (t_new, buf)
            msgs = [(dst, payload) for dst in net.out_neighbors(self.i)]
            z_new = self._stale_mix(net) + grad
            self.next_comm = self.schedule.next_comm_step(t_new)
            self.comm_iters += 1
        else:
            z_new = self.z + grad
        self.z = z_new
        self._advance(z_new)
        return msgs

    def receive(self, src: int, payload: tuple[int, np.ndarray]) -> None:
        stamp, value = payload
        cur = self.inbox.get(src)
        if cur is None or stamp > cur[0]:
            self.inbox[src] = (stamp, value)


class PushSumDDANode(_NodeBase):
    def __init__(self, i, x0, grad_fn, a_fn, schedule=None, projection=None,
                 y0: np.ndarray | None = None, w_floor: float = 0.5,
                 inject: str = "plain"):
        super().__init__(i, x0, grad_fn, a_fn, schedule, projection)
        self.y = (np.zeros_like(self.x) if y0 is None
                  else np.array(y0, dtype=np.float64))
        self.w = 1.0
        if inject not in ("plain", "scaled"):
            raise ValueError(f"inject must be 'plain' or 'scaled', "
                             f"got {inject!r}")
        # Gradient injection mode. "plain" adds the raw gradient to y each
        # step (the textbook subgradient-push update). "scaled" adds
        # w * grad instead: a node holding little weight mass injects
        # proportionally little value mass, so the ratio estimate sees the
        # gradient at its TRUE magnitude (w*g / w = g) instead of the
        # loss-amplified g / w. Where the plain+floor combination damps the
        # whole estimate by min(1, w/w_floor) whenever w < w_floor, scaled
        # injection leaves the mixed mass untouched and only attenuates the
        # newly injected gradient (by w/w_floor through the clamped
        # denominator) -- the bias applies to one step's gradient, not the
        # accumulated state, so it SHRINKS as mixing pulls w back toward 1
        # and vanishes above the floor. Opt-in ("plain" default) because
        # it changes seeded trajectories.
        self.inject = inject
        # Ratio guard: under sustained loss a standing fraction of weight
        # mass lives in the sigma-rho limbo, so held w_i dwells well below
        # 1 while freshly injected gradients sit in y at full magnitude --
        # the ratio y/w then amplifies them by 1/w and the primal feedback
        # loop x = -a(t) y/w can diverge. Clamping the DENOMINATOR only
        # (mass bookkeeping stays exact, so conservation and the audit
        # invariant are untouched) caps that amplification at 1/w_floor;
        # the estimate is conservatively damped instead, the same basin
        # guard as robust ratio-consensus clamps (z >= c*I).
        #
        # Quantified bias (tests/test_netsim.py::test_pushsum_w_floor_*):
        # because only the denominator is clamped, the guarded estimate is
        # EXACTLY the exact ratio damped per node,
        #   z_floor = (y/w) * min(1, w / w_floor),
        # so the relative bias is bounded by max(0, 1 - w/w_floor) -- at
        # most 100%, always a shrink toward zero (never a sign flip or
        # amplification), nonzero only while w dwells below the floor, and
        # decaying as mixing pulls w back toward 1. What it buys: under 60%
        # loss with gradient injection, the unguarded ratio (w_floor ~ 0)
        # blows the objective up by > 1e6x while the default guard keeps
        # the whole trajectory within ~10x of F(x0).
        self.w_floor = w_floor
        # cumulative mass SENT per out-link (dst -> totals)
        self.sigma_y: dict[int, np.ndarray] = {}
        self.sigma_w: dict[int, float] = {}
        # cumulative mass RECEIVED per in-link (src -> totals)
        self.rho_y: dict[int, np.ndarray] = {}
        self.rho_w: dict[int, float] = {}

    @property
    def z_est(self) -> np.ndarray:
        return self.y / max(self.w, self.w_floor)

    def finish_step(self, net: Network) -> list[tuple[int, Any]]:
        t_new = self.t + 1
        grad = np.asarray(self.grad_fn(self.i, self.x, self.t),
                          dtype=np.float64)
        msgs: list[tuple[int, Any]] = []
        if t_new == self.next_comm:
            out = net.out_neighbors(self.i)
            share = 1.0 / (len(out) + 1)
            y_share, w_share = self.y * share, self.w * share
            for dst in out:
                if dst not in self.sigma_y:
                    self.sigma_y[dst] = np.zeros_like(self.y)
                    self.sigma_w[dst] = 0.0
                self.sigma_y[dst] = self.sigma_y[dst] + y_share
                self.sigma_w[dst] += w_share
                # cumulative totals: a later delivery supersedes (and thereby
                # recovers) any dropped earlier message on this link
                msgs.append((dst, (self.sigma_y[dst].copy(),
                                   self.sigma_w[dst])))
            self.y, self.w = y_share, w_share
            self.next_comm = self.schedule.next_comm_step(t_new)
            self.comm_iters += 1
        if self.inject == "scaled":
            self.y = self.y + self.w * grad
        else:
            self.y = self.y + grad
        self._advance(self.z_est)
        return msgs

    def receive(self, src: int, payload: tuple[np.ndarray, float]) -> None:
        S_y, S_w = payload
        if src not in self.rho_y:
            self.rho_y[src] = np.zeros_like(self.y)
            self.rho_w[src] = 0.0
        if S_w >= self.rho_w[src]:  # ignore out-of-order older messages
            self.y = self.y + (S_y - self.rho_y[src])
            self.w += S_w - self.rho_w[src]
            self.rho_y[src] = S_y
            self.rho_w[src] = S_w


def pushsum_mass_audit(nodes: list[PushSumDDANode]
                       ) -> tuple[np.ndarray, float]:
    """Total (value, weight) mass held by the network, counting mass that is
    in flight or was dropped-but-recoverable on each directed link as
    (cumulative sent sigma) - (cumulative received rho).

    Invariant: with zero gradients the value total equals sum_i y_i(0) and
    the weight total equals n, at EVERY instant, under arbitrary packet loss
    -- this is the conservation property that makes push-sum's ratio
    estimate unbiased where plain gossip under drops is not
    (tests/test_netsim.py::test_pushsum_mass_conservation_under_drops).
    """
    y_total = np.sum([nd.y for nd in nodes], axis=0)
    w_total = float(sum(nd.w for nd in nodes))
    rho_y = {(src, nd.i): v for nd in nodes for src, v in nd.rho_y.items()}
    rho_w = {(src, nd.i): v for nd in nodes for src, v in nd.rho_w.items()}
    for nd in nodes:
        for dst, sig in nd.sigma_y.items():
            y_total = y_total + sig - rho_y.get((nd.i, dst), 0.0)
        for dst, sig in nd.sigma_w.items():
            w_total += sig - rho_w.get((nd.i, dst), 0.0)
    return y_total, w_total
