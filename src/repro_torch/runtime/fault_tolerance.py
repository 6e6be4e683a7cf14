"""Fault tolerance: straggler-tolerant consensus, the port of
`repro.runtime.fault_tolerance` (host numpy, bit for bit).

The paper's motivation (section I): consensus algorithms are "immune to slow
nodes that use part of their computation and communication resources for
unrelated tasks" and tolerate delays (ref [9]). In a round where a
neighbor's message misses its deadline, its weight folds back into the
receiver's self weight (rows stay stochastic, so iterates stay in the
convex hull): `degraded_matrix` is one such round's mixing matrix, and
`effective_round_time` its wall time, which the stragglers past the
deadline do not gate. `StragglerModel` draws, per round, which nodes are
slow (the reference's numpy stream, so the same seed gives the same
draws). `arrival_reweighted_matrix` is the expectation of a degraded round
over per-sender arrival probabilities, and `sinkhorn_project` rebalances
it to doubly stochastic, which `repro_torch.adaptive.StragglerReweighter`
needs before it trusts the matrix's lambda2. Stale mixing is the netsim
nodes' `core.consensus.stale_combine`; crash and restart are the netsim
fault layer (`repro_torch.faults`) and `repro_torch.checkpoint`; a change
of membership is `runtime.elastic`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graphs import CommGraph


@dataclasses.dataclass
class StragglerModel:
    """Per-node slowdown for tests and benchmarks: each round each node is
    slow with probability p_slow (multiplier m_slow), and a message misses
    the deadline when its sender's time exceeds it."""

    p_slow: float = 0.1
    m_slow: float = 4.0          # slowdown multiplier for a straggling node
    deadline: float = 2.0        # in units of the median round time
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def sample_round(self, n: int) -> np.ndarray:
        """Per-node completion time for one round (median-normalized)."""
        slow = self._rng.random(n) < self.p_slow
        return np.where(slow, self.m_slow, 1.0)

    def arrival_mask(self, n: int) -> np.ndarray:
        """mask[j] = True if node j's message makes the deadline."""
        return self.sample_round(n) <= self.deadline


def degraded_matrix(graph: CommGraph, arrived: np.ndarray) -> np.ndarray:
    """Mixing matrix for a round where only `arrived[j]` messages landed.

    Every weight p_ij for a missing j (j != i) is folded into p_ii: rows
    stay stochastic and the update remains a convex combination. The result
    is generally NOT doubly stochastic -- consensus-weighted averaging with
    occasional drop rounds still converges when drops are independent and
    the expected graph is connected."""
    P = graph.mixing_matrix().copy()
    n = P.shape[0]
    for j in range(n):
        if not arrived[j]:
            col = P[:, j].copy()
            for i in range(n):
                if i != j:
                    P[i, i] += col[i]
                    P[i, j] = 0.0
    return P


def effective_round_time(times: np.ndarray, deadline: float,
                         comm_cost: float) -> float:
    """Wall time of a deadline-gossip round: stragglers beyond the deadline
    do NOT gate the round (that is the point); the round costs the deadline
    plus the communication term."""
    return float(min(times.max(), deadline) + comm_cost)


def arrival_reweighted_matrix(P: np.ndarray,
                              arrive_prob: np.ndarray) -> np.ndarray:
    """EXPECTED mixing matrix when sender j's message lands in time with
    probability `arrive_prob[j]` (independently per round).

    In one round, a late sender's weight folds into the receiver's self
    weight; averaging over Bernoulli arrival masks gives, in closed form,

        P'_ij = p_ij * a_j                    (j != i)
        P'_ii = p_ii + sum_{j != i} p_ij (1 - a_j)

    -- each straggler's weight shrinks toward the receiver's self weight in
    proportion to how often it misses. Rows stay exactly stochastic;
    columns generally do not (a slow sender is under-heard), which is why
    the closed-loop controller (`repro_torch.adaptive.StragglerReweighter`)
    re-balances the result with `sinkhorn_project` before trusting its
    lambda2 for h_opt.
    """
    P = np.asarray(P, dtype=np.float64)
    a = np.asarray(arrive_prob, dtype=np.float64)
    if not np.all((a >= 0.0) & (a <= 1.0)):  # also rejects NaN
        raise ValueError("arrival probabilities must lie in [0, 1] "
                         "(and contain no NaN)")
    Pr = P * a[None, :]
    lost = P @ (1.0 - a) - np.diag(P) * (1.0 - a)   # mass from late senders
    np.fill_diagonal(Pr, np.diag(P) + lost)
    return Pr


def sinkhorn_project(P: np.ndarray, iters: int = 20000,
                     tol: float = 1e-9, accept_tol: float = 1e-6
                     ) -> np.ndarray:
    """Nearest-in-KL doubly-stochastic rescaling D1 @ P @ D2 (Sinkhorn-Knopp).

    Requires a nonnegative P with total support; every mixing matrix here
    has a strictly positive diagonal, which is sufficient. Iterates to
    `tol`; the budget covers the slowest realistic case (a 64-ring with
    floor-clamped stragglers balances in ~11k iterations; well-connected
    graphs take a few hundred). If the budget runs out but the residual is
    already below `accept_tol` -- imbalance far below anything a lambda2
    estimate can feel -- the near-balanced matrix is returned; a residual
    above that means the input genuinely lacks support (or the caller's
    model broke), and raising beats silently poisoning the spectral-gap
    estimate downstream.
    """
    P = np.asarray(P, dtype=np.float64).copy()
    if np.any(P < 0.0):
        raise ValueError("sinkhorn_project needs a nonnegative matrix")
    for _ in range(iters):
        P /= P.sum(axis=1, keepdims=True)
        P /= P.sum(axis=0, keepdims=True)
        if (np.abs(P.sum(axis=1) - 1.0).max() < tol
                and np.abs(P.sum(axis=0) - 1.0).max() < tol):
            return _resymmetrize(P)
    resid = max(np.abs(P.sum(axis=1) - 1.0).max(),
                np.abs(P.sum(axis=0) - 1.0).max())
    if resid < accept_tol:
        return _resymmetrize(P)
    raise ValueError(
        f"Sinkhorn failed to reach doubly-stochastic within {iters} iters "
        f"(residual {resid:.2e} > accept_tol {accept_tol:.0e})")


def _resymmetrize(P: np.ndarray) -> np.ndarray:
    """The Sinkhorn limit of the arrival-reweighted matrices built here (a
    symmetric base times per-sender arrival scalings) is symmetric, but
    the finite iterate carries ~tol asymmetry because it stops right
    after a row pass. When the residual asymmetry is at iteration-residue
    scale, averaging with the transpose snaps it to EXACT symmetry at no
    cost to the row/column sums (the perturbation is bounded by the same
    residue) -- and lets downstream lambda2() take its exact-symmetry
    `eigvalsh` fast path instead of paying general `eigvals` on every
    controller retune. A genuinely asymmetric result is left alone."""
    if np.allclose(P, P.T, rtol=0.0, atol=1e-8):
        return (P + P.T) / 2.0
    return P
