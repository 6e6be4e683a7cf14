"""Communication graph topologies for consensus-based distributed optimization.

The paper (Tsianos, Lawlor, Rabbat 2012) studies DDA over a user-defined
communication graph G = (V, E) with a doubly-stochastic mixing matrix P whose
second-largest eigenvalue magnitude lambda_2 controls the convergence constant
C_1 = 2LR * sqrt(19 + 12 / (1 - sqrt(lambda_2)))          (eq. 7).

Everything here is *host-side* (numpy): the n x n matrix P is never shipped to
device. Devices see only the per-edge structure (`shift_edges`) which maps each
graph edge set onto `jax.lax.ppermute` permutations -- the TPU-native
realization of point-to-point messages.

Design notes
------------
* All graphs are built as **circulant** graphs where possible (ring, complete,
  hypercube-on-ring, expanders via quadratic-residue / chordal shifts). A
  circulant edge set {±s_1, ..., ±s_k} means every mixing round is a set of
  uniform-shift ppermutes -- the cheapest collective pattern on an ICI torus.
* Mixing weights: lazy Metropolis / max-degree uniform weights
  P = I - (L_G / (k+1)) for k-regular G, which is symmetric doubly stochastic
  with p_ij = 1/(k+1) on edges (including self-loop weight 1/(k+1)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "CommGraph",
    "GraphSequence",
    "complete_graph",
    "ring_graph",
    "torus_graph",
    "hypercube_graph",
    "kregular_expander",
    "random_regular_expander",
    "expander_sequence",
    "build_graph",
    "mix_weight_slots",
    "doubly_stochastic_matrix",
    "lambda2",
    "spectral_gap",
]


@dataclasses.dataclass(frozen=True)
class CommGraph:
    """A k-regular communication graph over n consensus nodes.

    Attributes:
      name: topology identifier.
      n: number of consensus nodes (paper: processors).
      shifts: circulant shift set S (each s in S contributes edges i -> i+s
        mod n AND i -> i-s mod n unless s == n-s mod n). For non-circulant
        graphs `shifts` is None and `edges` carries an explicit permutation
        list instead.
      perms: list of permutations (each a tuple of length n, perm[i] = the
        node whose value node i RECEIVES). Every mixing round applies each
        permutation once -- this is exactly the ppermute source list.
      self_weight / edge_weight: lazy uniform mixing weights; P = sw*I on the
        diagonal and ew per received message.
    """

    name: str
    n: int
    perms: tuple[tuple[int, ...], ...]
    self_weight: float
    edge_weight: float

    @property
    def degree(self) -> int:
        return len(self.perms)

    @property
    def k(self) -> int:  # paper notation
        return self.degree

    def mixing_matrix(self) -> np.ndarray:
        """Doubly-stochastic P (host-side oracle, used for analysis/tests)."""
        n = self.n
        P = np.eye(n) * self.self_weight
        for perm in self.perms:
            for i in range(n):
                P[i, perm[i]] += self.edge_weight
        return P

    def lambda2(self) -> float:
        return lambda2(self.mixing_matrix())

    def spectral_gap(self) -> float:
        return 1.0 - math.sqrt(max(self.lambda2(), 0.0))

    def ppermute_pairs(self) -> tuple[tuple[tuple[int, int], ...], ...]:
        """Per-edge (source, destination) pairs for jax.lax.ppermute.

        ppermute takes [(src, dst), ...]; node dst receives from src. Our
        perms store perm[i] = src for receiver i.
        """
        out = []
        for perm in self.perms:
            out.append(tuple((int(perm[i]), int(i)) for i in range(self.n)))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class GraphSequence:
    """Time-varying topology: a periodic sequence of same-n graphs.

    The paper's analysis fixes G, but its cluster motivation (and the
    Yarmoshik-Klimenko time-varying lower bound in PAPERS.md) concerns
    networks whose edge set changes over time. `at(idx)` returns the graph
    active for the idx-th epoch (the netsim rewires every `rewire_every`
    sim-time units); B-connectedness holds trivially since every member is
    itself connected.
    """

    graphs: tuple[CommGraph, ...]

    def __post_init__(self):
        if not self.graphs:
            raise ValueError("GraphSequence needs at least one graph")
        sizes = {g.n for g in self.graphs}
        if len(sizes) != 1:
            raise ValueError(f"all graphs must share n, got {sorted(sizes)}")

    @property
    def n(self) -> int:
        return self.graphs[0].n

    def __len__(self) -> int:
        return len(self.graphs)

    def at(self, idx: int) -> CommGraph:
        return self.graphs[idx % len(self.graphs)]

    def lambda2_worst(self) -> float:
        """Pessimistic per-round mixing rate: max over the sequence (each
        round contracts disagreement by at most sqrt(lambda2) of the graph
        active that round)."""
        return max(g.lambda2() for g in self.graphs)


def expander_sequence(n: int, k: int = 4, length: int = 4,
                      seed: int = 0) -> GraphSequence:
    """`length` independently-rewired random k-regular expanders. Each draw
    is near-Ramanujan, so the sequence keeps a constant spectral gap while
    the edge set changes completely between epochs."""
    return GraphSequence(tuple(
        random_regular_expander(n, k=k, seed=seed + i) for i in range(length)))


def _circulant_perms(n: int, shifts: Sequence[int]) -> tuple[tuple[int, ...], ...]:
    """Each shift s gives a permutation perm[i] = (i - s) mod n, i.e. node i
    receives the value of node i-s (value travels +s around the ring)."""
    perms = []
    for s in shifts:
        s = s % n
        if s == 0:
            continue
        perms.append(tuple((i - s) % n for i in range(n)))
    return tuple(perms)


def _lazy_weights(k: int) -> tuple[float, float]:
    """Uniform max-degree weights: self 1/(k+1), each neighbor 1/(k+1)."""
    return 1.0 / (k + 1), 1.0 / (k + 1)


def complete_graph(n: int) -> CommGraph:
    """All-pairs communication. k = n-1, lambda_2 = 0 (exact average each
    round). Maps to an all-reduce (psum) on device rather than n-1 permutes;
    `consensus.py` special-cases it."""
    if n < 1:
        raise ValueError("n must be >= 1")
    perms = _circulant_perms(n, range(1, n))
    sw, ew = 1.0 / n, 1.0 / n
    return CommGraph("complete", n, perms, sw, ew)


def ring_graph(n: int) -> CommGraph:
    """Bidirectional ring: k=2 (k=1 for n=2). Worst-case expander; spectral
    gap O(1/n^2). Included as the pessimistic baseline topology."""
    if n < 2:
        raise ValueError("ring needs n >= 2")
    shifts = [1] if n == 2 else [1, n - 1]
    perms = _circulant_perms(n, shifts)
    sw, ew = _lazy_weights(len(perms))
    return CommGraph("ring", n, perms, sw, ew)


def torus_graph(n: int) -> CommGraph:
    """2D torus ring-of-rings: requires n = a*b with a = isqrt(n). k=4.
    Matches physical ICI torus wiring. Spectral gap O(1/n)."""
    a = int(math.isqrt(n))
    if a * a != n:
        raise ValueError(f"torus needs a square n, got {n}")
    if a < 3:
        return ring_graph(n)
    # shifts +-1 (row ring) and +-a (column ring) on the flattened index.
    perms = _circulant_perms(n, [1, n - 1, a, n - a])
    sw, ew = _lazy_weights(len(perms))
    return CommGraph("torus", n, perms, sw, ew)


def hypercube_graph(n: int) -> CommGraph:
    """Boolean hypercube: n must be a power of two, k = log2(n). Gap is
    constant-ish (1 - lambda2 = 2/(k+1) with lazy weights). XOR edges are
    expressed as explicit permutations (not circulant)."""
    k = n.bit_length() - 1
    if 1 << k != n:
        raise ValueError(f"hypercube needs power-of-two n, got {n}")
    perms = []
    for b in range(k):
        perms.append(tuple(i ^ (1 << b) for i in range(n)))
    sw, ew = _lazy_weights(k)
    return CommGraph("hypercube", n, tuple(perms), sw, ew)


def kregular_expander(n: int, k: int = 4, seed: int = 0) -> CommGraph:
    """k-regular expander with n nodes (paper ref [1] uses zig-zag products;
    we use chordal circulant shifts which for random-ish shift sets achieve
    near-Ramanujan gaps and map to uniform ppermutes).

    Shifts are chosen deterministically (seeded) from distinct values in
    [1, n/2); each shift contributes 2 to the degree (s and n-s), so k must
    be even (or n=2). Verified in tests: spectral gap stays ~constant as n
    grows for fixed k, unlike the ring.
    """
    if n <= k:
        return complete_graph(n)
    if k % 2 != 0:
        raise ValueError("kregular_expander needs even k (circulant +-s pairs)")
    rng = np.random.default_rng(seed)
    # Greedy pick of k/2 distinct shifts maximizing the spectral gap of the
    # resulting circulant. Candidate pool: all shifts in [1, n//2].
    candidates = list(range(1, n // 2 + 1))
    chosen: list[int] = []
    need = k // 2
    # Start from shift 1 (keeps graph connected), then greedily add the shift
    # that maximizes the gap. For large n, sample candidates to keep it cheap.
    chosen.append(1)
    while len(chosen) < need:
        pool = candidates
        if len(pool) > 64:
            pool = sorted(rng.choice(candidates, size=64, replace=False).tolist())
        best_s, best_gap = None, -1.0
        for s in pool:
            if s in chosen:
                continue
            trial = chosen + [s]
            g = _circulant_gap(n, trial)
            if g > best_gap:
                best_gap, best_s = g, s
        chosen.append(int(best_s))
    shifts: list[int] = []
    for s in chosen:
        shifts.append(s)
        if (n - s) % n != s:
            shifts.append(n - s)
    perms = _circulant_perms(n, shifts)
    sw, ew = _lazy_weights(len(perms))
    return CommGraph(f"expander{k}", n, perms, sw, ew)


def _circulant_gap(n: int, half_shifts: Sequence[int]) -> float:
    """Spectral gap of the lazy circulant mixing matrix with +-s edges,
    computed via the DFT eigenvalues of a circulant (O(n * |S|))."""
    shifts = []
    for s in half_shifts:
        shifts.append(s % n)
        if (n - s) % n != s % n:
            shifts.append((n - s) % n)
    k = len(shifts)
    w = 1.0 / (k + 1)
    j = np.arange(n)
    lam = np.full(n, w, dtype=np.complex128)
    for s in shifts:
        lam += w * np.exp(2j * np.pi * j * s / n)
    mags = np.abs(lam)
    mags.sort()
    lam2 = mags[-2] if n > 1 else 0.0
    return 1.0 - math.sqrt(min(max(lam2, 0.0), 1.0))


def random_regular_expander(n: int, k: int = 4, seed: int = 0) -> CommGraph:
    """k-regular expander via the permutation model: union of k/2 random
    n-cycles and their inverses. Near-Ramanujan with high probability
    (lambda_2(A) ~ 2*sqrt(k-1)), so the spectral gap is INDEPENDENT of n --
    the property the paper's claim C3 needs. Unlike circulant chords these
    permutations are not uniform torus shifts; on real hardware each edge is
    still a single ppermute, but may traverse multiple ICI hops. Use
    `kregular_expander` (circulant) when n is small or locality matters, and
    this one when n grows past a few hundred nodes.
    """
    if n <= k:
        return complete_graph(n)
    if k % 2 != 0:
        raise ValueError("random_regular_expander needs even k")
    rng = np.random.default_rng(seed)
    perms: list[tuple[int, ...]] = []
    for _ in range(k // 2):
        order = rng.permutation(n)  # random n-cycle visiting `order`
        nxt = np.empty(n, dtype=np.int64)
        nxt[order] = np.roll(order, -1)  # successor along the cycle
        fwd = tuple(int(v) for v in nxt)
        inv = np.empty(n, dtype=np.int64)
        inv[nxt] = np.arange(n)
        bwd = tuple(int(v) for v in inv)
        perms.extend([fwd, bwd])
    sw, ew = _lazy_weights(len(perms))
    return CommGraph(f"rregular{k}", n, tuple(perms), sw, ew)


_BUILDERS = {
    "complete": complete_graph,
    "ring": ring_graph,
    "torus": torus_graph,
    "hypercube": hypercube_graph,
}


def build_graph(name: str, n: int, *, k: int = 4, seed: int = 0) -> CommGraph:
    """Factory: `name` in {complete, ring, torus, hypercube, expander}."""
    if name.startswith("rregular"):
        kk = int(name[len("rregular"):]) if len(name) > len("rregular") else k
        return random_regular_expander(n, k=kk, seed=seed)
    if name.startswith("expander"):
        kk = int(name[len("expander"):]) if len(name) > len("expander") else k
        return kregular_expander(n, k=kk, seed=seed)
    try:
        return _BUILDERS[name](n)
    except KeyError:
        raise ValueError(f"unknown graph {name!r}; have "
                         f"{sorted(_BUILDERS) + ['expander<k>']}") from None


def mix_weight_slots(W: np.ndarray, S_in: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Fold an (n, n) mixing-matrix override into per-slot edge weights.

    S_in is the (n, k) in-neighbor slot structure (S_in[i, j] = the node
    whose value node i receives in permutation slot j). W[i, src] is the
    TOTAL (i, src) pair weight, so a src occupying several slots
    contributes W / multiplicity per slot. Returns ((n, k) slot weights,
    (n,) self weights), both float64.

    This is THE definition of the reweighted-gossip slot convention: the
    dense simulator's sparse mix (`core.dda.DDASimulator`) and the netsim
    vectorized engine's stale mix both fold through here, which is what
    keeps `AdaptiveController(reweight_gossip=True)` runs comparable
    across execution modes (tests/test_kernels.py pins the convention
    against the dense-matmul oracle independently).
    """
    W = np.asarray(W, dtype=np.float64)
    n, k = S_in.shape
    mult = np.zeros((n, k), dtype=np.int64)
    for slot in range(k):
        mult[:, slot] = (S_in == S_in[:, slot][:, None]).sum(axis=1)
    rows = np.arange(n)[:, None]
    return W[rows, S_in] / mult, np.diag(W).copy()


def doubly_stochastic_matrix(graph: CommGraph) -> np.ndarray:
    return graph.mixing_matrix()


def lambda2(P: np.ndarray) -> float:
    """Second-largest eigenvalue magnitude of a doubly-stochastic P.

    Symmetric inputs (the lazy Metropolis weights, and Sinkhorn-rebalanced
    reweightings of them) take the `eigvalsh` fast path -- ~5x cheaper and
    numerically tighter, which matters to the online controller
    (`repro.adaptive`) refreshing lambda2 on every retune cadence rather
    than once per run. Non-symmetric matrices fall back to `eigvals`.
    """
    P = np.asarray(P, dtype=np.float64)
    if np.allclose(P, P.T, rtol=0.0, atol=1e-12):
        mags = np.abs(np.linalg.eigvalsh(P))
        mags.sort()
    else:
        mags = np.sort(np.abs(np.linalg.eigvals(P)))
    if len(mags) < 2:
        return 0.0
    return float(min(max(mags[-2], 0.0), 1.0))


def spectral_gap(P: np.ndarray) -> float:
    return 1.0 - math.sqrt(lambda2(P))
