"""Deterministic synthetic data for the paper problems, copied from
`repro.data.pipeline` (the numpy generators only; the LM token stream is not
ported yet).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Paper problems
# ---------------------------------------------------------------------------


def synthetic_mnist_like(m: int, d: int = 784, num_classes: int = 10,
                         seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """MNIST-like class-clustered vectors (the paper uses real MNIST; the
    container has no dataset downloads, so we build class clusters with
    matching dimensionality and scale -- documented in DESIGN.md)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, (num_classes, d))
    labels = rng.integers(0, num_classes, m)
    x = centers[labels] + rng.normal(0.0, 0.8, (m, d))
    return x.astype(np.float32), labels.astype(np.int32)


def metric_learning_pairs(m_pairs: int, d: int = 784, seed: int = 0,
                          num_classes: int = 10):
    """Pairs (u_j, v_j, s_j) for the paper's section V.A metric-learning
    task: s=+1 if same class else -1."""
    x, y = synthetic_mnist_like(2 * m_pairs, d, num_classes, seed)
    u, v = x[0::2], x[1::2]
    s = np.where(y[0::2] == y[1::2], 1.0, -1.0).astype(np.float32)
    return u, v, s


def nonsmooth_quadratic_problem(n_nodes: int, M: int, d: int, seed: int = 0,
                                center_scale: float = 1.0):
    """Paper section V.B: f_i(x) = sum_j max(l^1_j(x), l^2_j(x)) with
    l^xi = ||x - c^xi||^2; node centers drawn far apart so communication is
    essential. Returns centers (n, M, 2, d)."""
    rng = np.random.default_rng(seed)
    node_shift = rng.normal(0.0, center_scale, (n_nodes, 1, 1, d))
    centers = rng.normal(0.0, 0.3, (n_nodes, M, 2, d)) + node_shift
    return centers.astype(np.float32)
