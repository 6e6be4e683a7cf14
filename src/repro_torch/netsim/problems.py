"""Canonical test/benchmark problem for the cluster simulator.

One definition of the quadratic consensus problem f_i(x) = ||x - c_i||^2
shared by tests/test_netsim.py, tests/test_netsim_engine.py and
benchmarks/bench_netsim.py -- the same silently-diverging-copies argument
that moved the default stepsize into `core.dda.stepsize_sqrt` applies to
what the bench gates vs what the tests assert.

The problem is consensus-essential with a closed-form optimum: the common
+offset keeps ||mean(c)|| large so the x0 = 0 optimality gap dominates the
irreducible spread term mean ||c_i - cbar||^2, and
F(x) = ||x - cbar||^2 + spread gives an O(d) batch-capable evaluation.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["quadratic_consensus"]


def quadratic_consensus(n: int, d: int, seed: int = 0,
                        batchable: bool = False
                        ) -> tuple[np.ndarray, Callable, Callable]:
    """Returns (centers, grad_fn, eval_fn) for the n-node quadratic.

    grad_fn follows the NetSimulator convention `(i, x_i, t)` and is
    batchable as-is (numpy fancy indexing broadcasts over stacked inputs).
    With `batchable=False` eval_fn is the per-point mean-of-squares form
    (O(n d) per call, NOT batch-safe: on a stacked input it silently
    broadcasts to a wrong scalar, which is exactly what the engines'
    bitwise probe must reject). With `batchable=True` it is the closed
    form, accepting either one point (d,) or a stack (b, d).
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n, d)) * 2.0 + 3.0
    cbar = centers.mean(axis=0)
    spread = float(np.mean(np.sum(centers ** 2, axis=1)) - np.sum(cbar ** 2))

    def grad_fn(i, x, t):
        return 2.0 * (x - centers[i])

    if batchable:
        def eval_fn(x):
            x = np.asarray(x)
            if x.ndim == 1:
                return float(np.sum((x - cbar) ** 2) + spread)
            return np.sum((x - cbar) ** 2, axis=-1) + spread
    else:
        def eval_fn(x):
            return float(np.mean(np.sum((x[None] - centers) ** 2, axis=1)))

    return centers, grad_fn, eval_fn
