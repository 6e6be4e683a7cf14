"""Component registries: problems, topologies, schedules, stepsizes -- the
port of `repro.experiments.components`.

Each registry maps a string kind + JSON-able kwargs (exactly what a
`ComponentSpec` carries) to a built component. Problems keep the
reference's numpy halves (`grad_fn`, `eval_fn`, `fstar_fn`) verbatim -- the
host computes F* and the accuracy target from them, exactly as the
reference does -- and port its jax halves (`subgrad_stack`, `objective`,
`projection`) to torch on the device the problem is built for. The float64
numpy data is cast to float32 on the way in, as the reference's
`jnp.asarray` does with x64 off.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import graphs as _graphs
from repro_torch.core import schedules as _sched
from repro_torch.core.dda import stepsize_sqrt
from repro_torch.data.pipeline import metric_learning_pairs
from repro_torch.experiments.registry import Registry
from repro_torch.netsim.problems import quadratic_consensus as _quadratic

__all__ = [
    "LMProblem",
    "Problem",
    "problems",
    "topologies",
    "schedules",
    "stepsizes",
]

problems = Registry("problem")
topologies = Registry("topology")
schedules = Registry("schedule")
stepsizes = Registry("stepsize")


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Problem:
    """One distributed problem instance, in both execution styles.

    host halves (numpy, copied from the reference):
      grad_fn:       per-node `(i, x_i, t) -> g`.
      eval_fn:       `x -> float` full objective.
      fstar_fn:      the centralized optimum F*, computed lazily and cached
                     by `fstar`.
    device halves (torch, on the device the problem was built for):
      subgrad_stack: `(x_stack, t, key) -> g_stack` (DDASimulator).
      objective:     `x -> 0-d tensor` full objective (DDASimulator).
      projection:    optional stacked Proj_X for constrained problems.
      arrays:        the data tensors those closures read, under the names
                     the reference's closures give them (`convert.
                     problem_arrays` exposes them as numpy).
      capturable:    False when a closure reads the device back to the
                     host, which a CUDA graph capture forbids: the
                     simulator then runs it eagerly (`DDASimulator(capture=
                     False)`).
    """

    name: str
    n: int
    d: int
    grad_fn: Callable[[int, np.ndarray, int], np.ndarray]
    eval_fn: Callable[[np.ndarray], float]
    subgrad_stack: Callable | None = None
    objective: Callable | None = None
    projection: Callable | None = None
    fstar_fn: Callable[[], float] | None = None
    arrays: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    capturable: bool = True
    _fstar: float | None = dataclasses.field(default=None, repr=False)

    @property
    def fstar(self) -> float:
        if self._fstar is None:
            if self.fstar_fn is None:
                raise ValueError(f"problem {self.name!r} has no known F*")
            self._fstar = float(self.fstar_fn())
        return self._fstar

    def f0(self) -> float:
        """F at the canonical start x0 = 0."""
        return float(self.eval_fn(np.zeros(self.d)))

    def eps_value(self, eps_frac: float) -> float:
        """Accuracy target F* + eps_frac * (F(0) - F*)."""
        return self.fstar + float(eps_frac) * (self.f0() - self.fstar)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


@problems.register("quadratic_consensus", aliases=("quadratic",))
def _quadratic_problem(n: int, d: int, seed: int = 0,
                       batchable: bool = False, *, device) -> Problem:
    """`netsim.problems.quadratic_consensus` plus its torch half.
    `batchable` selects the numpy eval form exactly as the reference."""
    centers, grad_fn, eval_fn = _quadratic(n, d, seed=seed,
                                           batchable=batchable)
    cbar = centers.mean(axis=0)
    spread = float(np.mean(np.sum(centers ** 2, axis=1))
                   - np.sum(cbar ** 2))
    centers_j = _f32(centers, device)
    cbar_j = _f32(cbar, device)

    def subgrad_stack(x_stack, t, key):
        return 2.0 * (x_stack - centers_j)

    def objective(x):
        return torch.sum((x - cbar_j) ** 2) + spread

    return Problem(name="quadratic_consensus", n=n, d=d,
                   grad_fn=grad_fn, eval_fn=eval_fn,
                   subgrad_stack=subgrad_stack, objective=objective,
                   fstar_fn=lambda: float(eval_fn(centers.mean(axis=0))),
                   arrays={"centers_j": centers_j, "cbar_j": cbar_j})


def nonsmooth_centers(n: int, M: int, d: int, seed: int) -> np.ndarray:
    """The nonsmooth problem's center tensor (n, M, 2, d)."""
    from repro_torch.data.pipeline import nonsmooth_quadratic_problem
    return nonsmooth_quadratic_problem(n, M, d, seed,
                                       center_scale=1.5).astype(np.float64)


def nonsmooth_centralized_optimum(centers: np.ndarray,
                                  iters: int = 800) -> float:
    """Reference F* via centralized subgradient descent on the mean
    objective (copied verbatim from the reference)."""
    n, M, _, d = centers.shape

    def full_grad(x):
        diff = x[None, None, None, :] - centers
        q = np.sum(diff * diff, axis=-1)
        pick = np.argmax(q, axis=-1)
        chosen = np.take_along_axis(diff, pick[..., None, None],
                                    axis=2)[:, :, 0]
        return 2.0 * np.sum(chosen, axis=(0, 1)) / n

    def value(x):
        diff = x[None, None, None, :] - centers
        q = np.sum(diff * diff, axis=-1)
        return float(np.mean(np.sum(np.max(q, axis=-1), axis=-1)))

    x = np.zeros(d)
    best = value(x)
    lr0 = 1.0 / (4.0 * M)
    for t in range(1, iters + 1):
        x = x - (lr0 / math.sqrt(t)) * full_grad(x)
        if t % 50 == 0:
            best = min(best, value(x))
    return best


@problems.register("nonsmooth")
def _nonsmooth_problem(n: int, M: int = 30, d: int = 20,
                       seed: int = 0, *, device) -> Problem:
    """Paper section V.B non-smooth quadratics, f_i = sum_j max(l1, l2).
    `torch.argmax`, like `jnp.argmax`, returns the first maximum, so the
    subgradient agrees with the reference except at float ties."""
    centers = nonsmooth_centers(n, M, d, seed)

    def grad_fn(i, x, t):
        diff = x[None, None, :] - centers[i]          # (M, 2, d)
        q = np.sum(diff * diff, axis=-1)              # (M, 2)
        pick = np.argmax(q, axis=-1)                  # (M,)
        chosen = np.take_along_axis(
            diff, pick[:, None, None], axis=1)[:, 0]  # (M, d)
        return 2.0 * np.sum(chosen, axis=0)

    def eval_fn(x):
        diff = x[None, None, None, :] - centers       # (n, M, 2, d)
        q = np.sum(diff * diff, axis=-1)
        return float(np.mean(np.sum(np.max(q, axis=-1), axis=-1)))

    centers_j = _f32(centers, device)

    def subgrad_stack(x_stack, t, key):
        diff = x_stack[:, None, None, :] - centers_j      # (n, M, 2, d)
        q = torch.sum(diff * diff, dim=-1)                # (n, M, 2)
        pick = torch.argmax(q, dim=-1)                    # (n, M)
        idx = pick[..., None, None].expand(-1, -1, 1, diff.shape[-1])
        chosen = torch.gather(diff, 2, idx)[:, :, 0]      # (n, M, d)
        return 2.0 * torch.sum(chosen, dim=1)

    def objective(x):
        diff = x[None, None, None, :] - centers_j
        q = torch.sum(diff * diff, dim=-1)
        return torch.mean(torch.sum(torch.amax(q, dim=-1), dim=-1))

    return Problem(name="nonsmooth", n=n, d=d, grad_fn=grad_fn,
                   eval_fn=eval_fn, subgrad_stack=subgrad_stack,
                   objective=objective,
                   fstar_fn=lambda: nonsmooth_centralized_optimum(centers),
                   arrays={"centers_j": centers_j})


@problems.register("least_squares")
def _least_squares_problem(n: int, d: int = 64, m_per_node: int = 200,
                           seed: int = 0, *, device) -> Problem:
    """Node-specific least squares (the quickstart problem): f_i(x) =
    ||A_i x - b_i||^2 with per-node solutions, so consensus is required."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m_per_node, d)) / np.sqrt(d)
    x_true = rng.normal(size=(d,))
    b = np.einsum("nmd,d->nm", A, x_true) + rng.normal(
        scale=0.1 + 0.5 * rng.random((n, 1)), size=(n, m_per_node))

    def grad_fn(i, x, t):
        res = A[i] @ x - b[i]
        return 2.0 * (A[i].T @ res)

    def eval_fn(x):
        res = np.einsum("nmd,d->nm", A, x) - b
        return float(np.mean(np.sum(res * res, axis=1)))

    A_j, b_j = _f32(A, device), _f32(b, device)

    def subgrad_stack(x_stack, t, key):
        res = torch.einsum("nmd,nd->nm", A_j, x_stack) - b_j
        return 2.0 * torch.einsum("nmd,nm->nd", A_j, res)

    def objective(x):
        res = torch.einsum("nmd,d->nm", A_j, x) - b_j
        return torch.mean(torch.sum(res * res, dim=1))

    def fstar():
        x_star, *_ = np.linalg.lstsq(A.reshape(n * m_per_node, d),
                                     b.reshape(-1), rcond=None)
        return eval_fn(x_star)

    return Problem(name="least_squares", n=n, d=d, grad_fn=grad_fn,
                   eval_fn=eval_fn, subgrad_stack=subgrad_stack,
                   objective=objective, fstar_fn=fstar,
                   arrays={"A_j": A_j, "b_j": b_j})


@functools.lru_cache(maxsize=4)
def _metric_pairs_cached(m_pairs: int, d_feat: int, seed: int):
    """The pair set is independent of the node count, but the runner's
    problem cache keys on n -- without this, an n sweep would regenerate
    the (2 m_pairs, d) synthetic dataset once per cell."""
    return metric_learning_pairs(m_pairs, d_feat, seed)


@problems.register("metric_learning")
def _metric_learning_problem(n: int, m_pairs: int = 2000, d_feat: int = 8,
                             seed: int = 0, *, device) -> Problem:
    """Paper section V.A metric learning: x = [vec(A) | b], hinge losses
    s_j * (dist_A(u_j, v_j) - b) + 1 over similar/dissimilar pairs, with
    Proj onto {A PSD, b >= 1}. The state dimension is d_feat^2 + 1. No
    closed-form F*. The PSD projection's `torch.linalg.eigh` may return
    other eigenvector signs than the reference's; the projected matrix is
    what agrees. On a card eigh checks cuSOLVER's info flag on the host,
    so the problem cannot be captured as a CUDA graph."""
    u_np, v_np, s_np = _metric_pairs_cached(m_pairs, d_feat, seed)
    dim = d_feat * d_feat + 1
    base = m_pairs // n
    slices = [slice(i * base, (i + 1) * base) for i in range(n)]

    def _split_np(x):
        return x[:d_feat * d_feat].reshape(d_feat, d_feat), x[d_feat * d_feat]

    def grad_fn(i, x, t):
        A, b = _split_np(x)
        u, v, s = u_np[slices[i]], v_np[slices[i]], s_np[slices[i]]
        diff = u - v
        dist2 = np.einsum("md,de,me->m", diff, A, diff)
        w = np.where(s * (dist2 - b) + 1.0 > 0.0, s, 0.0)
        gA = np.einsum("m,md,me->de", w, diff, diff)
        return np.concatenate([gA.reshape(-1), [-np.sum(w)]])

    def eval_fn(x):
        A, b = _split_np(np.asarray(x))
        diff = u_np - v_np
        dist2 = np.einsum("md,de,me->m", diff, A, diff)
        return float(np.sum(np.maximum(0.0, s_np * (dist2 - b) + 1.0)))

    u_j, v_j, s_j = (_f32(u_np, device), _f32(v_np, device),
                     _f32(s_np, device))
    us = torch.stack([u_j[sl] for sl in slices])
    vs = torch.stack([v_j[sl] for sl in slices])
    ss = torch.stack([s_j[sl] for sl in slices])

    def _split(x):
        """Stacked (n, dim) -> (n, d_feat, d_feat), (n,)."""
        return (x[..., :d_feat * d_feat].reshape(*x.shape[:-1], d_feat,
                                                 d_feat),
                x[..., d_feat * d_feat])

    def subgrad_stack(x_stack, t, key):
        A, b = _split(x_stack)
        diff = us - vs                                         # (n, m, d)
        dist2 = torch.einsum("nmd,nde,nme->nm", diff, A, diff)
        w = torch.where((ss * (dist2 - b[:, None]) + 1.0) > 0.0, ss,
                        torch.zeros_like(ss))
        gA = torch.einsum("nm,nmd,nme->nde", w, diff, diff)
        return torch.cat([gA.reshape(x_stack.shape[0], -1),
                          -torch.sum(w, dim=1)[:, None]], dim=1)

    def objective(x):
        A, b = _split(x)
        diff = u_j - v_j
        dist2 = torch.einsum("md,de,me->m", diff, A, diff)
        return torch.sum(torch.clamp(s_j * (dist2 - b) + 1.0, min=0.0))

    def projection(x_stack):
        A, b = _split(x_stack)
        A = 0.5 * (A + A.transpose(-1, -2))
        evals, evecs = torch.linalg.eigh(A)
        A = (evecs * torch.clamp(evals, min=0.0)[..., None, :]) \
            @ evecs.transpose(-1, -2)
        return torch.cat([A.reshape(x_stack.shape[0], -1),
                          torch.clamp(b, min=1.0)[:, None]], dim=1)

    return Problem(name="metric_learning", n=n, d=dim, grad_fn=grad_fn,
                   eval_fn=eval_fn, subgrad_stack=subgrad_stack,
                   objective=objective, projection=projection,
                   arrays={"u_j": u_j, "v_j": v_j, "s_j": s_j,
                           "us": us, "vs": vs, "ss": ss},
                   capturable=False)


@dataclasses.dataclass
class LMProblem:
    """Marker problem for the `launch` backend: the 'problem' is consensus
    data-parallel LM training of a registry architecture, not a convex
    objective -- dense/netsim backends reject it."""

    arch: str
    variant: str = "smoke"
    batch_per_node: int = 8
    seq_len: int = 64


@problems.register("lm")
def _lm_problem(arch: str, variant: str = "smoke", batch_per_node: int = 8,
                seq_len: int = 64, device=None) -> LMProblem:
    # nothing is made on the device until the launcher inits the model
    return LMProblem(arch=arch, variant=variant,
                     batch_per_node=batch_per_node, seq_len=seq_len)


# ---------------------------------------------------------------------------
# topologies (n comes from the problem; params carry the shape knobs)
# ---------------------------------------------------------------------------


@topologies.register("complete")
def _complete(n: int) -> _graphs.CommGraph:
    return _graphs.complete_graph(n)


@topologies.register("ring")
def _ring(n: int) -> _graphs.CommGraph:
    return _graphs.ring_graph(n)


@topologies.register("torus")
def _torus(n: int) -> _graphs.CommGraph:
    return _graphs.torus_graph(n)


@topologies.register("hypercube")
def _hypercube(n: int) -> _graphs.CommGraph:
    return _graphs.hypercube_graph(n)


@topologies.register("expander")
def _expander(n: int, k: int = 4, seed: int = 0) -> _graphs.CommGraph:
    return _graphs.kregular_expander(n, k=k, seed=seed)


@topologies.register("rregular")
def _rregular(n: int, k: int = 4, seed: int = 0) -> _graphs.CommGraph:
    return _graphs.random_regular_expander(n, k=k, seed=seed)


@topologies.register("expander_sequence")
def _expander_seq(n: int, k: int = 4, length: int = 4,
                  seed: int = 0) -> _graphs.GraphSequence:
    return _graphs.expander_sequence(n, k=k, length=length, seed=seed)


# ---------------------------------------------------------------------------
# schedules (the registry `core.schedules.make_schedule` routes through)
# ---------------------------------------------------------------------------


@schedules.register("every", aliases=("h1",))
def _every() -> _sched.CommSchedule:
    return _sched.EveryIteration()


@schedules.register("periodic")
def _periodic(h: int = 1) -> _sched.CommSchedule:
    return _sched.Periodic(h=h)


@schedules.register("sparse")
def _sparse(p: float = 0.3) -> _sched.CommSchedule:
    return _sched.IncreasinglySparse(p=p)


@schedules.register("piecewise")
def _piecewise(h: int = 1) -> _sched.CommSchedule:
    return _sched.PiecewisePeriodic(h=h)


@schedules.register("adaptive")
def _adaptive(h0: int = 1, p: float = 0.0, h_max: int = 512):
    from repro_torch.adaptive.schedule import AdaptiveSchedule
    return AdaptiveSchedule(h0=h0, p=p, h_max=h_max)


# ---------------------------------------------------------------------------
# stepsizes
# ---------------------------------------------------------------------------


@stepsizes.register("sqrt")
def _sqrt(A: float = 1.0, q: float = 0.5) -> Callable:
    """a(t) = A / max(t, 1)^q -- `core.dda.stepsize_sqrt`, computed in
    float32 on the simulator's counter tensor."""
    return stepsize_sqrt(A, q)


@stepsizes.register("inv_sqrt")
def _inv_sqrt(A: float = 1.0) -> Callable:
    """a(t) = A / sqrt(max(t, 1)) via `math.sqrt` on host floats (kept
    distinct from "sqrt" as in the reference). Host-only: the dense backend
    rejects it."""
    def a(t):
        return A / math.sqrt(max(t, 1.0))
    return a


def build_component(registry: Registry, kind: str,
                    params: dict[str, Any], **extra: Any) -> Any:
    """Build `kind` from `registry` with spec params plus runner-provided
    context (the problem's n for topologies, the device for problems).
    Spec params win conflicts loudly: a manifest must not silently
    override runner context."""
    clash = set(params) & set(extra)
    if clash:
        raise ValueError(
            f"{registry.kind} {kind!r} params {sorted(clash)} are "
            f"runner-provided and cannot be set in the spec")
    return registry.build(kind, **params, **extra)
