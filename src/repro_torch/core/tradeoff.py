"""The communication/computation tradeoff r and its consequences.

Paper III.A time model (time normalized so ONE processor computes a gradient
on the FULL dataset in 1 unit):

    cost/iteration = 1/n + k*r                          (eq. 9)
    tau(eps)       = (C/eps)^2 * (1/n + k*r)            (eq. 10)
    n_opt (complete graph)           = 1/sqrt(r)        (eq. 11)
    h_opt (periodic, fixed n, G)     = sqrt(n k r / (18 + 12/(1-sqrt(lam2))))
                                                        (eq. 21)

r is a *measured* quantity: (time to transmit+receive one message) /
(time for one processor to compute a full-data gradient). Where it is not
measured it is derived from a roofline of the step:

    t_msg  = message_bytes / link_bw        (cross-consensus-axis transfer)
    t_grad = max(step_flops / peak_flops, step_bytes / hbm_bw) * n
             (local shard gradient time scaled back to full data)
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import schedules as _sched
from repro_torch.core.graphs import lambda2 as _lambda2

__all__ = [
    "HardwareSpec",
    "H100_SXM",
    "measure_r",
    "derive_r_from_roofline",
    "iteration_cost",
    "time_to_accuracy",
    "n_opt_complete",
    "h_opt",
    "predict_speedup",
    "ew_alpha",
    "ew_update",
    "lambda2_fast",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peaks used in the roofline and tradeoff math.

    The defaults are one NVIDIA H100 SXM5 80GB at its 700 W power limit,
    from NVIDIA's H100 Tensor Core GPU data sheet (dense rates, without
    sparsity). `ici_bw` is one NVLink 4 link in one direction: the sheet's
    900 GB/s is both directions of 18 links, so 25 GB/s a link a
    direction, the rate one message sees. `dcn_bw` is an assumed 400 Gb/s
    NIC a GPU.
    """

    peak_flops: float = 989.4e12      # dense bf16 FLOP/s per chip
    hbm_bw: float = 3.35e12           # HBM3 bytes/s per chip
    ici_bw: float = 25e9              # bytes/s per NVLink link, one direction
    dcn_bw: float = 50e9              # bytes/s off the node (400 Gb/s), assumed
    hbm_per_chip: float = 80e9        # bytes (80 GB)


H100_SXM = HardwareSpec()


def measure_r(t_msg_seconds: float, t_full_grad_seconds: float) -> float:
    """Direct measurement, exactly as the paper does on its cluster:
    r = 0.85s / 29s = 0.0293 for full-MNIST metric learning (paper V.A)."""
    if t_full_grad_seconds <= 0:
        raise ValueError("gradient time must be positive")
    return t_msg_seconds / t_full_grad_seconds


def derive_r_from_roofline(
    message_bytes: float,
    local_step_flops: float,
    local_step_bytes: float,
    n: int,
    hw: HardwareSpec = H100_SXM,
    *,
    link_bw: float | None = None,
    chips_per_node: int = 1,
) -> float:
    """Derive r for a consensus node that is itself a `chips_per_node`-chip
    synchronous group. `local_step_flops/bytes` are PER NODE per local step on
    its 1/n shard of the data; time for the full data on one node is n * that.
    """
    bw = link_bw if link_bw is not None else hw.dcn_bw
    t_msg = message_bytes / bw
    t_local = max(
        local_step_flops / (hw.peak_flops * chips_per_node),
        local_step_bytes / (hw.hbm_bw * chips_per_node),
    )
    t_full = t_local * n
    return t_msg / t_full


def iteration_cost(n: int, k: int, r: float, c: float = 1.0) -> float:
    """Time units per (expensive) iteration -- eq. (9).

    `c` is the bytes-on-wire compression ratio (`Compressor.wire_ratio`,
    1.0 uncompressed): compressed gossip transmits c of the bytes, so the
    per-message cost is r*c and every optimum below shifts as if the link
    were 1/c times faster. Kept as a separate knob (rather than folding
    into r at every call site) so predictions can quote both the raw and
    the effective tradeoff.
    """
    return 1.0 / n + k * r * c


def time_to_accuracy(
    eps: float,
    n: int,
    k: int,
    r: float,
    lam2: float,
    L: float = 1.0,
    R: float = 1.0,
    schedule: _sched.CommSchedule | None = None,
    c: float = 1.0,
) -> float:
    """tau(eps) in time units for a given topology + schedule.

    every-iteration: eq. (10);  periodic-h: eq. (20);  sparse-p: eq. (30/31).
    `c` is the compression byte ratio (effective per-message cost r*c, see
    `iteration_cost`); the convergence constants are UNCHANGED by c because
    error feedback keeps the transmitted averages unbiased -- compression
    only cheapens the wire term.
    """
    schedule = schedule or _sched.EveryIteration()
    C = schedule.constant(L, R, lam2)
    rc = r * c
    if isinstance(schedule, _sched.EveryIteration):
        T = (C / eps) ** 2
        return T * (1.0 / n + k * rc)
    if isinstance(schedule, _sched.Periodic):
        T = (C / eps) ** 2
        return T * (1.0 / n + k * rc / schedule.h)
    if isinstance(schedule, _sched.PiecewisePeriodic):
        # a spliced schedule's true tau is segment-dependent; quote the
        # pattern it is emitting NOW (h_current), consistent with
        # PiecewisePeriodic.constant -- this is the controller's working
        # prediction, refreshed every retune
        T = (C / eps) ** 2
        return T * (1.0 / n + k * rc / schedule.h_current)
    if isinstance(schedule, _sched.IncreasinglySparse):
        p = schedule.p
        if p >= 0.5:
            return math.inf  # outside the permissible range (paper IV.B)
        T = (C / eps) ** (2.0 / (1.0 - 2.0 * p))
        H = T ** (1.0 / (p + 1.0))
        return T / n + H * k * rc
    raise TypeError(f"unknown schedule type {type(schedule)}")


def n_opt_complete(r: float, c: float = 1.0) -> float:
    """Optimal processor count on the complete graph -- eq. (11), with the
    effective per-message cost r*c (compression enlarges the optimal
    cluster by 1/sqrt(c))."""
    if r * c <= 0:
        return math.inf
    return 1.0 / math.sqrt(r * c)


def h_opt(n: int, k: int, r: float, lam2: float, c: float = 1.0) -> float:
    """Optimal intercommunication interval -- eq. (21) with effective
    per-message cost r*c: cheaper messages pull h_opt back toward 1
    (communicate more often), by sqrt(c)."""
    gap = 1.0 - math.sqrt(min(max(lam2, 0.0), 1.0 - 1e-15))
    return math.sqrt(n * k * r * c / (18.0 + 12.0 / gap))


def h_opt_int(n: int, k: int, r: float, lam2: float, c: float = 1.0) -> int:
    """Integer interval: h is a count of iterations, so clamp to >= 1.
    Matches the paper's Fig. 2 reading of eq. (21): r=0.00089, n=10 complete
    graph gives h_opt < 1 -> 'h_opt = 1' (communicate every iteration)."""
    return max(1, round(h_opt(n, k, r, lam2, c)))


# ---------------------------------------------------------------------------
# Incremental refresh helpers (closed-loop controllers, repro.adaptive)
# ---------------------------------------------------------------------------

def ew_alpha(halflife: float) -> float:
    """Per-observation smoothing factor for an exponentially-weighted mean
    whose influence halves every `halflife` observations."""
    if halflife <= 0:
        raise ValueError("halflife must be positive")
    return 1.0 - 0.5 ** (1.0 / halflife)


def ew_update(mean: float, batch_mean: float, batch_count: int,
              alpha: float) -> float:
    """Fold a batch of `batch_count` observations (summarized by their mean)
    into a streaming EW mean in one step.

    Equivalent to `batch_count` sequential updates against the batch mean;
    against the individual values it differs only by the within-batch
    ordering weights, which is the right trade for the vectorized netsim
    engine (one update per event batch instead of one per message). A NaN
    `mean` means "no prior" and adopts the batch mean directly.
    """
    if batch_count <= 0:
        return mean
    if math.isnan(mean):
        return batch_mean
    w = 1.0 - (1.0 - alpha) ** batch_count
    return (1.0 - w) * mean + w * batch_mean


def lambda2_fast(P) -> float:
    """Second-largest eigenvalue magnitude of a stochastic matrix -- alias
    of `core.graphs.lambda2`, which dispatches symmetric inputs to the
    `eigvalsh` fast path. Kept under the tradeoff namespace because it is
    the controller-facing half of the incremental r / lambda2 refresh API
    (`ew_update` + `lambda2_fast` -> `h_opt`)."""
    return _lambda2(P)


def predict_speedup(n: int, k: int, r: float, lam2: float,
                    L: float = 1.0, R: float = 1.0, eps: float = 0.1) -> float:
    """tau(eps; 1 node, no comm) / tau(eps; n nodes) under every-iteration."""
    tau1 = time_to_accuracy(eps, 1, 0, 0.0, 0.0, L, R)
    taun = time_to_accuracy(eps, n, k, r, lam2, L, R)
    return tau1 / taun
