"""Streaming estimators of the communication/computation tradeoff r.

The paper measures r ONCE, offline (r = t_msg / t_full_grad, section V.A),
and derives the optimal schedule from it. `repro_torch.netsim` already recovers r
from a finished run's event timeline (`measure_r_empirical`); this module is
the ONLINE version -- the "measure" third of the measure -> predict -> act
loop that `repro_torch.adaptive.AdaptiveController` closes during a run.

Two variants, matching the repo's two execution styles:

  * `RTracker`      -- event-timeline mode, fed by the netsim engines: one
    exponentially-windowed mean over observed message flights, one
    EW-windowed per-node mean over observed step durations. The full-data
    gradient time is `median(per-node step means) * n` -- the same
    median-of-nodes robustness `measure_r_empirical` uses, so a single 4x
    straggler shifts the straggler quantiles (see StragglerReweighter) but
    not r_hat itself. Batch observations fold in one `ew_update` call per
    event batch, so the vectorized engine pays O(1) per batch, not O(batch).

  * `DenseRTracker` -- dense/synchronous mode, fed by WALL-CLOCK timings of
    whole iterations (e.g. `time.perf_counter()` around chunks of
    `DDASimulator`'s run program). It never sees individual messages;
    instead it inverts eq. (9): a communication iteration costs
    t_plain + k * t_msg, so t_msg = (t_comm - t_plain) / k and
    t_full_grad = n * t_plain (the local step is 1/n of the data).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.tradeoff import ew_alpha, ew_update

__all__ = ["RTracker", "DenseRTracker"]


class RTracker:
    """EW-windowed r estimate from per-event netsim observations."""

    def __init__(self, n: int, halflife: float = 64.0,
                 r0: float | None = None, tracer=None):
        if n < 1:
            raise ValueError("n must be >= 1")
        self.n = n
        self.alpha = ew_alpha(halflife)
        self.r0 = r0
        # optional repro_torch.obs.Tracer: observation batches fold into its
        # counters (one branch per BATCH, preserving the O(1)-per-batch
        # cost); None (default) records nothing.
        self.tracer = tracer
        self._msg = math.nan                      # EW mean message flight
        self.step_means = np.full(n, np.nan)      # per-node EW step duration
        self.n_messages = 0
        self.n_steps = 0

    # -- feeding (engine hook targets) ---------------------------------------

    def observe_messages(self, flights: np.ndarray) -> None:
        """Fold a batch of observed send->receive flight times."""
        m = len(flights)
        if m == 0:
            return
        self._msg = ew_update(self._msg, float(np.mean(flights)), m,
                              self.alpha)
        self.n_messages += m
        if self.tracer is not None:
            self.tracer.count("rtracker.messages_observed", m)

    def observe_steps(self, nodes: np.ndarray, durations: np.ndarray) -> None:
        """Fold a batch of per-node local-step durations (nodes unique
        within a batch -- each node finishes at most one step per event)."""
        if len(nodes) == 0:
            return
        old = self.step_means[nodes]
        fresh = np.isnan(old)
        self.step_means[nodes] = np.where(
            fresh, durations, (1.0 - self.alpha) * old + self.alpha * durations)
        self.n_steps += len(nodes)
        if self.tracer is not None:
            self.tracer.count("rtracker.steps_observed", len(nodes))

    # -- reading -------------------------------------------------------------

    @property
    def t_msg(self) -> float:
        return self._msg

    @property
    def t_grad_full(self) -> float:
        """Median node's full-data gradient time (median * n, robust to
        stragglers exactly like `measure_r_empirical`)."""
        if np.isnan(self.step_means).all():
            return math.nan
        return float(np.nanmedian(self.step_means)) * self.n

    @property
    def r_hat(self) -> float | None:
        """Current estimate, or the r0 prior before both signals exist, or
        None with no prior (the controller then skips the retune)."""
        t_full = self.t_grad_full
        if math.isnan(self._msg) or math.isnan(t_full) or t_full <= 0.0:
            return self.r0
        return self._msg / t_full

    def ready(self, min_messages: int = 1, min_steps: int = 1) -> bool:
        return self.n_messages >= min_messages and self.n_steps >= min_steps


class DenseRTracker:
    """EW-windowed r estimate from wall-clock iteration timings (dense mode).

    `observe_iteration(wall, was_comm)` with the measured duration of one
    synchronous iteration; `r_hat` inverts the eq. (9) cost model. Returns
    None until both iteration kinds have been seen, and clamps at 0 when
    measurement noise makes a communication iteration look cheaper than a
    local one.
    """

    def __init__(self, n: int, k: int, halflife: float = 32.0):
        if n < 1 or k < 1:
            raise ValueError("need n >= 1 and k >= 1")
        self.n = n
        self.k = k
        self.alpha = ew_alpha(halflife)
        self._comm = math.nan
        self._plain = math.nan
        self.n_comm = 0
        self.n_plain = 0

    def observe_iteration(self, wall_seconds: float, was_comm: bool) -> None:
        if wall_seconds < 0.0:
            raise ValueError("iteration wall time must be >= 0")
        if was_comm:
            self._comm = ew_update(self._comm, wall_seconds, 1, self.alpha)
            self.n_comm += 1
        else:
            self._plain = ew_update(self._plain, wall_seconds, 1, self.alpha)
            self.n_plain += 1

    @property
    def r_hat(self) -> float | None:
        if math.isnan(self._comm) or math.isnan(self._plain) \
                or self._plain <= 0.0:
            return None
        t_msg = max(self._comm - self._plain, 0.0) / self.k
        return t_msg / (self.n * self._plain)
