"""Closed-loop communication schedule: h re-solved online from measured r.

`AdaptiveSchedule` is the "act" third of the measure -> predict -> act loop.
It extends `core.schedules.PiecewisePeriodic` (the mutation protocol: an
append-only sequence of anchored periodic segments with closed-form
H / next_comm_step / batch queries) with the paper-side policy:

  * each retune re-solves eq. (21), h_opt(n, k, r_hat, lambda2), with the
    STREAMED estimates (r_hat from `RTracker`, lambda2 optionally refreshed
    by `StragglerReweighter`) instead of the offline constants;
  * with `p > 0` the solved h_opt is spliced into the increasingly-sparse
    pattern of paper IV.B: the emitted interval is
    h(t) = h_opt_hat * (1 + H(t))^p, so gaps keep growing like j^p between
    retunes of the base -- communicating less and less as computation
    progresses, but with the BASE of the growth tracking the measured
    cluster instead of a precommitted constant. Convergence needs p < 1/2
    (paper eq. 31; p = 1 provably diverges, Fig. 2).

The splice point is always the caller-provided iteration frontier (max
in-flight iteration across nodes), so no node's already-made communication
decision is rewritten -- see PiecewisePeriodic's mutation contract.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.schedules import PiecewisePeriodic
from repro_torch.core.tradeoff import h_opt

__all__ = ["AdaptiveSchedule", "Retune"]


@dataclasses.dataclass(frozen=True)
class Retune:
    """One controller decision, kept for diagnostics/plots."""

    from_t: int      # splice point (iteration frontier at decision time)
    h: int           # emitted interval
    h_opt_raw: float # un-rounded eq. (21) solution
    r_hat: float
    lam2: float


class AdaptiveSchedule(PiecewisePeriodic):
    """Periodic/increasingly-sparse schedule with an online-tuned interval.

    Args:
      h0: initial interval until the first retune (1 = every iteration,
        the safe cold-start: mix aggressively until r is measured).
      p: sparse-growth exponent in [0, 1/2). 0 keeps the pure periodic
        policy (h tracks h_opt); p > 0 multiplies the measured base by
        (1 + H(t))^p, the paper's increasingly-sparse pattern.
      h_max: safety clamp on the emitted interval.
    """

    name: str = "adaptive"

    def __init__(self, h0: int = 1, p: float = 0.0, h_max: int = 512):
        super().__init__(h=h0)
        if not 0.0 <= p < 0.5:
            raise ValueError(f"p must be in [0, 0.5), got {p}"
                             " (p >= 1/2 loses the convergence guarantee)")
        if h_max < 1:
            raise ValueError("h_max must be >= 1")
        self.p = p
        self.h_max = h_max

    def reset(self) -> None:
        """Fresh run: drop the splice history AND the policy state."""
        super().reset()
        self.h_opt_hat = float(self._h0)
        self.retunes: list[Retune] = []

    def target_h(self, from_t: int) -> int:
        """Interval the policy wants to emit for iterations after from_t."""
        base = max(self.h_opt_hat, 1.0)
        if self.p > 0.0:
            base *= (1.0 + self.H(from_t)) ** self.p
        return int(min(max(1, round(base)), self.h_max))

    def retune(self, from_t: int, n: int, k: int, r_hat: float,
               lam2: float) -> bool:
        """Re-solve eq. (21) with fresh estimates and splice the result in.

        Returns True when the emitted pattern actually changed (the caller
        then refreshes any cached next_comm_step answers beyond from_t).
        """
        raw = h_opt(n, k, r_hat, lam2)
        self.h_opt_hat = raw
        h = self.target_h(from_t)
        if h == self.h_current:
            return False
        self.set_h(from_t, h)
        self.retunes.append(Retune(int(from_t), h, raw, float(r_hat),
                                   float(lam2)))
        return True
