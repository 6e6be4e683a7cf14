"""Closed-loop adaptive communication scheduling.

The paper's pipeline is offline: measure r on the cluster, solve eq. (21)
for h_opt, configure the schedule, run. This package closes that loop
ONLINE, during a run:

    measure  -- `RTracker` streams an exponentially-windowed r_hat from the
                live event timeline (message flights + per-node step
                durations); `DenseRTracker` does the same from wall-clock
                iteration timings in the dense synchronous mode.
    predict  -- eq. (21) h_opt(n, k, r_hat, lambda2), with lambda2 itself
                refreshed from observed per-node step-time quantiles by
                `StragglerReweighter` (expected degraded mixing matrix,
                Sinkhorn-rebalanced, `lambda2_fast`).
    act      -- `AdaptiveSchedule` splices the re-solved interval into the
                running periodic / increasingly-sparse pattern through the
                append-only mutation protocol of
                `core.schedules.PiecewisePeriodic`, keeping H(t) /
                next_comm_step / next_comm_step_batch consistent across h
                changes.

`AdaptiveController` packages the three for `NetSimulator(controller=...)`;
both netsim engines thread it through their event loops (zero hot-path
branches when absent, preserving the engines' bit-identity contract).
benchmarks/fig_adaptive.py demonstrates the payoff: on heterogeneous/lossy
clusters the closed loop beats every fixed Periodic(h) in a swept grid on
simulated wall-clock to target accuracy.
"""

from repro_torch.adaptive.controller import (AdaptiveController, DenseController,
                                             StragglerReweighter)
from repro_torch.adaptive.rtracker import DenseRTracker, RTracker
from repro_torch.adaptive.schedule import AdaptiveSchedule, Retune

__all__ = [
    "AdaptiveController",
    "AdaptiveSchedule",
    "DenseController",
    "DenseRTracker",
    "RTracker",
    "Retune",
    "StragglerReweighter",
]
