"""`RMeasurement`, copied from `repro.netsim.simulator` so `RunResult` can
carry it; the event-driven `NetSimulator` is not ported yet."""

from __future__ import annotations

import dataclasses

__all__ = ["RMeasurement"]


@dataclasses.dataclass
class RMeasurement:
    """Empirical communication/computation tradeoff from an event timeline,
    measured the way the paper measures it on its cluster (section V.A)."""

    r: float                  # t_msg / t_grad_full
    t_msg: float              # mean observed send->receive time per message
    t_grad_full: float        # median local step time * n (full-data grad)
    n_messages: int
    n_steps: int
    drop_rate: float          # fraction of messages lost in flight
