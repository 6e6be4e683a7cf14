"""Lane packer: batch shape-compatible specs from different requests, on
the port (`repro.serve.packer` over the port's runner).

`DDASimulator.run_batch` runs B lanes as one program (one capture, one
replayed graph per iteration for every lane), and a lane's result is its
solo run's (tests/test_torch_batch.py, and on the card `chip_smoke.py`'s
`serve` phase). The sweep executor uses that *within* one `run_sweep`
call; the packer extends it *across requests*: dense specs that would run
the same batched program are held briefly (`max_wait_s`) and flushed as
one lane of up to `max_width`, so a burst of shape-compatible traffic
costs one program instead of N.

Admission is an equivalence relation (symmetric + transitive by
construction -- it is equality of `lane_key`), so lanes are well-defined:

  * the spec must be individually batchable -- same predicate the sweep
    executor uses (`repro_torch.experiments.runner.batch_compat_report`);
    when it is not, `lane_key` returns the human-readable reason, which
    the server surfaces as the request's `solo_reason` metrics note;
  * equal `_vmap_signature` -- identical outside the per-lane data fields
    (name, seed, r, schedule, eps_frac), i.e. one program serves every
    lane;
  * equal all-comm bit, as the reference keys it: its `run_batch` picks a
    cond-free program variant when EVERY lane's mask is all-True, and a
    solo run picks it per its own mask. The key is the reference's string
    for the same spec.

The packer is synchronous and clock-injectable (testable without a
server): `admit()` files a request, `pop_ready()` returns lanes that are
full or past their deadline, `flush()` drains everything.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.experiments.runner import (_build_schedule,
                                            _resolve_backend,
                                            _vmap_signature,
                                            batch_compat_report)
from repro_torch.experiments.spec import ComponentSpec, ExperimentSpec

__all__ = ["Lane", "LanePacker", "lane_key"]


def lane_key(spec: ExperimentSpec, backend: ComponentSpec | int | str | None,
             *, device=None) -> tuple[str | None, str | None]:
    """(key, None) when the spec can ride a packed lane, (None, reason)
    when it must run solo. Two specs pack together iff their keys are
    equal -- symmetric and transitive because it is string equality.
    `device` is where the compatibility check builds the (cached) problem
    (None: the CUDA card)."""
    try:
        resolved = _resolve_backend(spec, backend)
        reason = batch_compat_report(spec, resolved, device=device)
        if reason is not None:
            return None, reason
        mask = np.asarray(_build_schedule(spec).comm_mask(0, spec.T),
                          dtype=bool)
        ac = bool(mask.all())
        return json.dumps([_vmap_signature(spec, resolved), ac]), None
    except Exception as e:  # noqa: BLE001 -- a spec that does not even
        # validate must not poison the dispatcher; route it solo, where
        # the ordinary run path raises the real error to the requester
        return None, f"spec does not validate for lane packing: {e}"


@dataclass
class Lane:
    """One flush unit: requests that will run as a single `run_batch`."""

    key: str
    items: list[Any] = field(default_factory=list)
    opened_at: float = 0.0

    @property
    def width(self) -> int:
        return len(self.items)


class LanePacker:
    """Max-wait / max-width admission over `lane_key`-keyed lanes.

    Single-consumer discipline: the server's dispatcher thread is the only
    caller, so no internal locking. `clock` is injectable for tests.
    """

    def __init__(self, max_width: int = 8, max_wait_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if max_width < 1:
            raise ValueError("max_width must be >= 1")
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        self.max_width = max_width
        self.max_wait_s = max_wait_s
        self.clock = clock
        self._open: dict[str, Lane] = {}
        self.packed_requests = 0  # admitted into lanes that flushed at >1
        self.lanes_flushed = 0
        self.widths: list[int] = []  # width of every flushed lane

    def admit(self, key: str, item: Any) -> None:
        lane = self._open.get(key)
        if lane is None:
            lane = self._open[key] = Lane(key=key, opened_at=self.clock())
        lane.items.append(item)

    def pop_ready(self, now: float | None = None) -> list[Lane]:
        """Lanes that must flush: at max_width, or open past max_wait_s."""
        now = self.clock() if now is None else now
        ready = [lane for lane in self._open.values()
                 if lane.width >= self.max_width
                 or now - lane.opened_at >= self.max_wait_s]
        for lane in ready:
            del self._open[lane.key]
            self._account(lane)
        return ready

    def flush(self) -> list[Lane]:
        """Drain every open lane regardless of age (shutdown path)."""
        lanes = list(self._open.values())
        self._open.clear()
        for lane in lanes:
            self._account(lane)
        return lanes

    def next_deadline(self) -> float | None:
        """Earliest instant an open lane expires; None when all idle."""
        if not self._open:
            return None
        return min(lane.opened_at + self.max_wait_s
                   for lane in self._open.values())

    def _account(self, lane: Lane) -> None:
        self.lanes_flushed += 1
        self.widths.append(lane.width)
        if lane.width > 1:
            self.packed_requests += lane.width

    def stats(self) -> dict[str, Any]:
        widths = self.widths
        return {
            "lanes_flushed": self.lanes_flushed,
            "packed_requests": self.packed_requests,
            "mean_width": (sum(widths) / len(widths)) if widths else 0.0,
            "max_width": self.max_width,
            "occupancy": ((sum(widths) / (len(widths) * self.max_width))
                          if widths else 0.0),
            "open_lanes": len(self._open),
        }
