"""FaultPlan: the frozen, JSON-exact spec for deterministic fault injection.

A plan is data, not behavior: explicit `FaultEvent`s pin crashes, restarts,
joins, leaves, and link partitions/heals to exact sim times, while the
stochastic knobs (exponential MTBF crashes, flapping links) describe renewal
processes that `repro_torch.faults.runtime.FaultRuntime` drives from the plan's
OWN seeded RNG stream -- the optimization stream (`NetSimulator(seed=...)`)
never sees a fault-related draw, so turning faults on cannot silently
re-randomize losses or jitter.

Plans resolve through the `faultplans` registry exactly like every other
`ExperimentSpec` component:

    "faults": {"kind": "churn", "params": {"frac": 0.2, "period": 2.0,
                                           "downtime": 0.5, "cycles": 4}}

The builders take the problem size `n` from the runner context so manifests
stay size-agnostic; explicit plans validate node ids against it.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.experiments.registry import Registry

__all__ = ["FaultEvent", "FaultPlan", "faultplans"]

_ACTIONS = ("crash", "restart", "join", "leave", "partition", "heal")
_NODE_ACTIONS = ("crash", "restart", "join", "leave")
_RESTORES = ("warm", "checkpoint")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: `action` fires at sim time `time`.

    `node` targets crash/restart/join/leave; `group` names one side of a
    partition cut (every link crossing the cut blocks, both directions,
    until the next `heal`)."""

    time: float
    action: str
    node: int = -1
    group: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "time", float(self.time))
        object.__setattr__(self, "node", int(self.node))
        object.__setattr__(self, "group",
                           tuple(int(g) for g in self.group))
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(one of {_ACTIONS})")
        if not (math.isfinite(self.time) and self.time >= 0.0):
            raise ValueError(f"fault time must be finite and >= 0, "
                             f"got {self.time}")
        if self.action in _NODE_ACTIONS and self.node < 0:
            raise ValueError(f"{self.action!r} needs a node id")
        if self.action == "partition" and not self.group:
            raise ValueError("'partition' needs a non-empty group")

    def to_dict(self) -> dict:
        d = {"time": self.time, "action": self.action}
        if self.action in _NODE_ACTIONS:
            d["node"] = self.node
        if self.action == "partition":
            d["group"] = list(self.group)
        return d


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Everything the fault runtime needs, frozen and JSON round-trippable.

    Deterministic layer: `events`. Stochastic layer: `crash_mtbf` /
    `crash_mttr` draw exponential crash/repair dwell times (capped at
    `max_crashes` total when > 0), `flap_links` toggle up/down with
    `flap_mtbf` / `flap_mttr` dwells; all draws come from
    `default_rng(seed)` and nothing else touches that stream.

    Recovery: `restore="warm"` restarts a node from the survivors'
    consensus average (`elastic.rescale_state` semantics);
    `restore="checkpoint"` resumes from the latest periodic in-sim
    snapshot (taken every `checkpoint_every` sim-time units; persisted
    through `checkpoint.CheckpointManager` when `checkpoint_dir` is set,
    otherwise held in memory)."""

    events: tuple[FaultEvent, ...] = ()
    crash_mtbf: float = 0.0
    crash_mttr: float = 0.0
    max_crashes: int = 0
    flap_links: tuple[tuple[int, int], ...] = ()
    flap_mtbf: float = 0.0
    flap_mttr: float = 0.0
    restore: str = "warm"
    checkpoint_every: float = 0.0
    checkpoint_dir: str | None = None
    checkpoint_keep: int = 3
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            ev if isinstance(ev, FaultEvent) else FaultEvent(**ev)
            for ev in self.events))
        object.__setattr__(self, "flap_links", tuple(
            (int(a), int(b)) for a, b in self.flap_links))
        if self.restore not in _RESTORES:
            raise ValueError(f"restore must be one of {_RESTORES}, "
                             f"got {self.restore!r}")
        for name in ("crash_mtbf", "crash_mttr", "flap_mtbf", "flap_mttr",
                     "checkpoint_every"):
            v = getattr(self, name)
            if not (math.isfinite(v) and v >= 0.0):
                raise ValueError(f"{name} must be finite and >= 0, got {v}")
        if self.max_crashes < 0:
            raise ValueError("max_crashes must be >= 0 (0 = uncapped)")
        if self.flap_links and not (self.flap_mtbf > 0.0
                                    and self.flap_mttr > 0.0):
            raise ValueError("flap_links need flap_mtbf > 0 and "
                             "flap_mttr > 0")
        if self.restore == "checkpoint" and self.checkpoint_every <= 0.0:
            raise ValueError("restore='checkpoint' needs "
                             "checkpoint_every > 0")
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        for a, b in self.flap_links:
            if a == b or a < 0 or b < 0:
                raise ValueError(f"bad flap link ({a}, {b})")

    def validate_for(self, n: int) -> "FaultPlan":
        """Check every node id against the problem size; returns self."""
        for ev in self.events:
            if ev.action in _NODE_ACTIONS and not 0 <= ev.node < n:
                raise ValueError(f"fault event node {ev.node} out of range "
                                 f"for n={n}")
            for g in ev.group:
                if not 0 <= g < n:
                    raise ValueError(f"partition group id {g} out of range "
                                     f"for n={n}")
        for a, b in self.flap_links:
            if a >= n or b >= n:
                raise ValueError(f"flap link ({a}, {b}) out of range "
                                 f"for n={n}")
        return self

    def to_dict(self) -> dict:
        return {"events": [ev.to_dict() for ev in self.events],
                "crash_mtbf": self.crash_mtbf,
                "crash_mttr": self.crash_mttr,
                "max_crashes": self.max_crashes,
                "flap_links": [list(l) for l in self.flap_links],
                "flap_mtbf": self.flap_mtbf,
                "flap_mttr": self.flap_mttr,
                "restore": self.restore,
                "checkpoint_every": self.checkpoint_every,
                "checkpoint_dir": self.checkpoint_dir,
                "checkpoint_keep": self.checkpoint_keep,
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultPlan keys: {sorted(unknown)}")
        if "flap_links" in d:
            d["flap_links"] = tuple(tuple(l) for l in d["flap_links"])
        return cls(**d)


faultplans = Registry("faultplan")


@faultplans.register("plan")
def _build_plan(n: int, events=(), **kw) -> FaultPlan:
    """Explicit FaultEvent list plus stochastic crash/flap knobs."""
    return FaultPlan(events=tuple(events), **kw).validate_for(n)


@faultplans.register("churn")
def _build_churn(n: int, frac: float = 0.2, period: float = 2.0,
                 downtime: float = 0.5, start: float = 1.0, cycles: int = 4,
                 **kw) -> FaultPlan:
    """Preset: every `period` sim-time units starting at `start`, crash the
    next `ceil(frac * n)` nodes (round-robin over the cluster) and restart
    them `downtime` later. Size-agnostic: `n` comes from the runner."""
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    if not 0.0 < downtime < period:
        raise ValueError("need 0 < downtime < period so each wave restarts "
                         "before the next one crashes")
    if cycles < 1:
        raise ValueError("cycles must be >= 1")
    m = max(1, math.ceil(frac * n))
    if m >= n:
        raise ValueError(f"churn frac={frac} would crash all {n} nodes at "
                         "once; keep frac < 1 - 1/n")
    events = []
    for c in range(cycles):
        t = start + c * period
        for j in range(m):
            node = (c * m + j) % n
            events.append(FaultEvent(time=t, action="crash", node=node))
            events.append(FaultEvent(time=t + downtime, action="restart",
                                     node=node))
    return FaultPlan(events=tuple(events), **kw).validate_for(n)
