"""repro_torch.faults -- deterministic fault injection for the netsim engines.

A frozen, JSON-exact `FaultPlan` schedules crashes, restarts, joins,
leaves, link partitions and heals at simulation times -- plus seeded
stochastic processes (exponential MTBF crashes, flapping links) driven by
their own RNG stream, so the main simulation RNG and therefore every
fault-free trace is untouched. `FaultRuntime` executes a plan as
first-class simulation events on EITHER netsim engine through a small
adapter surface (`fault_*` methods); both engines stay bit-identical
under every plan (tests/test_faults.py).
"""

from repro_torch.faults.plan import FaultEvent, FaultPlan, faultplans
from repro_torch.faults.runtime import FaultRuntime, embed_subgraph

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "FaultRuntime",
    "embed_subgraph",
    "faultplans",
]
