"""Event-driven asynchronous cluster simulation, the port of `repro.netsim`:
DDA on a modeled cluster, on an event clock (netsim.events, heap or
bucketed-calendar backend), with heterogeneous node speeds, lossy/jittery
links and an optional time-varying topology (netsim.network), async
stale-gossip and drop-robust push-sum nodes (netsim.node), scenario presets
(netsim.scenarios), the per-node and vectorized struct-of-arrays engines
(netsim.engine) and the driver with empirical-r recovery
(netsim.simulator).

The event loops are host numpy on either device, copied from the
reference so seeded traces are its bit for bit. `NetSimulator(engine=...)`
picks "object" (one Python node object per consensus node), "vectorized"
(stacked (n, d) state, batch queue entries on a calendar clock; bit-identical
to "object") or "auto" (the vectorized engine). Gradients can opt into a
`torch.func.vmap` path, on the card or the CPU, with
`NetSimulator(batch_grad_fn=engine.torch_batch_grad(grad_fn))`.
"""

from repro_torch.netsim.engine import (ObjectEngine, VectorizedEngine,
                                       torch_batch_grad)
from repro_torch.netsim.events import Event, EventQueue
from repro_torch.netsim.network import LinkModel, Network, NodeSpec
from repro_torch.netsim.node import (AsyncDDANode, PushSumDDANode,
                                     pushsum_mass_audit)
from repro_torch.netsim.problems import quadratic_consensus
from repro_torch.netsim.scenarios import (Scenario, adversarial, homogeneous,
                                          lossy, straggler,
                                          time_varying_expander)
from repro_torch.netsim.simulator import NetSimulator, RMeasurement
