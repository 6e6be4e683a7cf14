"""The pieces of `repro.netsim` the dense slice of the port needs: the
quadratic consensus data generator and the `RMeasurement` record a
`RunResult` carries. The event-driven simulator itself is not ported yet."""

from repro_torch.netsim.problems import quadratic_consensus
from repro_torch.netsim.simulator import RMeasurement
