"""Runtime helpers the port needs: the part of the fault-tolerance math of
`repro.runtime.fault_tolerance` (numpy) that the adaptive controller's
straggler reweighting reads. The reference's sharding rules belong to the
LM stack and are not part of the port yet."""

from repro_torch.runtime.fault_tolerance import (arrival_reweighted_matrix,
                                                 sinkhorn_project)
