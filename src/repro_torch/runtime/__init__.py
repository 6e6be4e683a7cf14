"""Runtime helpers, the port of `repro.runtime`'s host half: straggler and
deadline math (`fault_tolerance`, numpy, which the adaptive controller's
straggler reweighting also reads) and elastic membership (`elastic`). The
reference's sharding rules map the LM stack onto a mesh of chips and come
with the multi-card slice."""

from repro_torch.runtime.elastic import (RescalePlan, plan_rescale,
                                         rescale_state)
from repro_torch.runtime.fault_tolerance import (StragglerModel,
                                                 arrival_reweighted_matrix,
                                                 degraded_matrix,
                                                 effective_round_time,
                                                 sinkhorn_project)
