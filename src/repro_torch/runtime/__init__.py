"""Runtime helpers, the port of `repro.runtime`'s host half: straggler and
deadline math (`fault_tolerance`, numpy, which the adaptive controller's
straggler reweighting also reads), elastic membership (`elastic`) and the
logical sharding rules (`sharding`), which map the LM stack's leaves onto
a mesh for the dry-run's per-device bytes."""

from repro_torch.runtime.elastic import (RescalePlan, plan_rescale,
                                         rescale_state)
from repro_torch.runtime.fault_tolerance import (StragglerModel,
                                                 arrival_reweighted_matrix,
                                                 degraded_matrix,
                                                 effective_round_time,
                                                 sinkhorn_project)
from repro_torch.runtime.sharding import (DEFAULT_RULES, constrain,
                                          tree_placements, tree_specs,
                                          use_rules)
