from repro_torch.optim.optimizers import (Optimizer, OptState, adamw,
                                          dual_averaging, sgd)
from repro_torch.optim.lr import (constant_lr, cosine_lr, rsqrt_lr,
                                  warmup_cosine)
