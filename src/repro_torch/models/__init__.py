from repro_torch.models.common import ModelConfig, cross_entropy_loss
from repro_torch.models.registry import (ARCH_IDS, get_config, get_shapes,
                                         list_archs)
from repro_torch.models import transformer
