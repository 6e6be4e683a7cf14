"""falcon-mamba-7b [ssm] -- 64L d_model=4096 attention-free d_ff=0
vocab=65024 ssm_state=16; pure Mamba-1. [arXiv:2410.05355]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    d_model=4096, vocab_size=65024,
    superblock=("mamba1",), n_super=64,
    d_ff=0, ssm_state=16, ssm_conv=4, ssm_expand=2,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    d_model=128, vocab_size=512,
    superblock=("mamba1",), n_super=2,
    d_ff=0, ssm_state=8, ssm_conv=4, ssm_expand=2,
)

SHAPES = lm_shapes(long_ok=True)
