"""llama3-8b [dense] -- 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; SwiGLU, rope theta 500k. [arXiv:2407.21783]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama3-8b", family="dense",
    d_model=4096, vocab_size=128256,
    superblock=("attn",), n_super=32,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, mlp_act="swiglu",
    rope_theta=500000.0,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="dense",
    d_model=128, vocab_size=512,
    superblock=("attn",), n_super=2,
    num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, mlp_act="swiglu",
    rope_theta=500000.0,
)

SHAPES = lm_shapes(long_ok=False)
