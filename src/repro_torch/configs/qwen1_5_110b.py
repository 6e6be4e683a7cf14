"""qwen1.5-110b [dense] -- 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064; QKV bias. [hf:Qwen/Qwen1.5-110B family]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-110b", family="dense",
    d_model=8192, vocab_size=152064,
    superblock=("attn",), n_super=80,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=49152, mlp_act="swiglu", qkv_bias=True,
    rope_theta=1000000.0,
    train_microbatches=8,
    mlp_tp=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense",
    d_model=128, vocab_size=512,
    superblock=("attn",), n_super=3,
    num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=384, mlp_act="swiglu", qkv_bias=True,
    rope_theta=1000000.0,
)

SHAPES = lm_shapes(long_ok=False)
