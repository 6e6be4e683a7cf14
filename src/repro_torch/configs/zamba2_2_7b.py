"""zamba2-2.7b [hybrid] -- 54 blocks d_model=2560 32H (kv=32) d_ff=10240
vocab=32000 ssm_state=64; Mamba-2 backbone with a weight-SHARED attention
(+FFN) block invoked every 6th position, specialized per invocation by LoRA
adapters. [arXiv:2411.15242]

Simplifications vs. the HF checkpoint (DESIGN.md section 5): one shared
block (zamba2 alternates two), LoRA on q/o projections only, and the shared
block consumes the hidden state directly rather than concat(hidden, embed).
"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    d_model=2560, vocab_size=32000,
    superblock=("mamba2",) * 5 + ("shared_attn",), n_super=9,
    num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, mlp_act="gelu",
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_lora=128,
    rope_theta=10000.0,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    d_model=128, vocab_size=512,
    superblock=("mamba2",) * 2 + ("shared_attn",), n_super=2,
    num_heads=8, num_kv_heads=8, head_dim=16,
    d_ff=256, mlp_act="gelu",
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=32,
    shared_attn_lora=16,
    rope_theta=10000.0,
)

SHAPES = lm_shapes(long_ok=True)
