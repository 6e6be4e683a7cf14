"""llama4-maverick-400b-a17b [moe] -- 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; MoE 128 routed top-1 + 1 shared expert, MoE layers
interleaved every 2nd layer (Maverick). Early-fusion multimodal frontend is
stubbed per the assignment. [hf:meta-llama/Llama-4 family]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    d_model=5120, vocab_size=202048,
    superblock=("attn", "attn_moe"), n_super=24,
    num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, mlp_act="swiglu",
    moe_experts=128, moe_top_k=1, moe_shared=1, moe_d_ff=8192,
    rope_theta=500000.0,
    train_microbatches=16,
    opt_moments_bf16=True,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke", family="moe",
    d_model=128, vocab_size=512,
    superblock=("attn", "attn_moe"), n_super=2,
    num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, mlp_act="swiglu",
    moe_experts=8, moe_top_k=1, moe_shared=1, moe_d_ff=256,
    rope_theta=500000.0,
)

SHAPES = lm_shapes(long_ok=False)
