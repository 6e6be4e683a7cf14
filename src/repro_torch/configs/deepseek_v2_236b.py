"""deepseek-v2-236b [moe] -- 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400; MLA kv_lora=512 q_lora=1536 rope_head=64; MoE 2 shared + 160
routed top-6; first layer dense (d_ff 12288). [arXiv:2405.04434]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    d_model=5120, vocab_size=102400,
    prologue=("mla",),
    superblock=("mla_moe",), n_super=59,
    num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=12288, mlp_act="swiglu",
    moe_experts=160, moe_top_k=6, moe_shared=2, moe_d_ff=1536,
    mla_kv_lora=512, mla_q_lora=1536, mla_rope_head_dim=64,
    mla_v_head_dim=128,
    rope_theta=10000.0,
    train_microbatches=16,
    opt_moments_bf16=True,
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    d_model=128, vocab_size=512,
    prologue=("mla",),
    superblock=("mla_moe",), n_super=2,
    num_heads=8, num_kv_heads=8, head_dim=16,
    d_ff=256, mlp_act="swiglu",
    moe_experts=8, moe_top_k=2, moe_shared=1, moe_d_ff=64,
    mla_kv_lora=32, mla_q_lora=48, mla_rope_head_dim=8,
    mla_v_head_dim=16,
    rope_theta=10000.0,
)

SHAPES = lm_shapes(long_ok=False)
