"""llama-3.2-vision-90b [vlm] -- 100 blocks (80 self + 20 cross-attn)
d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; cross-attention image
layers every 5th block. The vision tower is a stub per the assignment:
`input_specs()` supplies precomputed patch embeddings (B, 6400, 7680).
[hf:meta-llama/Llama-3.2-90B-Vision family]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    d_model=8192, vocab_size=128256,
    superblock=("attn", "attn", "attn", "attn", "cross_attn"), n_super=20,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, mlp_act="swiglu",
    num_encoder_tokens=6400, encoder_dim=7680,
    rope_theta=500000.0,
    train_microbatches=16,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-90b-smoke", family="vlm",
    d_model=128, vocab_size=512,
    superblock=("attn", "attn", "cross_attn"), n_super=2,
    num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, mlp_act="swiglu",
    num_encoder_tokens=16, encoder_dim=96,
    rope_theta=500000.0,
)

SHAPES = lm_shapes(long_ok=False)
