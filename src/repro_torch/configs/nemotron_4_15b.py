"""nemotron-4-15b [dense] -- 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000; squared-ReLU MLP, no QKV bias. [arXiv:2402.16819]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b", family="dense",
    d_model=6144, vocab_size=256000,
    superblock=("attn",), n_super=32,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, mlp_act="squared_relu",
    rope_theta=10000.0,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense",
    d_model=128, vocab_size=512,
    superblock=("attn",), n_super=2,
    num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, mlp_act="squared_relu",
    rope_theta=10000.0,
)

SHAPES = lm_shapes(long_ok=False)
