"""codeqwen1.5-7b [dense] -- 32L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=13440 vocab=92416; QKV bias (qwen1.5 arch). [hf:Qwen/CodeQwen1.5-7B]"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    d_model=4096, vocab_size=92416,
    superblock=("attn",), n_super=32,
    num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=13440, mlp_act="swiglu", qkv_bias=True,
    rope_theta=1000000.0,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    d_model=128, vocab_size=512,
    superblock=("attn",), n_super=2,
    num_heads=8, num_kv_heads=8, head_dim=16,
    d_ff=256, mlp_act="swiglu", qkv_bias=True,
    rope_theta=1000000.0,
)

SHAPES = lm_shapes(long_ok=False)
