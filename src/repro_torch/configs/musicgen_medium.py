"""musicgen-medium [audio] -- 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens. [arXiv:2306.05284]

Backbone only per the assignment: the EnCodec/conditioning frontend is a
stub -- `input_specs()` supplies precomputed audio-token ids (the 4 codebook
streams are collapsed to a single interleaved stream, the standard "delay
pattern" flattening).
"""

from repro_torch.configs.shapes import lm_shapes
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", family="audio",
    d_model=1536, vocab_size=2048,
    superblock=("attn",), n_super=48,
    num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, mlp_act="gelu",
    rope_theta=10000.0,
    train_microbatches=2,
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="audio",
    d_model=96, vocab_size=256,
    superblock=("attn",), n_super=2,
    num_heads=6, num_kv_heads=6, head_dim=16,
    d_ff=192, mlp_act="gelu",
    rope_theta=10000.0,
)

SHAPES = lm_shapes(long_ok=False)
