"""Shared model-definition machinery, the port of `repro.models.common`:
configs, param construction with logical sharding axes, norms, rotary
embeddings, activations and the loss.

Every parameter is built through `p(key, shape, axes)` which returns a
`(tensor, axes)` pair; `split_axes` separates the two parallel trees. The
logical axis names stay as data: the port stacks a run's pods on one card,
and mapping them to mesh axes waits for the multi-card slice.

Rounding follows the reference's casts: weights in `cfg.dtype` (bf16),
norm scales float32, `rms_norm`, `apply_rope` and the loss computed in
float32 and cast back where the reference casts. The reference's
`barrier` (an XLA optimization barrier that pins layouts) has no meaning
in eager PyTorch and is left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from repro_torch.compress import prng

PyTree = Any

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes any of the supported families.

    The layer stack is `prologue` blocks followed by `n_super` repetitions of
    `superblock`. Block kinds:
      "attn"        self-attention (GQA/RoPE) + MLP
      "attn_moe"    self-attention + MoE FFN
      "mla"         multi-head latent attention (DeepSeek) + MLP
      "mla_moe"     MLA + MoE FFN
      "cross_attn"  cross-attention to encoder states + MLP (VLM)
      "mamba1"      Mamba-1 selective-scan block (attn-free)
      "mamba2"      Mamba-2 SSD block
      "shared_attn" the hybrid's weight-shared attention block (zamba2)
    The port builds and runs "attn", "attn_moe", "mla" and "mla_moe" so
    far; the others raise.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    superblock: tuple[str, ...]
    n_super: int
    prologue: tuple[str, ...] = ()
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"          # swiglu | squared_relu | gelu
    # Megatron TP-MLP instead of the sequence-parallel MLP (a sharding
    # choice of the reference's mesh; the same function on one card)
    mlp_tp: bool = False
    # moe
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0                # expert hidden size (defaults to d_ff)
    moe_capacity_factor: float = 1.25
    # mla
    mla_kv_lora: int = 0
    mla_q_lora: int = 0
    mla_rope_head_dim: int = 64
    mla_v_head_dim: int = 0          # 0 -> head_dim
    # ssm
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64           # mamba2
    # hybrid / vlm / audio frontends
    shared_attn_lora: int = 64       # zamba2 per-invocation LoRA rank
    num_encoder_tokens: int = 0      # VLM: vision tokens; audio: frame count
    encoder_dim: int = 0             # stubbed frontend embedding dim
    # training
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    remat: bool = True
    # gradient-accumulation factor for the reference's production train
    # step (its dry-run); the consensus launcher runs one microbatch
    train_microbatches: int = 1
    # bf16 Adam moments (the 400B-class configs; updates stay fp32)
    opt_moments_bf16: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def num_layers(self) -> int:
        return len(self.prologue) + self.n_super * len(self.superblock)

    @property
    def blocks(self) -> tuple[str, ...]:
        return self.prologue + self.superblock * self.n_super

    def has_block(self, kind_prefix: str) -> bool:
        return any(b.startswith(kind_prefix) for b in self.blocks)

    @property
    def is_attention_free(self) -> bool:
        return not any(
            b in ("attn", "attn_moe", "mla", "mla_moe", "cross_attn",
                  "shared_attn") for b in self.blocks)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic memory path: SSM and hybrid families only."""
        return self.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Params with logical axes
# ---------------------------------------------------------------------------


def p(key: prng.Key, shape: Sequence[int], axes: tuple[str | None, ...],
      dtype=torch.bfloat16, scale: float | None = None):
    """Build one parameter leaf: (truncated-normal tensor, logical axes),
    drawn on the key's device with jax's bits (`prng.truncated_normal`)."""
    assert len(shape) == len(axes), (shape, axes)
    if scale is None:
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    arr = prng.truncated_normal(key, -2.0, 2.0, tuple(shape), scale=scale,
                                out_dtype=dtype)
    return arr, axes


def pz(shape: Sequence[int], axes: tuple[str | None, ...], dtype=torch.bfloat16,
       fill: float = 0.0, device=None):
    """Constant-initialized parameter (biases, norm scales)."""
    assert len(shape) == len(axes), (shape, axes)
    return torch.full(tuple(shape), fill, dtype=dtype, device=device), axes


def is_param_pair(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], tuple)
            and all(isinstance(a, (str, type(None))) for a in x[1]))


def _map_pairs(fn, tree):
    if is_param_pair(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_pairs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_pairs(fn, v) for v in tree]
    raise TypeError(f"not a tree of (tensor, axes) pairs: {type(tree)}")


def split_axes(tree: PyTree) -> tuple[PyTree, PyTree]:
    """Split a tree of (tensor, axes) pairs into (tensors, axes) trees."""
    return _map_pairs(lambda x: x[0], tree), _map_pairs(lambda x: x[1], tree)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    angles = positions[..., :, None].float() * freqs        # (..., s, hd/2)
    angles = angles[..., None, :]                           # (..., s, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "squared_relu":
        r = torch.clamp(x, min=0.0)
        return r * r
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"activation {kind} handled in mlp (swiglu) or unknown")


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels < 0 are masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
