"""Shared model-definition machinery, the port of `repro.models.common`:
configs, param construction with logical sharding axes, norms, rotary
embeddings, activations and the loss.

Every parameter is built through `p(key, shape, axes)` which returns a
`(tensor, axes)` pair; `split_axes` separates the two parallel trees. The
logical axis names map to mesh axes through `runtime.sharding`: a sharded
pod's leaves are DTensors placed by them (`launch/specs.py`). Under
`drawing_blocks` every leaf is built as one block of itself (a rank's
shard), each element as the whole leaf has it.

Rounding follows the reference's casts: weights in `cfg.dtype` (bf16),
norm scales float32, `rms_norm`, `apply_rope` and the loss computed in
float32 and cast back where the reference casts. The reference's
`barrier` (an XLA optimization barrier that pins layouts) has no meaning
in eager PyTorch and is left out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Sequence

import torch

from repro_torch.compress import prng
from repro_torch.runtime.sharding import is_dtensor

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


class _Draw(threading.local):
    def __init__(self):
        self.block_of: Callable | None = None


_DRAW = _Draw()


@contextlib.contextmanager
def drawing_blocks(block_of: Callable):
    """Build every leaf as one block of itself on this thread: `p`, `pz`
    and the leaves computed without a draw make only the block that
    `block_of(shape, axes)` names for a leaf of that shape and logical
    axes, an (offset, length) pair a dimension (a rank's shard,
    `launch.train.draw_shards`), each element as the whole leaf has it.
    The previous rule comes back on exit."""
    prev = _DRAW.block_of
    _DRAW.block_of = block_of
    try:
        yield
    finally:
        _DRAW.block_of = prev


def leaf_block(shape: Sequence[int], axes: Sequence[str | None]
               ) -> prng.Block:
    """The block of a leaf of `shape` and logical `axes` to build: the
    installed `drawing_blocks` rule's, else the whole leaf."""
    if _DRAW.block_of is None:
        return tuple((0, n) for n in shape)
    return tuple(_DRAW.block_of(tuple(shape), tuple(axes)))


def p(key: prng.Key, shape: Sequence[int], axes: tuple[str | None, ...],
      dtype=torch.bfloat16, scale: float | None = None):
    """Build one parameter leaf: (truncated-normal tensor, logical axes),
    drawn on the key's device with jax's bits (`prng.truncated_normal`);
    under `drawing_blocks` its block alone, scaled by the whole leaf's
    fan-in."""
    assert len(shape) == len(axes), (shape, axes)
    if scale is None:
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    block = None if _DRAW.block_of is None else leaf_block(shape, axes)
    arr = prng.truncated_normal(key, -2.0, 2.0, tuple(shape), scale=scale,
                                out_dtype=dtype, block=block)
    return arr, axes


def pz(shape: Sequence[int], axes: tuple[str | None, ...], dtype=torch.bfloat16,
       fill: float = 0.0, device=None):
    """Constant-initialized parameter (biases, norm scales); under
    `drawing_blocks` its block alone."""
    assert len(shape) == len(axes), (shape, axes)
    local = tuple(n for _, n in leaf_block(shape, axes))
    return torch.full(local, fill, dtype=dtype, device=device), axes


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
    if _scale_apart(x, scale):
        return _rms_norm_local(x, scale, eps)
    return _scaled(_normed(x, eps), scale, x.dtype)


def _normed(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x over the root mean square of its last dim, in float32."""
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _scaled(normed: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (normed * (1.0 + scale.float())).to(dtype)


def _scale_apart(x, scale) -> bool:
    """A DTensor scale sharded (a decode step's FSDP'd norm, not gathered)
    beside a DTensor x whose last dim lies whole on every rank."""
    return (is_dtensor(x) and is_dtensor(scale)
            and any(pl.is_shard() for pl in scale.placements)
            and not any(pl.is_shard(x.ndim - 1) for pl in x.placements))


def _rms_norm_local(x, scale, eps: float):
    """`rms_norm` on each rank's local shards (`local_map`), the scale
    where it lies: each rank normalizes its own rows (their last dim lies
    whole on it), the normed rows go to the columns of the rank's scale
    shard (an all-to-all where the rows lie over the scale's mesh dims,
    a slice where they lie whole), and those columns are scaled; the
    output sharded on its last dim there, as the projections after it
    take it. Gradients: the scale's a partial sum over the mesh dims that
    shard the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    sp = tuple(scale.placements)
    rows = tuple(Replicate() if pl.is_partial() else pl
                 for pl in x.placements)
    if rows != tuple(x.placements):
        x = x.redistribute(mesh, rows)
    normed = local_map(lambda a: _normed(a, eps), out_placements=(rows,),
                       in_placements=(rows,), device_mesh=mesh)(x)
    cols = tuple(Shard(x.ndim - 1) if s.is_shard() else pl
                 for pl, s in zip(rows, sp))
    s_grad = tuple(s if s.is_shard() else Partial() if pl.is_shard()
                   else Replicate() for pl, s in zip(cols, sp))
    return local_map(lambda a, b: _scaled(a, b, x.dtype),
                     out_placements=(cols,), in_placements=(cols, sp),
                     in_grad_placements=(cols, s_grad),
                     device_mesh=mesh)(normed.redistribute(mesh, cols),
                                       scale)


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


def promoted_einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """`jnp.einsum` of operands whose dtypes differ: each is cast to their
    promoted dtype (bf16 with float32 gives float32, exact), as jax
    promotes them; `torch.einsum` refuses mixed dtypes."""
    dt = operands[0].dtype
    for o in operands[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in operands))


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "squared_relu":
        r = torch.clamp(x, min=0.0)
        return r * r
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"activation {kind} handled in mlp (swiglu) or unknown")


def shard_offset(t, dim: int) -> int:
    """The global index of this rank's first element of DTensor `t` along
    `dim` (its shards even: the rules shard only dimensions their ranks
    divide)."""
    mesh = t.device_mesh
    chunk = 0
    for d, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            chunk = chunk * mesh.size(d) + mesh.get_local_rank(d)
    return chunk * t.to_local().shape[dim]


def _gold(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`torch.gather(logits, -1, idx)`, idx (..., 1). DTensor logits (none
    of their placements partial) are taken on each rank's local shards
    (`local_map`): a rank whose vocab
    shard holds the label takes its logit and the others 0, a partial sum
    over the mesh dims that shard the vocab, as DTensor's own gather
    gives it; the gradient is scattered into zeros of the rank's shard.
    (DTensor's gather backward makes those zeros replicated, the whole
    logits on every rank.)"""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, idx)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.ndim - 1
    lp = tuple(logits.placements)
    ip = tuple(Replicate() if pl.is_shard(last) else pl for pl in lp)
    op = tuple(Partial() if pl.is_shard(last) else pl for pl in lp)
    lo = shard_offset(logits, last)

    def local(lg, ix):
        rel = ix - lo
        inside = (rel >= 0) & (rel < lg.shape[-1])
        g = torch.gather(lg, -1, rel.clamp(0, lg.shape[-1] - 1))
        return torch.where(inside, g, torch.zeros_like(g))
    return local_map(local, out_placements=(op,), in_placements=(lp, ip),
                     in_grad_placements=(lp, ip), device_mesh=mesh)(
        logits, idx.redistribute(mesh, ip))


def all_reduce(t: torch.Tensor, mesh, dims, op: str = "sum"
               ) -> torch.Tensor:
    """`t` all-reduced by `op` over the mesh dims `dims` (DTensor's
    functional collectives)."""
    from torch.distributed import _functional_collectives as funcol

    for d in dims:
        t = funcol.all_reduce(t, op, (mesh, d))
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _LogSumExpOverRanks(torch.autograd.Function):
    """`torch.logsumexp(x, dim=-1)` of a vocabulary sharded over the mesh
    dims `dims`, on a rank's shard `x`: its max all-reduced (max), its sum
    of exp(x - max) all-reduced (sum), the log of the sum plus the max.
    The result is replicated over those ranks and so is its gradient: the
    backward is `torch.logsumexp`'s, grad * exp(x - result), on the
    rank's shard."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        m = all_reduce(torch.amax(x, dim=-1, keepdim=True), mesh, dims,
                       "max")
        total = all_reduce(torch.sum(torch.exp(x - m), dim=-1,
                                     keepdim=True), mesh, dims)
        out = torch.log(total) + m
        ctx.save_for_backward(x, out)
        return out[..., 0]

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad[..., None] * torch.exp(x - out), None, None


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """`torch.logsumexp(logits, dim=-1)`. DTensor logits (none of their
    placements partial) are taken on each rank's local shards
    (`local_map`), the vocabulary never gathered:
    where mesh dims of more than one rank shard the vocab, by
    `_LogSumExpOverRanks`, replicated over those dims, the gradient on
    each rank's shard; elsewhere by `torch.logsumexp` of the local
    logits."""
    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.ndim - 1
    lp = tuple(logits.placements)
    vocab = [d for d, pl in enumerate(lp)
             if pl.is_shard(last) and mesh.size(d) > 1]
    op = tuple(Replicate() if pl.is_shard(last) else pl for pl in lp)

    def local(lg):
        if not vocab:
            return torch.logsumexp(lg, dim=-1)
        return _LogSumExpOverRanks.apply(lg, mesh, vocab)
    return local_map(local, out_placements=(op,), in_placements=(lp,),
                     in_grad_placements=(lp,), device_mesh=mesh)(logits)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels < 0 are masked out. The
    log-sum-exp and the gold logits of vocab-sharded DTensor logits run on
    each rank's shard (`_logsumexp`, `_gold`), partial logits first
    reduced."""
    logits = logits.float()
    if is_dtensor(logits) and any(pl.is_partial() for pl in logits.placements):
        from torch.distributed.tensor import Replicate

        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if pl.is_partial() else pl
            for pl in logits.placements])
    logz = _logsumexp(logits)
    gold = _gold(logits, torch.clamp(labels, min=0)[..., None].long())
    # subtracted before the trailing dimension goes, so a vocab-sharded
    # DTensor's masked partial gold is reduced at the gather's own shape
    nll = (logz[..., None] - gold)[..., 0]
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
