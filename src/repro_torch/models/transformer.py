"""Decoder assembly, the port of `repro.models.transformer`'s training path:
embeddings + (prologue blocks + stacked superblocks) + final norm + LM
head, with `init`, `forward` and `loss_fn`.

The layer stack is `cfg.prologue` followed by `cfg.n_super` repetitions of
`cfg.superblock`; per-slot parameters are stacked over the repetitions, as
the reference stacks them for its scan. `forward` loops over the
repetitions, and with `cfg.remat` checkpoints each one (the reference's
`jax.checkpoint` with `nothing_saveable` around its scan body: only the
residual stream between superblocks is kept for the backward pass). With
`cfg.remat` each prologue block is checkpointed too, which the reference
leaves outside its scan for XLA to schedule: the values and gradients are
the same, and a full-width prologue (deepseek-v2's MLA layer, 128 heads)
then keeps no attention chunks alive through the stack's backward.

A stacked leaf may also be handed to `forward` as a sequence of per-layer
tensors (`launch.steps` does, so that each layer's gradient is its own
tensor and no per-layer slice of a stacked leaf scatters into a zero
tensor of the whole stack on the backward pass).

Block kinds ported: "attn", "attn_moe", "mla" and "mla_moe" (GQA or MLA
attention, then the dense or the MoE FFN). The others (cross_attn,
mamba1, mamba2, shared_attn) raise `NotImplementedError`; so do one-token
decode and its caches. They come with later slices. `moe_groups` is the
MoE dispatch groups (`mlp.moe_apply`'s `groups`), threaded through
`forward` and `loss_fn` as the reference threads it.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compress import prng
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (ModelConfig, cross_entropy_loss, p,
                                       pz, rms_norm, split_axes)

PyTree = Any

#: the block kinds this port builds and runs
PORTED_KINDS = ("attn", "attn_moe", "mla", "mla_moe")


def _not_ported(kind: str):
    raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                              f"(a later slice of the port; ported: "
                              f"{PORTED_KINDS})")


def check_config(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` naming the first block kind of `cfg`
    that the port does not build."""
    for kind in cfg.prologue + cfg.superblock:
        if kind not in PORTED_KINDS:
            _not_ported(kind)


def _block_init(kind: str, key: prng.Key, cfg: ModelConfig) -> PyTree:
    if kind not in PORTED_KINDS:
        _not_ported(kind)
    k1, k2 = prng.split(key)
    mixer = attn.mla_init if kind.startswith("mla") else attn.gqa_init
    if kind.endswith("_moe"):
        return {"attn": mixer(k1, cfg), "moe": mlp_mod.moe_init(k2, cfg)}
    return {"attn": mixer(k1, cfg), "mlp": mlp_mod.mlp_init(k2, cfg)}


def _block_apply(kind: str, prm, x, cfg: ModelConfig, positions,
                 moe_groups: int):
    if kind not in PORTED_KINDS:
        _not_ported(kind)
    mixer = attn.mla_apply if kind.startswith("mla") else attn.gqa_apply
    x = x + mixer(prm["attn"], x, cfg, positions)
    if kind.endswith("_moe"):
        return x + mlp_mod.moe_apply(prm["moe"], x, cfg, groups=moe_groups)
    return x + mlp_mod.mlp_apply(prm["mlp"], x, cfg)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stacked(layers: list[PyTree]) -> PyTree:
    """Per-layer trees stacked leaf by leaf into preallocated (L, ...)
    tensors (no transient second copy of the stack)."""
    def stack(path_leaves):
        first = path_leaves[0]
        out = torch.empty((len(path_leaves),) + tuple(first.shape),
                          dtype=first.dtype, device=first.device)
        for j, leaf in enumerate(path_leaves):
            out[j].copy_(leaf)
        return out

    def walk(trees):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees]) for k in trees[0]}
        return stack(trees)
    return walk(layers)


def init(key: prng.Key, cfg: ModelConfig) -> tuple[PyTree, PyTree]:
    """Returns (params, logical_axes) trees, their dicts in sorted key order
    (jax's leaf order), drawn on the key's device with the reference's
    keys: `split(key, 8)`; the embedding from key 0, the
    LM head from key 1, the prologue from key 2's split, and stacked slot
    i's repetition j from `fold_in(key 4, i * 1000 + j)`."""
    check_config(cfg)
    dev = key[0].device
    keys = prng.split(key, 8)
    pairs: dict[str, Any] = {
        "embed": p(keys[0], (cfg.vocab_size, cfg.d_model),
                   ("vocab", "embed"), cfg.dtype, scale=1.0),
        "final_norm": pz((cfg.d_model,), ("embed",), torch.float32,
                         device=dev),
    }
    if not cfg.tie_embeddings:
        pairs["lm_head"] = p(keys[1], (cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"), cfg.dtype)
    if cfg.prologue:
        pk = prng.split(keys[2], len(cfg.prologue))
        pairs["prologue"] = [_block_init(kind, pk[i], cfg)
                             for i, kind in enumerate(cfg.prologue)]
    params, axes = split_axes(pairs)

    stack_params: dict[str, Any] = {}
    stack_axes: dict[str, Any] = {}
    for i, kind in enumerate(cfg.superblock):
        layers, slot_axes = [], None
        for j in range(cfg.n_super):
            arrays, slot_axes = split_axes(_block_init(
                kind, prng.fold_in(keys[4], i * 1000 + j), cfg))
            layers.append(arrays)
        stack_params[f"slot{i}"] = _stacked(layers)
        del layers
        stack_axes[f"slot{i}"] = _map_leaves(lambda a: ("layers",) + a,
                                             slot_axes)
    params["stack"] = stack_params
    axes["stack"] = stack_axes
    return _sorted(params), _sorted(axes)


def _sorted(tree: PyTree) -> PyTree:
    """Every dict's keys in sorted order, jax's leaf order: a tree's leaves
    then come in the reference's order wherever it is flattened (the
    optimizer state built from it, the checkpoint's leaf numbers)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(cfg.dtype)


def _unembed(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"])
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return torch.einsum("bsd,dv->bsv", x, head)


def _layer(tree: PyTree, j: int) -> PyTree:
    """Repetition j of a stacked slot: a view of each (L, ...) leaf, or
    element j of a per-layer sequence."""
    return _map_leaves(lambda leaf: leaf[j], tree)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            moe_groups: int = 1) -> torch.Tensor:
    """Training/prefill forward -> logits (B,S,V) in `cfg.dtype`."""
    check_config(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    x = _embed(params, tokens, cfg)

    def block(x, kind, prm):
        return _block_apply(kind, prm, x, cfg, positions, moe_groups)

    for i, kind in enumerate(cfg.prologue):
        if remat:
            x = checkpoint(block, x, kind, params["prologue"][i],
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, kind, params["prologue"][i])

    def superblock(x, slots):
        for i, kind in enumerate(cfg.superblock):
            x = block(x, kind, slots[f"slot{i}"])
        return x

    for j in range(cfg.n_super):
        slots = _layer(params["stack"], j)
        if remat:
            x = checkpoint(superblock, x, slots, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = superblock(x, slots)
    return _unembed(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, moe_groups: int = 1
            ) -> torch.Tensor:
    logits = forward(params, batch["tokens"], cfg, moe_groups=moe_groups)
    return cross_entropy_loss(logits, batch["labels"])
