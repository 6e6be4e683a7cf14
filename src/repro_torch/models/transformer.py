"""Decoder assembly, the port of `repro.models.transformer`: embeddings +
(prologue blocks + stacked superblocks) + final norm + LM head, with
`init`, the training/prefill `forward` and `loss_fn`, and the one-token
`decode_step` over the caches of `init_cache`.

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

A sharded pod's leaves are DTensors: each block's parameters are
gathered over 'data' where it runs (FSDP; again in the checkpoint's
recomputation), its vectors by `runtime.sharding.gather_axis` and its
matrices by the products that take them (`runtime.sharding.project`,
which runs each product on local shards, the weight gathered over every
mesh dim it needs in one redistribute), and the embedding, the block
outputs (sequence-parallel) and the logits take the reference's
constraints; `enc` is then a DTensor too, placed as the batch's "enc"
field (its rows over 'data'), and the blocks take their own constraints
(the MoE's, MLA's and the cross-attention's included). On one device
these are the identity.

Block kinds: "attn", "attn_moe", "mla" and "mla_moe" (GQA or MLA
attention, then the dense or the MoE FFN); "cross_attn" (the VLM's
tanh-gated cross-attention to the encoder states `enc`, then the dense
FFN); "mamba1" and "mamba2" (the state-space mixers of `models.ssm`,
mixer-only: no FFN after them); and "shared_attn", zamba2's weight-shared
attention block: ONE copy of GQA attention (and of the FFN after it, when
the config has one) at the top level of the tree, `shared_attn`/
`shared_mlp`, specialized per repetition by stacked LoRA deltas on the q
and o projections. The shared weights are threaded through `forward` and
`decode_step` to every block as the reference threads them (`shared`),
and so are `enc` and `moe_groups` (`mlp.moe_apply`'s `groups`).

Decode: `init_cache` builds the cache tree (the prologue's as a list, each
stacked slot's as zeros with a leading repetition axis), and
`decode_step` writes each block's new state into it in place, the
counterpart of the reference's donated cache, and returns the same
tensors. A cross-attention block's cache holds the encoder's K and V,
filled before decode (the reference fills it at prefill, outside
`decode_step`); decode only reads it. zamba2's shared attention has one
GQA cache a repetition, though its weights are shared.

Sharded decode (DTensor parameters and caches, `launch.steps.
make_serve_step` on a serving mesh) keeps every tensor where it lies:
the parameters are not gathered over 'data' (a decode's few tokens meet
their shards, the products' partial sums reduced), the embedding is
looked up where the table lies, each block's output takes the
reference's ("batch", "seq", "embed_act") constraint, and each cache is
written and attended in its own shards (`models.attention`,
`models.ssm`).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device_or_meta
from repro_torch.compress import prng
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ModelConfig, cross_entropy_loss, p,
                                       promoted_einsum, pz, rms_norm,
                                       split_axes)
from repro_torch.runtime.sharding import (constrain, gather_axis, is_dtensor,
                                          local_block, project)

PyTree = Any

def _block_init(kind: str, key: prng.Key, cfg: ModelConfig) -> PyTree:
    if kind in ("attn", "attn_moe", "mla", "mla_moe"):
        k1, k2 = prng.split(key)
        mixer = attn.mla_init if kind.startswith("mla") else attn.gqa_init
        if kind.endswith("_moe"):
            return {"attn": mixer(k1, cfg), "moe": mlp_mod.moe_init(k2, cfg)}
        return {"attn": mixer(k1, cfg), "mlp": mlp_mod.mlp_init(k2, cfg)}
    if kind == "cross_attn":
        k1, k2 = prng.split(key)
        return {"attn": attn.cross_attn_init(k1, cfg),
                "mlp": mlp_mod.mlp_init(k2, cfg)}
    if kind == "mamba1":
        return {"mamba": ssm_mod.mamba1_init(key, cfg)}
    if kind == "mamba2":
        return {"mamba": ssm_mod.mamba2_init(key, cfg)}
    if kind == "shared_attn":
        # LoRA deltas only; shared weights live at top level.
        r = cfg.shared_attn_lora
        D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
        ks = prng.split(key, 4)
        dev = key[0].device
        return {
            "lora_q_a": p(ks[0], (D, r), ("embed", "lora"), cfg.dtype),
            "lora_q_b": pz((r, H, hd), ("lora", "q_heads", "head"),
                           cfg.dtype, device=dev),
            "lora_o_a": p(ks[1], (H, hd, r), ("q_heads", "head", "lora"),
                          cfg.dtype),
            "lora_o_b": pz((r, D), ("lora", "embed"), cfg.dtype, device=dev),
        }
    raise ValueError(f"unknown block kind {kind!r}")


def _mixer_apply(kind: str, prm, x, cfg: ModelConfig, positions, shared,
                 enc):
    if kind in ("attn", "attn_moe"):
        return attn.gqa_apply(prm["attn"], x, cfg, positions)
    if kind in ("mla", "mla_moe"):
        return attn.mla_apply(prm["attn"], x, cfg, positions)
    if kind == "cross_attn":
        return attn.cross_attn_apply(prm["attn"], x, enc, cfg)
    if kind == "mamba1":
        return ssm_mod.mamba1_apply(prm["mamba"], x, cfg, positions)
    if kind == "mamba2":
        return ssm_mod.mamba2_apply(prm["mamba"], x, cfg, positions)
    if kind == "shared_attn":
        return _shared_attn_apply(prm, shared["attn"], x, cfg, positions)
    raise ValueError(kind)


def _ffn_apply(kind: str, prm, x, cfg: ModelConfig, shared,
               moe_groups: int, keep_weights: bool = False):
    """The FFN after a block's mixer, added to the residual: MoE for the
    "_moe" kinds, the block's dense FFN for "attn", "mla" and "cross_attn",
    the shared FFN for "shared_attn" (when the config has one). mamba1 and
    mamba2 blocks are mixer-only (falcon-mamba has d_ff=0); zamba2's shared
    block carries the model's single (shared) FFN. `keep_weights`: a
    decode step's (`runtime.sharding.project`)."""
    if kind.endswith("_moe"):
        return x + mlp_mod.moe_apply(prm["moe"], x, cfg, groups=moe_groups,
                                     keep_weights=keep_weights)
    if kind in ("attn", "mla", "cross_attn"):
        return x + mlp_mod.mlp_apply(prm["mlp"], x, cfg,
                                     keep_weights=keep_weights)
    if kind == "shared_attn" and shared.get("mlp") is not None:
        return x + mlp_mod.mlp_apply(shared["mlp"], x, cfg,
                                     keep_weights=keep_weights)
    return x


def _block_apply(kind: str, prm, x, cfg: ModelConfig, positions, shared,
                 enc, moe_groups: int):
    x = x + _mixer_apply(kind, prm, x, cfg, positions, shared, enc)
    x = _ffn_apply(kind, prm, x, cfg, shared, moe_groups)
    # the residual stream between blocks is sequence-parallel
    return constrain(x, ("batch", "seq_sp", "embed_act"))


def _shared_attn_apply(lora, shared, x, cfg: ModelConfig, positions):
    """zamba2-style weight-shared attention with per-repetition LoRA on the
    q and o projections (the reference's simplification of zamba2's
    shared-block LoRA): the shared attention's output plus a low-rank
    delta of the normed input."""
    base = attn.gqa_apply(shared, x, cfg, positions)
    return base + _lora_delta(lora, rms_norm(x, shared["norm"]))


def _lora_delta(lora, h, keep_weights: bool = False):
    """The shared attention's low-rank delta of the normed input h, each
    product on local shards when sharded (`project`)."""
    kw = dict(keep_weights=keep_weights)
    q_delta = project("bsd,dr->bsr", h, lora["lora_q_a"], **kw)
    q_delta = project("bsr,rhk->bshk", q_delta, lora["lora_q_b"], **kw)
    o_delta = project("bshk,hkr->bsr", q_delta, lora["lora_o_a"], **kw)
    return project("bsr,rd->bsd", o_delta, lora["lora_o_b"], **kw)


# ---------------------------------------------------------------------------
# Cache dispatch
# ---------------------------------------------------------------------------


def _block_init_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                      dtype, device) -> PyTree:
    if kind in ("attn", "attn_moe", "shared_attn"):
        return attn.gqa_init_cache(cfg, batch, max_seq, dtype, device)
    if kind in ("mla", "mla_moe"):
        return attn.mla_init_cache(cfg, batch, max_seq, dtype, device)
    if kind == "cross_attn":
        device = resolve_device_or_meta(device)
        K, hd = cfg.num_kv_heads, cfg.hd
        n = cfg.num_encoder_tokens
        return {"ek": torch.zeros((batch, n, K, hd), dtype=dtype,
                                  device=device),
                "ev": torch.zeros((batch, n, K, hd), dtype=dtype,
                                  device=device)}
    if kind == "mamba1":
        return ssm_mod.mamba1_init_cache(cfg, batch, dtype, device)
    if kind == "mamba2":
        return ssm_mod.mamba2_init_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def _block_decode(kind: str, prm, x, cache, cfg: ModelConfig, pos, shared,
                  moe_groups: int) -> torch.Tensor:
    """One block's decode of x (B,1,D): its mixer over its cache (written in
    place), then its FFN. Returns the residual stream."""
    if kind in ("attn", "attn_moe"):
        out, cache = attn.gqa_decode(prm["attn"], x, cache, cfg, pos)
    elif kind in ("mla", "mla_moe"):
        out, cache = attn.mla_decode(prm["attn"], x, cache, cfg, pos)
    elif kind == "cross_attn":
        out, cache = _cross_decode(prm["attn"], x, cache, cfg)
    elif kind == "mamba1":
        out, cache = ssm_mod.mamba1_decode(prm["mamba"], x, cache, cfg, pos)
    elif kind == "mamba2":
        out, cache = ssm_mod.mamba2_decode(prm["mamba"], x, cache, cfg, pos)
    elif kind == "shared_attn":
        out, cache = _shared_attn_decode(prm, shared["attn"], x, cache, cfg,
                                         pos)
    else:
        raise ValueError(kind)
    x = x + out.to(x.dtype)  # a float32 cache must not promote the carry
    x = _ffn_apply(kind, prm, x, cfg, shared, moe_groups, keep_weights=True)
    return constrain(x, ("batch", "seq", "embed_act"))


def _cross_decode(prm, x, cache, cfg: ModelConfig):
    """Decode-time cross-attention against the encoder K and V held in the
    cache (filled before decode). The scores are divided by sqrt(hd)
    rounded to their own dtype (the reference divides them by `jnp.sqrt`
    of an int, which is weakly typed, before their cast to float32), the
    quotient in float32 and not rounded back, as XLA computes the
    reference's jitted step; `cross_attn_apply` scales by the float32
    root after the cast. DTensor caches (the encoder's tokens over
    'model' under the rules) are attended as they lie: the softmax over
    the tokens split across their ranks (`attention._CacheLayout`)."""
    h = rms_norm(x, prm["norm"])
    q = project("bsd,dhk->bshk", h, prm["wq"], keep_weights=True)
    ek, ev = cache["ek"], cache["ev"]
    if is_dtensor(ek):
        lay = attn._CacheLayout(ek, contracted=3)
        out = _cross_attend(q.redistribute(lay.mesh, lay.query).to_local(),
                            ek.to_local(), ev.to_local(), cfg.hd, x.dtype,
                            lay)
        # back to the queries' layout (where they were partial sums, the
        # cache's)
        out = lay.wrap(out, q.shape, lay.query).redistribute(
            lay.mesh, tuple(lq if pl.is_partial() else pl
                            for pl, lq in zip(q.placements, lay.query)))
    else:
        out = _cross_attend(q, ek, ev, cfg.hd, x.dtype)
    out = project("bshk,hkd->bsd", out, prm["wo"], keep_weights=True)
    out = torch.tanh(prm["gate"].float()).to(x.dtype) * out
    return constrain(out, ("batch", "seq", "embed_act")), cache


def _cross_attend(q, ek, ev, hd: int, dtype, lay=None):
    """q (B,S,H,hd) over the encoder's K and V (B,N,K,hd), unmasked, the
    output in the promoted dtype. With a `_CacheLayout` these are a rank's
    local shards: head-dim shards' scores summed over their ranks (in
    float32), the softmax over token shards split, the context's float32
    partial sums all-reduced."""
    B, S = q.shape[:2]
    K, hdl = ek.shape[2], ek.shape[3]
    qg = q.reshape(B, S, K, -1, hdl)
    scores = promoted_einsum("bskgh,bnkh->bkgsn", qg, ek)
    if lay is not None and lay.contracted:
        scores = lay.reduce(scores.float(), lay.contracted).to(scores.dtype)
    sqrt_hd = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                      device=q.device)).to(scores.dtype)
    scores = scores.float() / sqrt_hd.float()
    if lay is None:
        w = torch.softmax(scores, dim=-1).to(dtype)
    else:
        w = lay.softmax(scores, dtype)
    if lay is not None and lay.seq:
        dt = torch.promote_types(w.dtype, ev.dtype)
        out = lay.reduce(torch.einsum("bkgsn,bnkh->bskgh", w.float(),
                                      ev.float()), lay.seq).to(dt)
    else:
        out = promoted_einsum("bkgsn,bnkh->bskgh", w, ev)
    return out.reshape(B, S, -1, hdl)


def _shared_attn_decode(lora, shared, x, cache, cfg: ModelConfig, pos):
    base, cache = attn.gqa_decode(shared, x, cache, cfg, pos)
    return base + _lora_delta(lora, rms_norm(x, shared["norm"]),
                              keep_weights=True), cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


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
    LM head from key 1, the prologue from key 2's split, the shared
    attention from key 3 and its FFN from key 6, and stacked slot i's
    repetition j from `fold_in(key 4, i * 1000 + j)`."""
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
    if "shared_attn" in cfg.superblock:
        pairs["shared_attn"] = attn.gqa_init(keys[3], cfg)
        if cfg.d_ff > 0:
            pairs["shared_mlp"] = mlp_mod.mlp_init(keys[6], cfg)
    params, axes = split_axes(pairs)

    stack_params: dict[str, Any] = {}
    stack_axes: dict[str, Any] = {}
    for i, kind in enumerate(cfg.superblock):
        layers, slot_axes = [], None
        for j in range(cfg.n_super):
            arrays, slot_axes = layer_init(keys[4], cfg, i, j)
            layers.append(arrays)
        stack_params[f"slot{i}"] = _stacked(layers)
        del layers
        stack_axes[f"slot{i}"] = _map_leaves(lambda a: ("layers",) + a,
                                             slot_axes)
    params["stack"] = stack_params
    axes["stack"] = stack_axes
    return _sorted(params), _sorted(axes)


def layer_init(stack_key: prng.Key, cfg: ModelConfig, slot: int, j: int
               ) -> tuple[PyTree, PyTree]:
    """(params, logical axes) of stacked slot `slot`'s repetition `j`,
    from its own key `fold_in(stack_key, slot * 1000 + j)` (`stack_key`:
    key 4 of `init`'s split): one layer of the stack, drawn alone."""
    return split_axes(_block_init(cfg.superblock[slot], prng.fold_in(
        stack_key, slot * 1000 + j), cfg))


def _sorted(tree: PyTree) -> PyTree:
    """Every dict's keys in sorted order, jax's leaf order: a tree's leaves
    then come in the reference's order wherever it is flattened (the
    optimizer state built from it, the checkpoint's leaf numbers)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _embed(params, tokens, cfg: ModelConfig, fsdp: bool = True):
    """The tokens' embeddings. With `fsdp` the table is gathered over
    'data' first (a sharded replica's forward); else (decode) it is looked
    up where it lies (`F.embedding`: a vocabulary shard gives a masked
    partial sum) by the tokens gathered whole."""
    if fsdp:
        table = gather_axis(params["embed"])
        x = (_lookup_local(table, tokens.long()) if is_dtensor(table)
             else table[tokens.long()])
    else:  # the tokens (a few integers) whole on every rank
        x = torch.nn.functional.embedding(
            gather_axis(gather_axis(tokens.long()), "model"),
            params["embed"])
        x = _reduced(x)
    return constrain(x.to(cfg.dtype), ("batch", "seq", "embed_act"))


def _lookup_local(table, ids):
    """`table[ids]` of DTensors on each rank's own ids (`local_map`), so
    neither the ids nor the rows' gradients are gathered: a vocabulary
    shard looks up the ids it holds (the others masked to zeros, a partial
    sum), and its gradient is the scatter-add of this rank's rows alone, a
    partial sum over the mesh dims that shard the ids (reduced where the
    table's placements ask). A mesh dim that shards both the table and the
    ids gathers the table there first. On a one-rank mesh it is the plain
    lookup."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    ip = tuple(ids.placements)
    tp = tuple(Replicate() if t.is_shard() and i.is_shard() else t
               for t, i in zip(table.placements, ip))
    if tp != tuple(table.placements):
        # only then: a redistribute's backward takes the gradient to the
        # input's placements, so a partial sum over 'data' to Replicate
        table = table.redistribute(mesh, tp)
    out, grad = [], []
    for t, i in zip(tp, ip):
        out.append(Partial() if t.is_shard(0) else
                   Shard(ids.ndim) if t.is_shard(1) else i)
        grad.append(Partial() if i.is_shard() else t)
    (lo, n), _ = local_block(table.shape, tp, mesh.shape,
                             mesh.get_coordinate())
    split = n < table.shape[0]

    def lookup(t, i):
        if not split:
            return t[i]
        held = (i >= lo) & (i < lo + n)
        rows = t[torch.where(held, i - lo, 0)]
        return rows * held[..., None].to(rows.dtype)
    return local_map(lookup, out_placements=(tuple(out),),
                     in_placements=(tp, ip), in_grad_placements=(
                         tuple(grad), ip), device_mesh=mesh)(table, ids)


def _reduced(x):
    """A DTensor's partial sums (a vocabulary shard's masked lookup)
    all-reduced before any other redistribution (a row slice taken first
    would meet the mask of the whole rows); anything else as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def _unembed(params, x, cfg: ModelConfig, fsdp: bool = True):
    """The logits: the head gathered whole over the batch's ranks by
    `project` (with `fsdp`), or met where it lies by a decode step's
    tokens (the final norm then left where it lies too)."""
    x = constrain(x, ("batch", "seq", "embed_act"))  # one sequence gather
    norm = gather_axis(params["final_norm"]) if fsdp else params["final_norm"]
    x = rms_norm(x, norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = project("bsd,dv->bsv", x, head, keep_weights=not fsdp)
    return constrain(logits, ("batch", "seq", "vocab"))


def _vectors_gathered(tree: PyTree) -> PyTree:
    """A layer's FSDP gather over 'data': its vectors (the norms' scales)
    gathered here; its matrices are gathered by the products that take
    them (`project`, and the MoE's own), each in one redistribute with
    the other mesh dims it needs, so that each gradient comes back in
    one reduce-scatter."""
    return _map_leaves(lambda t: gather_axis(t) if is_dtensor(t)
                       and t.ndim == 1 else t, tree)


def _layer(tree: PyTree, j: int) -> PyTree:
    """Repetition j of a stacked slot: a view of each (L, ...) leaf, or
    element j of a per-layer sequence."""
    return _map_leaves(lambda leaf: leaf[j], tree)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            enc: torch.Tensor | None = None, moe_groups: int = 1
            ) -> torch.Tensor:
    """Training/prefill forward -> logits (B,S,V) in `cfg.dtype`. `enc`:
    (B,N,E) stubbed encoder states for the VLM's cross-attention
    (precomputed patch embeddings)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    x = _embed(params, tokens, cfg)
    shared = {"attn": params.get("shared_attn"),
              "mlp": params.get("shared_mlp")}

    def block(x, kind, prm):
        # FSDP: a layer's parameters gathered over 'data' where it runs
        # (again in the backward's recomputation)
        return _block_apply(kind, _vectors_gathered(prm), x, cfg, positions,
                            _vectors_gathered(shared), enc, moe_groups)

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


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> PyTree:
    """The decode cache tree, zeros on `device` (None: the CUDA card): the
    prologue's blocks' caches as a list, and each stacked slot's with a
    leading axis of `cfg.n_super` repetitions (one allocation, written in
    place by `decode_step`). Recurrent states are float32 whatever
    `dtype`."""
    device = resolve_device_or_meta(device)
    cache: dict[str, Any] = {}
    if cfg.prologue:
        cache["prologue"] = [
            _block_init_cache(kind, cfg, batch, max_seq, dtype, device)
            for kind in cfg.prologue]

    def one_slot(kind):
        # the n_super repetitions' caches as the cache of n_super * batch
        # rows (each leaf's leading axis is the batch), viewed as
        # (n_super, batch, ...)
        c = _block_init_cache(kind, cfg, cfg.n_super * batch, max_seq,
                              dtype, device)
        return {k: v.view((cfg.n_super, batch) + tuple(v.shape[1:]))
                for k, v in c.items()}

    cache["stack"] = {f"slot{i}": one_slot(kind)
                      for i, kind in enumerate(cfg.superblock)}
    return cache


def cache_axes(cfg: ModelConfig) -> PyTree:
    """Logical axes of the cache tree (the reference's sharding names)."""
    def axes_for(kind, stacked: bool):
        lead = ("layers",) if stacked else ()
        if kind in ("attn", "attn_moe", "shared_attn"):
            a = ("batch", "cache_seq", "kv_heads", "head")
            return {"k": lead + a, "v": lead + a}
        if kind in ("mla", "mla_moe"):
            return {"ckv": lead + ("batch", "cache_seq", "kv_lora"),
                    "krope": lead + ("batch", "cache_seq", "head")}
        if kind == "cross_attn":
            a = ("batch", "enc_tokens", "kv_heads", "head")
            return {"ek": lead + a, "ev": lead + a}
        if kind == "mamba1":
            return {"conv": lead + ("batch", "conv", "ssm_inner"),
                    "h": lead + ("batch", "ssm_inner", "state")}
        if kind == "mamba2":
            return {"conv": lead + ("batch", "conv", "ssm_inner"),
                    "h": lead + ("batch", "ssm_heads", "head", "state")}
        raise ValueError(kind)

    axes: dict[str, Any] = {}
    if cfg.prologue:
        axes["prologue"] = [axes_for(k, False) for k in cfg.prologue]
    axes["stack"] = {f"slot{i}": axes_for(kind, True)
                     for i, kind in enumerate(cfg.superblock)}
    return axes


def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig,
                moe_groups: int = 1) -> tuple[torch.Tensor, PyTree]:
    """One-token decode. tokens: (B,1) integers; pos: the current write
    position, an int or a 0-d integer tensor, shared by the batch. Writes
    every block's new state into `cache` in place and returns (logits
    (B,1,V), cache): the same tensors. On a sharded replica (DTensors)
    every parameter stays where it lies (the products' partial sums
    reduced, `project(keep_weights=True)`), and each cache is written
    where it lies."""
    x = _embed(params, tokens, cfg, fsdp=False)
    shared = {"attn": params.get("shared_attn"),
              "mlp": params.get("shared_mlp")}
    for i, kind in enumerate(cfg.prologue):
        x = _block_decode(kind, params["prologue"][i], x,
                          cache["prologue"][i], cfg, pos, shared, moe_groups)
    for j in range(cfg.n_super):
        slots, caches = _layer(params["stack"], j), _layer(cache["stack"], j)
        for i, kind in enumerate(cfg.superblock):
            x = _block_decode(kind, slots[f"slot{i}"], x,
                              caches[f"slot{i}"], cfg, pos, shared,
                              moe_groups)
    return _unembed(params, x, cfg, fsdp=False), cache


def loss_fn(params, batch, cfg: ModelConfig, moe_groups: int = 1
            ) -> torch.Tensor:
    logits = forward(params, batch["tokens"], cfg, enc=batch.get("enc"),
                     moe_groups=moe_groups)
    return cross_entropy_loss(logits, batch["labels"])
