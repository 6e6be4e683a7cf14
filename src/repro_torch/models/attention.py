"""Attention, the port of `repro.models.attention`: GQA (`gqa_init`, `_qkv`,
`gqa_apply`), MLA, DeepSeek-V2's multi-head latent attention (`mla_init`,
`_mla_q`, `_mla_kv_latent`, `mla_apply`), the grouped causal attention
both run (`_sdpa_causal`, with `_sdpa_causal_streamed`'s online softmax
over KV chunks for long sequences), the VLM's cross-attention to encoder
states (`cross_attn_init`, `cross_attn_apply`, streamed over
`_ENC_CHUNK`-token encoder chunks; each chunk of either stream a
checkpointed function, `_chunked`, as the reference's `jax.checkpoint`
of its scan bodies: its float32 scores are recomputed for the backward,
not kept), and the one-token decode of GQA and
MLA with their caches (`gqa_init_cache`, `gqa_decode`, `mla_init_cache`,
the absorbed `mla_decode`).

All shapes follow (batch, seq, heads, head_dim). GQA repeats are expressed
by grouping q heads as (kv_heads, group), so the einsums contract natively
without materializing repeated K/V. These are plain torch matmuls and
softmax, the counterpart of the reference's XLA path (it reaches no Pallas
kernel); `scaled_dot_product_attention` is not used, since its rounding is
not the reference's: the scores are rounded to the activations' dtype by
their einsum and then taken to float32, the softmax weights cast back
before P·V, as the reference casts.

On a sharded pod (DTensor parameters and activations) GQA, MLA and the
cross-attention take the reference's sharding constraints
(`runtime.sharding.constrain`: q, k and v sequence-parallel, then k and v
over their heads; the encoder over its tokens), every projection runs on
each rank's local shards (`runtime.sharding.project`: its own tokens by
the weights gathered whole, a decode step's token by the weights' shards
where they lie), and the causal attention and the cross-attention's
softmax run on each rank's own shards under `local_map`
(`_on_local_heads`): its batch rows and, where the kv heads divide the
model axis, its kv heads with their q heads; where they do not, k and v
are gathered whole over the axis and q's rows stay sequence-parallel
(the reference's), each rank attending its own rows over all keys, the
causal mask at their global positions. On one device none of this
changes a bit.

Decode writes the new token's keys (or latent) into the cache at `pos` in
place, the counterpart of the reference's donated cache, and returns the
same tensors. A DTensor cache (sharded inference, placed by
`launch.specs.serve_placements`) is written in each rank's own shard at
the offset where it lies (`_write_local`) and attended as it lies, never
gathered (`_CacheLayout`): over kv-head shards each rank attends its own
heads; over head-dim shards the float32 scores are all-reduced once
before the softmax; over sequence shards (MLA's latent, the
cross-attention's encoder tokens) the softmax is split across the ranks. Its scores are contracted in float32 from the operands as
they are (`_bmm_f32`, the reference's `preferred_element_type=float32`:
no rounding of the scores to the activations' dtype, unlike the
forward), over the cache as it lies (`_gqa_scores`, `_gqa_context`: one
batched matmul each, no copy of the cache). Mixed dtypes (a float32
cache under bf16 weights) promote as jax promotes them
(`common.promoted_einsum`).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device_or_meta
from repro_torch.compress import prng
from repro_torch.models.common import (ModelConfig, all_reduce,
                                       apply_rope, p, promoted_einsum, pz,
                                       rms_norm, shard_offset)
from repro_torch.runtime.sharding import constrain, is_dtensor, project

PyTree = Any

#: the reference's KV chunk: its launcher runs the model under sharding
#: rules, where a KV length above one chunk, and a multiple of it, takes
#: the streamed (online-softmax) form
_KV_CHUNK = 1024


def gqa_init(key: prng.Key, cfg: ModelConfig) -> PyTree:
    ks = prng.split(key, 5)
    H, K, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    dev = key[0].device
    prm = {
        "wq": p(ks[0], (D, H, hd), ("embed", "q_heads", "head"), cfg.dtype),
        "wk": p(ks[1], (D, K, hd), ("embed", "kv_heads", "head"), cfg.dtype),
        "wv": p(ks[2], (D, K, hd), ("embed", "kv_heads", "head"), cfg.dtype),
        "wo": p(ks[3], (H, hd, D), ("q_heads", "head", "embed"), cfg.dtype),
        "norm": pz((D,), ("embed",), torch.float32, device=dev),
    }
    if cfg.qkv_bias:
        prm["bq"] = pz((H, hd), ("q_heads", "head"), cfg.dtype, device=dev)
        prm["bk"] = pz((K, hd), ("kv_heads", "head"), cfg.dtype, device=dev)
        prm["bv"] = pz((K, hd), ("kv_heads", "head"), cfg.dtype, device=dev)
    return prm


def _qkv(prm, x, cfg: ModelConfig, positions, keep_weights: bool = False):
    # sharded, on each rank's local shards (`project`): each rank projects
    # its own tokens by the weights gathered whole (q, k and v come out
    # sequence-parallel); a decode step's token (keep_weights) meets the
    # weights' shards where they lie, the head dims' (heads, head dim)
    # flattened on local tensors either way
    q, k, v = project("bsd,dhk->bshk", x, prm["wq"], prm["wk"], prm["wv"],
                      keep_weights=keep_weights)
    if cfg.qkv_bias:
        q, k, v = q + prm["bq"], k + prm["bk"], v + prm["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # q stays sequence-parallel; k and v are computed sequence-sharded and
    # then gathered over the sequence (the reference's two constraints;
    # the redistributes run in the order written, so its barrier between
    # them has no counterpart)
    q = constrain(q, ("batch", "seq_sp", "q_heads", "head"))
    k = constrain(k, ("batch", "seq_sp", "kv_heads", "head"))
    v = constrain(v, ("batch", "seq_sp", "kv_heads", "head"))
    k = constrain(k, ("batch", None, "kv_heads", "head"))
    v = constrain(v, ("batch", None, "kv_heads", "head"))
    return q, k, v


def _sqrt_hd(hd: int, device) -> torch.Tensor:
    """The float32 `jnp.sqrt(hd)` the scores are divided by."""
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                   device=device))


def _causal_chunk(qg, k_c, v_c, m, l, acc, c0: int, rows, scale):
    """One KV chunk of `_sdpa_causal_streamed`'s online softmax: the
    chunk's float32 scores masked by the global rows, the running max `m`,
    denominator `l` and float32 accumulator `acc` carried on. Its scores
    and weights live only while it runs (checkpointed: the backward
    recomputes them)."""
    chunk = k_c.shape[1]
    s = torch.einsum("bskgh,btkh->bskgt", qg, k_c).float() * scale
    cols = c0 + torch.arange(chunk, device=qg.device)
    mask = rows[:, None] >= cols[None, :]                     # (S, chunk)
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.tensor(-1e30, dtype=torch.float32,
                                 device=qg.device))
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    pr = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = corr * l + torch.sum(pr, dim=-1, keepdim=True)
    pv = torch.einsum("bskgt,btkh->bskgh", pr.to(qg.dtype), v_c)
    return m_new, l, acc * corr + pv


def _chunked(body, *args):
    """`body(*args)` checkpointed, as the reference's `jax.checkpoint` of
    each chunk of its scans (whatever `cfg.remat` says): the backward
    recomputes the chunk from its inputs, to the same values."""
    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _global_rows(S: int, T: int, first_row, device) -> torch.Tensor:
    """The global index of each of q's S rows among the T keys: row r of
    the whole sequence sees the keys up to r + T - S; `first_row` (a
    rank's rows of a sequence shard: their first's global index plus
    T - S) in place of T - S."""
    return torch.arange(S, device=device) + (T - S if first_row is None
                                             else first_row)


def _sdpa_causal_streamed(q, k, v, first_row=None):
    """Causal attention with the online-softmax (flash) recurrence over KV
    chunks, each checkpointed (`_causal_chunk`). q: (B,S,H,hd); k, v:
    (B,T,K,hd) with T a multiple of the chunk; masks use global row
    indices (row r sees columns up to r + T - S; `_global_rows`)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    v_hd = v.shape[-1]
    qg = q.reshape(B, S, K, G, hd)
    scale = 1.0 / _sqrt_hd(hd, q.device)
    rows = _global_rows(S, T, first_row, q.device)
    m = torch.full((B, S, K, G, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, K, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, v_hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, T, _KV_CHUNK):
        m, l, acc = _chunked(_causal_chunk, qg, k[:, c0:c0 + _KV_CHUNK],
                             v[:, c0:c0 + _KV_CHUNK], m, l, acc, c0, rows,
                             scale)
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(B, S, H, v_hd)


def _sdpa_causal_whole(q, k, v, first_row=None):
    """Grouped causal attention over the whole (S x T) score matrix with
    its softmax (the reference's q-chunked form computes this, row block
    by row block). q: (B,S,H,hd); k, v: (B,T,K,hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / _sqrt_hd(hd, q.device)
    rows = _global_rows(S, T, first_row, q.device)
    mask = rows[:, None] >= torch.arange(T, device=q.device)[None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(
        B, S, H, v.shape[-1])


def _sdpa_causal(q, k, v, first_row=None):
    """Grouped causal attention. q: (B,S,H,hd); k, v: (B,T,K,hd);
    `first_row` (`_global_rows`) where q holds a rank's rows of a
    sequence shard.

    The reference's launcher takes the streamed form where T is above one
    KV chunk and a multiple of it, else the whole score matrix. Its
    q-chunked form (a checkpointed scan over 256-row blocks, taken only
    without sharding rules) has no counterpart: the port takes the
    streamed form wherever the launcher does, and the whole matrix
    elsewhere, which computes the q-chunked form's values. DTensors (a
    sharded replica) run it on local shards (`_on_local_heads`)."""
    if is_dtensor(q):
        return _on_local_heads(_sdpa_causal, q, k, v, causal=True)
    T = k.shape[1]
    if T > _KV_CHUNK and T % _KV_CHUNK == 0:
        return _sdpa_causal_streamed(q, k, v, first_row)
    return _sdpa_causal_whole(q, k, v, first_row)


def _on_local_heads(core, q, k, v, *args, causal: bool = False):
    """`core(q, k, v, *args)` of DTensors on each rank's own shards: every
    rank attends its batch rows, its kv heads (with their q heads) and
    its query rows over all keys. k and v keep the batch and kv-head
    placements their constraints gave them; a head-dim or sequence shard
    of theirs, where the kv heads do not divide the mesh dim, is gathered
    (k and v are small, (B, T, K, hd)). q is taken to k's batch and head
    shards; on a mesh dim (of more than one rank) where k lies whole and
    q is sequence-parallel, q stays so (the reference's "q rows stay
    sequence-parallel"): each rank runs its S/m rows over all keys, and
    k's and v's gradients there are partial sums over the ranks' rows.
    With `causal` the core's last argument is the global index of the
    rank's first row plus T - S (`_global_rows`), read here: the core
    reads no mesh. The output keeps q's placements (heads or rows over
    'model'), for the output projection."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    kv = tuple(pl if pl.is_shard() and pl.dim in (0, 2) else Replicate()
               for pl in k.placements)
    rows = tuple(kp.is_replicate() and qp.is_shard(1) and mesh.size(d) > 1
                 for d, (kp, qp) in enumerate(zip(kv, q.placements)))
    qp = tuple(q.placements[d] if r else kp
               for d, (kp, r) in enumerate(zip(kv, rows)))
    kv_grad = tuple(Partial() if r else kp for kp, r in zip(kv, rows))
    q = q.redistribute(mesh, qp)
    k, v = (t.redistribute(mesh, kv) for t in (k, v))
    if causal:
        args = args + (shard_offset(q, 1) + k.shape[1] - q.shape[1],)
    return local_map(core, out_placements=(qp,),
                     in_placements=(qp, kv, kv) + (None,) * len(args),
                     in_grad_placements=(qp, kv_grad, kv_grad)
                     + (None,) * len(args),
                     device_mesh=mesh)(q, k, v, *args)


def gqa_apply(prm, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Prefill/training forward (causal)."""
    h = rms_norm(x, prm["norm"])
    q, k, v = _qkv(prm, h, cfg, positions)
    out = _sdpa_causal(q, k, v)
    out = project("bshk,hkd->bsd", out, prm["wo"])
    return constrain(out, ("batch", "seq_sp", "embed_act"))


def _decode_positions(x: torch.Tensor, pos) -> torch.Tensor:
    """(B, 1) positions of the token decoded at `pos` (an int or a 0-d
    integer tensor), as the forward's positions feed `apply_rope`."""
    return torch.as_tensor(pos, device=x.device).reshape(1, 1).expand(
        x.shape[0], 1)


def _write_at(buf: torch.Tensor, pos, value: torch.Tensor) -> torch.Tensor:
    """Write `value` (B, 1, ...) into `buf` (B, T, ...) at sequence index
    `pos`, in place, cast to the buffer's dtype (the reference's
    `dynamic_update_slice` of its donated cache). A DTensor buffer is
    written in each rank's own shard (`_write_local`). Returns `buf`."""
    if is_dtensor(buf):
        _write_local(buf, pos, value)
    elif isinstance(pos, int):
        buf.narrow(1, pos, 1).copy_(value)
    else:
        buf.index_copy_(1, pos.reshape(1).to(torch.long),
                        value.to(buf.dtype))
    return buf


def _write_local(buf, pos, value) -> None:
    """`_write_at` of a DTensor cache: the value taken to the cache's
    layout, whole along the sequence (its rows and heads, or head-dim
    slices, are the rank's own: no communication where the constraints
    gave it that layout), and written into the rank's local shard. Over a
    sequence-sharded cache only the rank whose shard holds `pos` writes,
    at `pos` less its first position; with `pos` a tensor the choice
    stays on the device: every rank writes at its clamped index, the old
    value where `pos` lies outside its shard."""
    from torch.distributed.tensor import Replicate

    mesh = buf.device_mesh
    whole_seq = tuple(Replicate() if pl.is_shard(1) else pl
                      for pl in buf.placements)
    v = value.redistribute(mesh, whole_seq).to_local().to(buf.dtype)
    local = buf.to_local()
    T = local.shape[1]
    idx = pos - shard_offset(buf, 1)
    if isinstance(idx, int):
        if 0 <= idx < T:
            local.narrow(1, idx, 1).copy_(v)
        return
    i = idx.clamp(0, T - 1).reshape(1).to(torch.long)
    inside = (idx >= 0) & (idx < T)
    local.index_copy_(1, i, torch.where(inside, v, local.index_select(1, i)))


class _CacheLayout:
    """How a DTensor cache (B, T, ...) lies over its mesh, for a decode's
    attention over it as it lies: the mesh dims (of more than one rank)
    that shard its sequence (dim 1) and those that shard `contracted`, a
    dimension the scores sum over (their float32 partial sums, summed
    over those ranks once); this rank's first position; and the
    placements the queries take to meet it (the cache's rows, heads or
    head-dim slices, whole along the sequence). The softmax over a
    sequence-sharded cache is split: each rank's max and sum of
    exponentials, all-reduced, and the context's float32 partial sums
    all-reduced after."""

    def __init__(self, cache, contracted: int | None = None):
        from torch.distributed.tensor import Replicate

        self.mesh = mesh = cache.device_mesh
        live = [d for d in range(mesh.ndim) if mesh.size(d) > 1]
        pls = cache.placements
        self.seq = [d for d in live if pls[d].is_shard(1)]
        self.contracted = ([] if contracted is None else
                           [d for d in live if pls[d].is_shard(contracted)])
        self.offset = shard_offset(cache, 1)
        self.query = tuple(Replicate() if pl.is_shard(1) else pl
                           for pl in pls)

    def reduce(self, t: torch.Tensor, dims, op: str = "sum") -> torch.Tensor:
        """`t` all-reduced over the mesh dims `dims` (`all_reduce`)."""
        return all_reduce(t, self.mesh, dims, op)

    def softmax(self, scores: torch.Tensor, dtype) -> torch.Tensor:
        """The softmax over the last dim, the positions, in `dtype`."""
        if not self.seq:
            return torch.softmax(scores, dim=-1).to(dtype)
        m = self.reduce(torch.amax(scores, dim=-1, keepdim=True), self.seq,
                        "max")
        e = torch.exp(scores - m)
        total = self.reduce(torch.sum(e, dim=-1, keepdim=True), self.seq)
        return (e / total).to(dtype)

    def wrap(self, local: torch.Tensor, shape, placements):
        """A local result as a DTensor of global `shape`."""
        from torch.distributed.tensor import DTensor

        shape = tuple(shape)
        return DTensor.from_local(local.contiguous(), self.mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` (batched) in float32 from the operands as they are, the
    reference's `preferred_element_type=float32` contraction: on the card,
    bf16 operands go to cuBLAS with float32 output (bf16 products are exact
    in float32, summed there), so a bf16 cache is read once and never
    copied to float32; elsewhere the operands are taken to float32. Meta
    tensors take the card's form, so that a step reckoned on them (the
    dry-run's temporaries) makes no float32 copy of a cache that the card
    never makes."""
    if (a.is_cuda or a.is_meta) and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _block_diagonal(qg: torch.Tensor) -> torch.Tensor:
    """(B, K, G, hd) queries as (B, K*G, K*hd) rows that are zero outside
    their own kv head's hd columns, so that one batched matmul with a
    (B, T, K, hd) cache seen as (B, T, K*hd) contracts each query with its
    own head's keys alone: the cache is read as it lies, neither permuted
    nor copied per head (K times the flops of a decode's few queries,
    nothing beside the cache's bytes)."""
    B, K, G, hd = qg.shape
    rows = qg.new_zeros((B, K, G, K, hd))
    rows.diagonal(dim1=1, dim2=3).copy_(qg.permute(0, 2, 3, 1))
    return rows.reshape(B, K * G, K * hd)


def _gqa_scores(qg: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
    """scores[b,k,g,t] = q[b,k,g] . k[b,t,k] in float32 (`_bmm_f32`)."""
    B, T, K, hd = ck.shape
    G = qg.shape[2]
    return _bmm_f32(_block_diagonal(qg),
                    ck.reshape(B, T, K * hd).transpose(1, 2)).view(
        B, K, G, T)


def _gqa_context(w: torch.Tensor, cv: torch.Tensor,
                 f32: bool = False) -> torch.Tensor:
    """out[b,k,g] = sum_t w[b,k,g,t] v[b,t,k] in the promoted dtype (in
    float32 with `f32`, `_bmm_f32`: a sequence shard's partial sum): one
    batched matmul of the (B, K*G, T) weights with the (B, T, K*hd) cache
    as it lies, then each query's own head's block of the (K*G, K*hd)
    product (the other blocks, the products with other heads' values, are
    dropped)."""
    B, T, K, hd = cv.shape
    G = w.shape[2]
    w, cv = w.reshape(B, K * G, T), cv.reshape(B, T, K * hd)
    if f32:
        full = _bmm_f32(w, cv)
    else:
        dt = torch.promote_types(w.dtype, cv.dtype)
        full = torch.bmm(w.to(dt), cv.to(dt))
    return full.view(B, K, G, K, hd).diagonal(dim1=1, dim2=3).permute(
        0, 3, 1, 2)                                      # (B,K,G,hd)


def _valid(T: int, pos, device, offset: int = 0) -> torch.Tensor:
    """The cache positions written so far among `offset` .. `offset` + T,
    `arange(offset, offset + T) <= pos`."""
    return torch.arange(offset, offset + T, device=device) <= torch.as_tensor(
        pos, device=device)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device=None) -> PyTree:
    """Zero K and V caches of (batch, max_seq, kv_heads, head_dim) on
    `device` (None: the CUDA card)."""
    device = resolve_device_or_meta(device)
    K, hd = cfg.num_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, max_seq, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, K, hd), dtype=dtype, device=device),
    }


def gqa_decode(prm, x, cache, cfg: ModelConfig, pos
               ) -> tuple[torch.Tensor, PyTree]:
    """One-token decode. x: (B,1,D); pos: the current position, shared by
    the batch. Writes the token's k and v into the cache at `pos` (in
    place) and attends over positions 0..pos of it. Returns (out, cache).
    A DTensor cache is attended as it lies (`_gqa_attend_sharded`)."""
    h = rms_norm(x, prm["norm"])
    q, k, v = _qkv(prm, h, cfg, _decode_positions(x, pos),
                   keep_weights=True)
    ck = _write_at(cache["k"], pos, k)
    cv = _write_at(cache["v"], pos, v)
    ck = constrain(ck, ("batch", "cache_seq", "kv_heads", "head"))
    cv = constrain(cv, ("batch", "cache_seq", "kv_heads", "head"))
    if is_dtensor(ck):
        out = _gqa_attend_sharded(q, ck, cv, pos)
    else:
        out = _gqa_attend(q, ck, cv, pos)
    out = project("bshk,hkd->bsd", out, prm["wo"], keep_weights=True)
    return constrain(out, ("batch", "seq", "embed_act")), cache


def _gqa_attend(q, ck, cv, pos) -> torch.Tensor:
    """q (B,1,H,hd) over the cache (B,T,K,hd) at positions 0..pos."""
    B, _, H, hd = q.shape
    T, K = ck.shape[1], ck.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    scores = _gqa_scores(qg, ck) / _sqrt_hd(hd, q.device)
    scores = scores.masked_fill(~_valid(T, pos, q.device), -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_context(w, cv).reshape(B, 1, H, hd)


def _gqa_attend_sharded(q, ck, cv, pos) -> torch.Tensor:
    """`_gqa_attend` over DTensor caches as they lie, on each rank's local
    shards (`_CacheLayout`), the cache never gathered: the queries are
    taken to the cache's rows and kv heads (each rank's q heads with
    them: the block-diagonal queries of its own heads) or head-dim slices;
    over head-dim shards the float32 scores are partial sums, all-reduced
    once before the softmax, and the context stays head-dim-sharded; over
    sequence shards the softmax is split. Returns the output in the
    queries' layout."""
    lay = _CacheLayout(ck, contracted=3)
    ql = q.redistribute(lay.mesh, lay.query).to_local()
    ckl, cvl = ck.to_local(), cv.to_local()
    B, Tl, Kl, hdl = ckl.shape
    hd = q.shape[-1]
    qg = ql.reshape(B, Kl, -1, hdl)
    scores = lay.reduce(_gqa_scores(qg, ckl), lay.contracted)
    scores = scores / _sqrt_hd(hd, ql.device)
    scores = scores.masked_fill(~_valid(Tl, pos, ql.device, lay.offset),
                                -1e30)
    w = lay.softmax(scores, q.dtype)
    if lay.seq:
        dt = torch.promote_types(w.dtype, cvl.dtype)
        out = lay.reduce(_gqa_context(w, cvl, f32=True), lay.seq).to(dt)
    else:
        out = _gqa_context(w, cvl)
    out = lay.wrap(out.reshape(B, 1, -1, hdl), q.shape, lay.query)
    return out.redistribute(lay.mesh, q.placements)


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(key: prng.Key, cfg: ModelConfig) -> PyTree:
    ks = prng.split(key, 8)
    D, H = cfg.d_model, cfg.num_heads
    qk_nope, rope_hd = cfg.hd, cfg.mla_rope_head_dim
    v_hd = cfg.mla_v_head_dim or cfg.hd
    kvl, ql = cfg.mla_kv_lora, cfg.mla_q_lora
    dev = key[0].device
    return {
        "wq_a": p(ks[0], (D, ql), ("embed", "q_lora"), cfg.dtype),
        "q_norm": pz((ql,), ("q_lora",), torch.float32, device=dev),
        "wq_b": p(ks[1], (ql, H, qk_nope + rope_hd),
                  ("q_lora", "q_heads", "head"), cfg.dtype),
        "wkv_a": p(ks[2], (D, kvl + rope_hd), ("embed", "kv_lora"),
                   cfg.dtype),
        "kv_norm": pz((kvl,), ("kv_lora",), torch.float32, device=dev),
        "wk_b": p(ks[3], (kvl, H, qk_nope), ("kv_lora", "q_heads", "head"),
                  cfg.dtype),
        "wv_b": p(ks[4], (kvl, H, v_hd), ("kv_lora", "q_heads", "head"),
                  cfg.dtype),
        "wo": p(ks[5], (H, v_hd, D), ("q_heads", "head", "embed"),
                cfg.dtype),
        "norm": pz((D,), ("embed",), torch.float32, device=dev),
    }


def _mla_q(prm, h, cfg: ModelConfig, positions, keep_weights: bool = False):
    qk_nope = cfg.hd
    ql = project("bsd,dq->bsq", h, prm["wq_a"], keep_weights=keep_weights)
    ql = rms_norm(ql, prm["q_norm"])
    q = project("bsq,qhk->bshk", ql, prm["wq_b"], keep_weights=keep_weights)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(prm, h, cfg: ModelConfig, positions,
                   keep_weights: bool = False):
    kvl = cfg.mla_kv_lora
    kv = project("bsd,dq->bsq", h, prm["wkv_a"], keep_weights=keep_weights)
    c_kv, k_rope = kv[..., :kvl], kv[..., kvl:]
    c_kv = rms_norm(c_kv, prm["kv_norm"])
    # rope over a head axis of one, inserted and taken out again
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_qkv(prm, h, cfg: ModelConfig, positions):
    """q, k and v of the causal attention from the normed input h: the
    latent expanded per head, the rope dims concatenated onto q and k (the
    shared rope key broadcast to every head)."""
    q_nope, q_rope = _mla_q(prm, h, cfg, positions)
    c_kv, k_rope = _mla_kv_latent(prm, h, cfg, positions)
    k_nope, v = project("bsq,qhk->bshk", c_kv, prm["wk_b"], prm["wv_b"])
    B, S, H, _ = q_nope.shape
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, cfg.mla_rope_head_dim)], dim=-1)
    return q_full, k_full, v


def mla_apply(prm, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Prefill/training forward: the latent expanded per head, then the
    causal attention with the rope dims concatenated onto q and k (the
    shared rope key broadcast to every head), so the softmax scale is
    1/sqrt(nope + rope), as DeepSeek-V2's. v has its own head dim.

    Sharded (DTensors), q, k and v are projected on each rank's own tokens
    (`project`), k and v then gathered over the sequence with their heads
    over 'model' (the reference's constraints), and the attention runs on
    local shards (`_on_local_heads`)."""
    h = rms_norm(x, prm["norm"])
    q_full, k_full, v = _mla_qkv(prm, h, cfg, positions)
    q_full = constrain(q_full, ("batch", "seq_sp", "q_heads", "head"))
    k_full = constrain(k_full, ("batch", "seq_sp", "q_heads", "head"))
    v = constrain(v, ("batch", "seq_sp", "q_heads", "head"))
    k_full = constrain(k_full, ("batch", None, "q_heads", "head"))
    v = constrain(v, ("batch", None, "q_heads", "head"))
    out = _sdpa_causal(q_full, k_full, v)
    out = project("bshk,hkd->bsd", out, prm["wo"])
    return constrain(out, ("batch", "seq_sp", "embed_act"))


def mla_init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device=None) -> PyTree:
    """MLA caches only the compressed latent and the shared rope key:
    (kv_lora + rope_hd) values a token (576 for DeepSeek-V2), on `device`
    (None: the CUDA card)."""
    device = resolve_device_or_meta(device)
    return {
        "ckv": torch.zeros((batch, max_seq, cfg.mla_kv_lora), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_seq, cfg.mla_rope_head_dim),
                             dtype=dtype, device=device),
    }


def mla_decode(prm, x, cache, cfg: ModelConfig, pos
               ) -> tuple[torch.Tensor, PyTree]:
    """Absorbed decode: attention runs in the latent space. q_nope is taken
    through `wk_b` (q_abs), the scores are q_abs . c_kv plus q_rope .
    k_rope, and `wv_b` expands the latent context per head, so the
    per-head K and V are never materialized. The scale is
    1/sqrt(nope + rope) in float32, the mask -inf. DTensor caches are
    attended as they lie (`_mla_attend_sharded`)."""
    h = rms_norm(x, prm["norm"])
    positions = _decode_positions(x, pos)
    q_nope, q_rope = _mla_q(prm, h, cfg, positions, keep_weights=True)
    c_kv, k_rope = _mla_kv_latent(prm, h, cfg, positions, keep_weights=True)
    ckv = _write_at(cache["ckv"], pos, c_kv)
    krope = _write_at(cache["krope"], pos, k_rope)
    ckv = constrain(ckv, ("batch", "cache_seq", "kv_lora"))
    krope = constrain(krope, ("batch", "cache_seq", "head"))
    # absorb W_uk: (B,1,H,nope) x (kvl,H,nope) -> (B,H,kvl)
    q_abs = project("bshk,qhk->bhq", q_nope, prm["wk_b"], keep_weights=True)
    scale = 1.0 / _sqrt_hd(cfg.hd + cfg.mla_rope_head_dim, x.device)
    if is_dtensor(ckv):
        ctx = _mla_attend_sharded(q_abs, q_rope[:, 0], ckv, krope, pos,
                                  scale, x.dtype)
    else:
        scores = (_bmm_f32(q_abs, ckv.transpose(1, 2))
                  + _bmm_f32(q_rope[:, 0], krope.transpose(1, 2))) * scale
        scores = scores.masked_fill(~_valid(ckv.shape[1], pos, x.device),
                                    float("-inf"))
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = promoted_einsum("bht,btq->bhq", w, ckv)    # latent context
    out = project("bhq,qhk->bhk", ctx, prm["wv_b"],
                  keep_weights=True)                      # V per head
    out = project("bhk,hkd->bd", out, prm["wo"], keep_weights=True)[
        :, None, :]
    return constrain(out, ("batch", "seq", "embed_act")), cache


def _mla_attend_sharded(q_abs, q_rope, ckv, krope, pos, scale, dtype):
    """`mla_decode`'s latent context (B,H,kvl) over DTensor caches as they
    lie (`_CacheLayout` of `ckv`), neither gathered: q_abs meets each
    rank's rows and positions of the latent cache (under the rules its
    sequence is sharded over 'model': the latent has no rule), q_rope its
    rows and rope dims of `krope` (head-dim-sharded under the rules). The
    rope term is then a float32 partial sum over the rope dims' ranks,
    reduced to the latent's positions (reduce-scattered over the
    sequence, or all-reduced) before the scale, the mask and the split
    softmax; the context's float32 partial sums are all-reduced over the
    sequence's ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    lay = _CacheLayout(ckv)
    mesh = lay.mesh
    if any(pl.is_shard(2) for pl in ckv.placements):
        raise ValueError(f"MLA's latent cache sharded over the latent "
                         f"({ckv.placements}) is not a layout of the rules")
    rows = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                 for pl in ckv.placements)
    qa = q_abs.redistribute(mesh, rows).to_local()
    qr = q_rope.redistribute(mesh, tuple(
        pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
        for pl in krope.placements)).to_local()
    ckvl = ckv.to_local()
    latent = _bmm_f32(qa, ckvl.transpose(1, 2))
    # the rope term over krope's positions, a partial sum over its rope
    # dims' ranks, taken to the latent term's layout (rows, positions)
    rope = _bmm_f32(qr, krope.to_local().transpose(1, 2))
    have = tuple(Shard(0) if pl.is_shard(0) else Shard(2) if pl.is_shard(1)
                 else Partial() if pl.is_shard(2) else Replicate()
                 for pl in krope.placements)
    want = tuple(Shard(0) if pl.is_shard(0) else Shard(2) if pl.is_shard(1)
                 else Replicate() for pl in ckv.placements)
    rope = lay.wrap(rope, q_abs.shape[:2] + ckv.shape[1:2],
                    have).redistribute(mesh, want).to_local()
    scores = (latent + rope) * scale
    scores = scores.masked_fill(
        ~_valid(ckvl.shape[1], pos, ckvl.device, lay.offset), float("-inf"))
    w = lay.softmax(scores, dtype)
    if lay.seq:
        dt = torch.promote_types(w.dtype, ckvl.dtype)
        ctx = lay.reduce(_bmm_f32(w, ckvl), lay.seq).to(dt)
    else:
        ctx = promoted_einsum("bht,btq->bhq", w, ckvl)
    return lay.wrap(ctx, q_abs.shape, rows)


# ---------------------------------------------------------------------------
# Cross-attention (VLM decoder layers attending to stubbed vision tokens)
# ---------------------------------------------------------------------------


def cross_attn_init(key: prng.Key, cfg: ModelConfig) -> PyTree:
    ks = prng.split(key, 5)
    H, K, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    E = cfg.encoder_dim or D
    dev = key[0].device
    return {
        "wq": p(ks[0], (D, H, hd), ("embed", "q_heads", "head"), cfg.dtype),
        "wk": p(ks[1], (E, K, hd), ("enc_embed", "kv_heads", "head"),
                cfg.dtype),
        "wv": p(ks[2], (E, K, hd), ("enc_embed", "kv_heads", "head"),
                cfg.dtype),
        "wo": p(ks[3], (H, hd, D), ("q_heads", "head", "embed"), cfg.dtype),
        "norm": pz((D,), ("embed",), torch.float32, device=dev),
        # tanh-gated residual (llama3.2-V): adds exactly 0 at init
        "gate": pz((), (), torch.float32, device=dev),
    }


#: the encoder tokens a chunk of `cross_attn_apply`'s streamed softmax
_ENC_CHUNK = 1600


def cross_attn_apply(prm, x, enc, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,D) decoder states; enc: (B,N,E) encoder tokens (no mask).

    The softmax over the N encoder tokens is streamed in `_ENC_CHUNK`
    chunks (when N is a multiple of the chunk and above it; else one
    chunk) with a running max and denominator, the online softmax of
    `_sdpa_causal_streamed` without a mask, so the (S x N) scores of all
    chunks never exist at once. The output is scaled by tanh(gate).

    Sharded (DTensors), the reference's constraints: enc over its tokens
    ('model'), k and v projected on each rank's encoder shard and then
    gathered over the tokens with their heads over 'model', q
    sequence-parallel (the projections on local shards, `project`, as
    GQA's); the softmax runs on each rank's rows and kv heads, or its
    own query rows where the kv heads do not divide (`_on_local_heads`)."""
    h = rms_norm(x, prm["norm"])
    # the encoder's shape is read where the reference's sharding constraint
    # reads it, so that enc=None fails here with the reference's error
    enc.shape
    enc = constrain(enc, ("batch", "enc_tokens", "enc_embed"))
    q = project("bsd,dhk->bshk", h, prm["wq"])
    q = constrain(q, ("batch", "seq_sp", "q_heads", "head"))
    k, v = project("bne,ehk->bnhk", enc, prm["wk"], prm["wv"])
    k = constrain(k, ("batch", "enc_tokens", "kv_heads", "head"))
    v = constrain(v, ("batch", "enc_tokens", "kv_heads", "head"))
    k = constrain(k, ("batch", None, "kv_heads", "head"))
    v = constrain(v, ("batch", None, "kv_heads", "head"))
    if is_dtensor(q):
        out = _on_local_heads(_cross_softmax, q, k, v, x.dtype)
    else:
        out = _cross_softmax(q, k, v, x.dtype)
    out = project("bshk,hkd->bsd", out, prm["wo"])
    out = torch.tanh(prm["gate"].float()).to(x.dtype) * out
    return constrain(out, ("batch", "seq_sp", "embed_act"))


def _cross_chunk(qg, k_c, v_c, m, l, acc, scale, dtype):
    """One encoder chunk of `_cross_softmax`'s online softmax, unmasked
    (`_causal_chunk`'s recurrence; checkpointed the same way)."""
    s = promoted_einsum("bskgh,bnkh->bskgn", qg, k_c).float() * scale
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    pr = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = corr * l + torch.sum(pr, dim=-1, keepdim=True)
    pv = promoted_einsum("bskgn,bnkh->bskgh", pr.to(dtype), v_c)
    return m_new, l, acc * corr + pv


def _cross_softmax(q, k, v, dtype):
    """The streamed softmax of q (B,S,H,hd) over the N encoder keys of k
    and v (B,N,K,hd), unmasked, each chunk checkpointed (`_cross_chunk`):
    (B,S,H,hd) in `dtype`."""
    B, S, H, hd = q.shape
    N, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scale = 1.0 / _sqrt_hd(hd, q.device)
    chunk = _ENC_CHUNK if (N % _ENC_CHUNK == 0 and N > _ENC_CHUNK) else N
    m = torch.full((B, S, K, G, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, K, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, hd), dtype=torch.float32,
                      device=q.device)
    for k_c, v_c in zip(k.split(chunk, dim=1), v.split(chunk, dim=1)):
        m, l, acc = _chunked(_cross_chunk, qg, k_c, v_c, m, l, acc, scale,
                             dtype)
    return (acc / torch.clamp(l, min=1e-30)).to(dtype).reshape(B, S, H, hd)
