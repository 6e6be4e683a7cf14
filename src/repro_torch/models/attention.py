"""Self-attention, the port of `repro.models.attention`'s training path: GQA
(`gqa_init`, `_qkv`, `gqa_apply`), MLA, DeepSeek-V2's multi-head latent
attention (`mla_init`, `_mla_q`, `_mla_kv_latent`, `mla_apply`), and the
grouped causal attention both run (`_sdpa_causal`, with
`_sdpa_causal_streamed`'s online softmax over KV chunks for long
sequences).

All shapes follow (batch, seq, heads, head_dim). GQA repeats are expressed
by grouping q heads as (kv_heads, group), so the einsums contract natively
without materializing repeated K/V. These are plain torch matmuls and
softmax, the counterpart of the reference's XLA path (it reaches no Pallas
kernel); `scaled_dot_product_attention` is not used, since its rounding is
not the reference's: the scores are rounded to the activations' dtype by
their einsum and then taken to float32, the softmax weights cast back
before P·V, as the reference casts. Cross-attention and the decode caches
come with later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.compress import prng
from repro_torch.models.common import (ModelConfig, apply_rope, p, pz,
                                       rms_norm)

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


def _qkv(prm, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, prm["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, prm["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, prm["wv"])
    if cfg.qkv_bias:
        q, k, v = q + prm["bq"], k + prm["bk"], v + prm["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _inv_sqrt_hd(hd: int, device) -> torch.Tensor:
    """The float32 `jnp.sqrt(hd)` the scores are divided by."""
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                   device=device))


def _sdpa_causal_streamed(q, k, v):
    """Causal attention with the online-softmax (flash) recurrence over KV
    chunks. q: (B,S,H,hd); k, v: (B,T,K,hd) with T a multiple of the
    chunk; masks use global row indices (row r sees columns up to
    r + T - S)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    v_hd = v.shape[-1]
    qg = q.reshape(B, S, K, G, hd)
    scale = 1.0 / _inv_sqrt_hd(hd, q.device)
    rows = torch.arange(S, device=q.device) + (T - S)
    m = torch.full((B, S, K, G, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, K, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, v_hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, T, _KV_CHUNK):
        k_c, v_c = k[:, c0:c0 + _KV_CHUNK], v[:, c0:c0 + _KV_CHUNK]
        s = torch.einsum("bskgh,btkh->bskgt", qg, k_c).float() * scale
        cols = c0 + torch.arange(_KV_CHUNK, device=q.device)
        mask = rows[:, None] >= cols[None, :]                 # (S, chunk)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.tensor(-1e30, dtype=torch.float32,
                                     device=q.device))
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        pr = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + torch.sum(pr, dim=-1, keepdim=True)
        pv = torch.einsum("bskgt,btkh->bskgh", pr.to(q.dtype), v_c)
        acc = acc * corr + pv
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.reshape(B, S, H, v_hd)


def _sdpa_causal_whole(q, k, v):
    """Grouped causal attention over the whole (S x T) score matrix with
    its softmax (the reference's q-chunked form computes this, row block
    by row block). q: (B,S,H,hd); k, v: (B,T,K,hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / _inv_sqrt_hd(hd, q.device)
    mask = torch.ones((S, T), dtype=torch.bool,
                      device=q.device).tril(diagonal=T - S)
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(
        B, S, H, v.shape[-1])


def _sdpa_causal(q, k, v):
    """Grouped causal attention. q: (B,S,H,hd); k, v: (B,T,K,hd).

    The reference's launcher takes the streamed form where T is above one
    KV chunk and a multiple of it, else the whole score matrix."""
    T = k.shape[1]
    if T > _KV_CHUNK and T % _KV_CHUNK == 0:
        return _sdpa_causal_streamed(q, k, v)
    return _sdpa_causal_whole(q, k, v)


def gqa_apply(prm, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Prefill/training forward (causal)."""
    h = rms_norm(x, prm["norm"])
    q, k, v = _qkv(prm, h, cfg, positions)
    out = _sdpa_causal(q, k, v)
    return torch.einsum("bshk,hkd->bsd", out, prm["wo"])


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


def _mla_q(prm, h, cfg: ModelConfig, positions):
    qk_nope = cfg.hd
    ql = torch.einsum("bsd,dq->bsq", h, prm["wq_a"])
    ql = rms_norm(ql, prm["q_norm"])
    q = torch.einsum("bsq,qhk->bshk", ql, prm["wq_b"])
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(prm, h, cfg: ModelConfig, positions):
    kvl = cfg.mla_kv_lora
    kv = torch.einsum("bsd,dq->bsq", h, prm["wkv_a"])
    c_kv, k_rope = kv[..., :kvl], kv[..., kvl:]
    c_kv = rms_norm(c_kv, prm["kv_norm"])
    # rope over a head axis of one, inserted and taken out again
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_apply(prm, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Prefill/training forward: the latent expanded per head, then the
    causal attention with the rope dims concatenated onto q and k (the
    shared rope key broadcast to every head), so the softmax scale is
    1/sqrt(nope + rope), as DeepSeek-V2's. v has its own head dim."""
    h = rms_norm(x, prm["norm"])
    q_nope, q_rope = _mla_q(prm, h, cfg, positions)
    c_kv, k_rope = _mla_kv_latent(prm, h, cfg, positions)
    k_nope = torch.einsum("bsq,qhk->bshk", c_kv, prm["wk_b"])
    v = torch.einsum("bsq,qhk->bshk", c_kv, prm["wv_b"])
    B, S, H, _ = q_nope.shape
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, cfg.mla_rope_head_dim)], dim=-1)
    out = _sdpa_causal(q_full, k_full, v)
    return torch.einsum("bshk,hkd->bsd", out, prm["wo"])
