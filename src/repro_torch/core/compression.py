"""[Beyond paper] Message compression for consensus exchanges: the port of
`repro.core.compression`, the seed-era flat-vector API.

The paper's tradeoff parameter r is (message time)/(gradient time). Top-k
sparsification with error feedback shrinks message bytes by the compression
ratio c, hence r -> r*c, which moves the paper's optima:

    n_opt = 1/sqrt(r c)     (eq. 11, larger optimal cluster)
    h_opt ~ sqrt(n k r c)   (eq. 21, communicate more often again)

Error feedback (memory of the residual) keeps the consensus average unbiased
over time and is required for convergence with biased compressors.

The full subsystem -- the compressor registry, the per-message byte models
and the numpy halves the netsim engines consume -- is `repro_torch.compress`,
and the top-k support here is its one exact-k implementation
(`compress.base.topk_indices_flat`: ties toward the lower index, as
`lax.top_k`), so the flat API and the simulators agree on ties.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.utils._pytree as _pytree

from repro_torch.compress.base import (INDEX_BYTES, VALUE_BYTES,
                                       topk_indices_flat)

__all__ = ["CompressionState", "topk_compress", "topk_decompress",
           "ef_init", "ef_compress", "ratio_bytes"]

PyTree = Any


class CompressionState(NamedTuple):
    residual: PyTree  # error-feedback memory, same structure as the message


def topk_compress(x: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (values, flat indices) of the k largest-magnitude entries.
    Exactly k even on magnitude ties (the shared exact-k implementation)."""
    flat = x.reshape(-1)
    k = min(k, flat.shape[0])
    idx = topk_indices_flat(flat, k)
    return flat[idx], idx


def topk_decompress(values: torch.Tensor, idx: torch.Tensor, shape
                    ) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=values.dtype,
                      device=values.device)
    out[idx] = values
    return out.reshape(shape)


def ef_init(msg_like: PyTree) -> CompressionState:
    return CompressionState(
        residual=_pytree.tree_map(torch.zeros_like, msg_like))


def ef_compress(msg: PyTree, state: CompressionState,
                keep_fraction: float = 0.01
                ) -> tuple[PyTree, CompressionState]:
    """Error-feedback top-k: compress (msg + residual), remember what was
    dropped. Returns (sparse-but-dense-layout message, new state); the dense
    layout keeps downstream mixing code unchanged while bytes-on-wire are
    counted via `ratio_bytes`."""

    def one(m, res):
        corrected = m + res
        k = max(1, int(corrected.numel() * keep_fraction))
        vals, idx = topk_compress(corrected, k)
        sent = topk_decompress(vals, idx, tuple(corrected.shape))
        return sent, corrected - sent

    flat_m, spec = _pytree.tree_flatten(msg)
    flat_r = _pytree.tree_leaves(state.residual)
    sent_res = [one(m, r) for m, r in zip(flat_m, flat_r)]
    sent = _pytree.tree_unflatten([s for s, _ in sent_res], spec)
    resid = _pytree.tree_unflatten([r for _, r in sent_res], spec)
    return sent, CompressionState(residual=resid)


def ratio_bytes(keep_fraction: float, dtype_bytes: int = VALUE_BYTES,
                index_bytes: int = INDEX_BYTES) -> float:
    """Bytes-on-wire ratio of top-k vs dense (values + indices). The
    per-compressor generalization -- rand-k's index-free wire format,
    int8's codes+scale -- is `Compressor.wire_ratio` in
    `repro_torch.compress`."""
    return keep_fraction * (dtype_bytes + index_bytes) / dtype_bytes
