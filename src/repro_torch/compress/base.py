"""Compressor objects: the torch and numpy halves of one wire format -- the
port of `repro.compress.base`.

Every compressor bundles three things:

  * a torch stack API (`compress_torch(corrected, t)` on a stacked (n, d)
    tensor, `t` the simulator's float32 iteration counter) used inside
    `DDASimulator`'s compressed mix; sparsifiers also expose
    `support_mask_torch`, so the compress-mix kernel (K2) takes the 0/1
    support directly instead of a masked message;
  * a numpy per-message API (`compress_np(row, node, stamp)`), copied
    verbatim from the reference for the event-driven engines;
  * a per-message byte model (`wire_ratio(d)`): the fraction of the
    uncompressed d-float payload that crosses the wire, the c in the
    paper's effective tradeoff r -> r*c.

All compressors return the DENSE representation of the transmitted
message (zeros off the support for sparsifiers, dequantized values for
quantizers). Error feedback is owned by the caller: the compressor is a
pure function of the corrected message `m + residual`, and the caller keeps
`residual <- corrected - sent`.

The torch halves reproduce the reference bit for bit on the CPU: top-k
breaks magnitude ties toward the lower index as `lax.top_k` does, and the
random draws are jax's own threefry bits (`compress.prng`).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from repro_torch.compress import prng

__all__ = [
    "VALUE_BYTES",
    "INDEX_BYTES",
    "Compressor",
    "NoCompression",
    "TopK",
    "RandK",
    "Int8",
    "keep_count",
    "topk_mask_torch",
    "topk_mask_np",
    "topk_indices_flat",
]

#: wire width of one transmitted float value / coordinate index
VALUE_BYTES = 4
INDEX_BYTES = 4


def keep_count(d: int, keep: float) -> int:
    """Entries kept per d-dim message at fraction `keep` (always >= 1)."""
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must be in (0, 1], got {keep}")
    return max(1, min(d, int(d * keep)))


# ---------------------------------------------------------------------------
# exact top-k: exactly k entries, ties broken toward the lower index
# ---------------------------------------------------------------------------


def _top_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, ties toward
    the lower index, as `lax.top_k` gives them. `torch.topk` documents no
    tie order, so this is a stable descending sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def _mask_of(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # out of place: `torch.func.vmap` has a batching rule for `scatter`
    # (the simulator maps the compressors over sweep lanes), not `scatter_`
    return torch.zeros_like(x).scatter(-1, idx, 1.0)


def topk_indices_flat(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest-|x| entries of a flat vector; exactly k,
    ties broken toward the lower index."""
    return _top_indices(torch.abs(x.reshape(-1)), k)


def topk_mask_torch(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly-k per-row 0/1 support mask of the k largest-|x| entries, in
    x's dtype. x: (n, d). A thresholding mask (`|x| >= kth largest`) is not
    equivalent: on magnitude ties it keeps every tied entry."""
    return _mask_of(x, _top_indices(torch.abs(x), k))


def topk_mask_np(row: np.ndarray, k: int) -> np.ndarray:
    """Numpy twin of `topk_mask_torch` for one (d,) message: stable argsort
    on -|x| breaks ties toward the lower index, matching `lax.top_k`."""
    idx = np.argsort(-np.abs(row), kind="stable")[:k]
    mask = np.zeros_like(row)
    mask[idx] = 1.0
    return mask


#: float32(1 / Int8.LEVELS), the scale factor XLA folds `/ 127` into
_INV_LEVELS = float(np.float32(1.0 / 127))


def _round_key(seed: int, t: torch.Tensor) -> prng.Key:
    """The reference's per-round key: fold_in(PRNGKey(seed), int32(t))."""
    return prng.fold_in(prng.key(seed, device=t.device), t)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------


class Compressor:
    """Interface; see the module docstring for the three halves."""

    kind: ClassVar[str] = "?"
    #: sparsifiers expose `support_mask_torch` and ride the compress-mix
    #: kernel; quantizers ship a dense dequantized message
    is_sparsifier: ClassVar[bool] = False
    error_feedback: bool = False

    def wire_ratio(self, d: int) -> float:
        """Bytes-on-wire fraction vs the uncompressed d-float message."""
        raise NotImplementedError

    def compress_torch(self, corrected: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
        """Dense layout of what is transmitted, (n, d) -> (n, d)."""
        raise NotImplementedError

    def compress_np(self, row: np.ndarray, node: int,
                    stamp: int) -> np.ndarray:
        """One message, (d,) -> (d,); must return a fresh array."""
        raise NotImplementedError

    def params_dict(self) -> dict:
        """The spec params that rebuild this compressor (JSON-exact)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class NoCompression(Compressor):
    """Identity wire format: ratio 1, no residual ever accumulates."""

    kind: ClassVar[str] = "none"
    error_feedback: bool = False

    def wire_ratio(self, d: int) -> float:
        return 1.0

    def compress_torch(self, corrected, t):
        return corrected

    def compress_np(self, row, node, stamp):
        return row.copy()


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Largest-|x| sparsification: keep `keep_count(d, keep)` coordinates,
    ship (value, index) pairs."""

    kind: ClassVar[str] = "topk"
    is_sparsifier: ClassVar[bool] = True
    keep: float = 0.1
    error_feedback: bool = True

    def __post_init__(self):
        keep_count(1, self.keep)  # validates the range eagerly

    def wire_ratio(self, d: int) -> float:
        k = keep_count(d, self.keep)
        return k * (VALUE_BYTES + INDEX_BYTES) / (d * VALUE_BYTES)

    def support_mask_torch(self, corrected, t):
        return topk_mask_torch(corrected, keep_count(corrected.shape[-1],
                                                     self.keep))

    def compress_torch(self, corrected, t):
        return corrected * self.support_mask_torch(corrected, t)

    def compress_np(self, row, node, stamp):
        return row * topk_mask_np(row, keep_count(row.shape[-1], self.keep))


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Uniform-random sparsification. The support is a pure function of
    (seed, round) -- shared randomness the receiver can replay -- so only
    the k VALUES cross the wire (no index bytes), which is why rand-k's
    ratio beats top-k's at equal keep."""

    kind: ClassVar[str] = "randk"
    is_sparsifier: ClassVar[bool] = True
    keep: float = 0.1
    seed: int = 0
    error_feedback: bool = True

    def __post_init__(self):
        keep_count(1, self.keep)

    def wire_ratio(self, d: int) -> float:
        return keep_count(d, self.keep) / d

    def support_mask_torch(self, corrected, t):
        k = keep_count(corrected.shape[-1], self.keep)
        # exactly-k random support per node row: top-k of i.i.d. scores.
        # Float32 uniforms take 2**23 values, so scores tie often; the tie
        # order (lower index first) is part of the result.
        scores = prng.uniform(_round_key(self.seed, t),
                              tuple(corrected.shape))
        return _mask_of(corrected, _top_indices(scores, k))

    def compress_torch(self, corrected, t):
        return corrected * self.support_mask_torch(corrected, t)

    def compress_np(self, row, node, stamp):
        d = row.shape[-1]
        k = keep_count(d, self.keep)
        rng = np.random.default_rng((self.seed, int(node), int(stamp)))
        out = np.zeros_like(row)
        idx = rng.permutation(d)[:k]
        out[idx] = row[idx]
        return out


@dataclasses.dataclass(frozen=True)
class Int8(Compressor):
    """Per-message absmax int8 quantization: scale s = max|x|/127, ship
    int8 codes + one float scale. `stochastic=True` rounds with
    floor(x/s + u), u ~ U[0,1) -- unbiased per entry (E[q] = x/s)."""

    kind: ClassVar[str] = "int8"
    stochastic: bool = False
    seed: int = 0
    error_feedback: bool = True

    #: quantization levels on each side of zero
    LEVELS: ClassVar[int] = 127

    def wire_ratio(self, d: int) -> float:
        return (d * 1 + VALUE_BYTES) / (d * VALUE_BYTES)

    def codes_torch(self, corrected, t):
        """(q, s): the int8 codes in [-127, 127] (as floats) and the
        per-row scale that cross the wire; the message is q * s."""
        # the reference runs this under jit, where XLA rewrites the
        # division by the constant 127 into a multiply by its float32
        # reciprocal; eager jax divides, one ulp away on some rows
        s = torch.amax(torch.abs(corrected), dim=-1,
                       keepdim=True) * _INV_LEVELS
        s = torch.where(s > 0, s, torch.ones_like(s))
        y = corrected / s
        if self.stochastic:
            u = prng.uniform(_round_key(self.seed, t), tuple(y.shape))
            q = torch.floor(y + u)
        else:
            q = torch.round(y)  # half to even, as jnp.round
        return torch.clamp(q, -self.LEVELS, self.LEVELS), s

    def compress_torch(self, corrected, t):
        q, s = self.codes_torch(corrected, t)
        return (q * s).to(corrected.dtype)

    def compress_np(self, row, node, stamp):
        s = float(np.max(np.abs(row))) / self.LEVELS
        if s <= 0.0:
            return row.copy()
        y = row / s
        if self.stochastic:
            rng = np.random.default_rng((self.seed, int(node), int(stamp)))
            q = np.floor(y + rng.random(y.shape))
        else:
            q = np.round(y)
        return np.clip(q, -self.LEVELS, self.LEVELS) * s
