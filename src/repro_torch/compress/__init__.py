"""`repro_torch.compress` -- compressed gossip, the paper's second tradeoff
axis, in PyTorch: the port of `repro.compress`.

Compression makes each MESSAGE cheap, multiplying the effective per-round
cost by the compressor's wire ratio c and shifting every optimum the
schedule axis is tuned against (n_opt = 1/sqrt(rc), h_opt ~ sqrt(nkrc);
pass `c=` to `core.tradeoff`).

`build_compressor(kind, params)` is the registry front door -- the same
(kind, params) contract `ExperimentSpec.compression` carries, so a frozen
spec rebuilds the exact wire format on either package:

    kind "none"   -- identity (ratio 1)
    kind "topk"   -- largest-|x| sparsification, value+index pairs
    kind "randk"  -- random sparsification with shared (seed, round)
                     randomness, values only
    kind "int8"   -- absmax int8 quantization, optional stochastic
                     rounding; codes + one scale

See `base.py` for the three halves every compressor implements and
`prng.py` for the reference's random bits.
"""

from __future__ import annotations

from typing import Any

from repro_torch.compress.base import (INDEX_BYTES, VALUE_BYTES, Compressor,
                                       Int8, NoCompression, RandK, TopK,
                                       keep_count, topk_indices_flat,
                                       topk_mask_np, topk_mask_torch)
from repro_torch.experiments.registry import Registry

__all__ = [
    "COMPRESSORS",
    "compressors",
    "Compressor",
    "NoCompression",
    "TopK",
    "RandK",
    "Int8",
    "build_compressor",
    "keep_count",
    "topk_indices_flat",
    "topk_mask_torch",
    "topk_mask_np",
    "VALUE_BYTES",
    "INDEX_BYTES",
]

COMPRESSORS: dict[str, type[Compressor]] = {
    "none": NoCompression,
    "topk": TopK,
    "randk": RandK,
    "int8": Int8,
}

#: the experiments-layer registry (`ExperimentSpec.compression` resolves
#: here); builders are the frozen dataclasses themselves, so registry
#: params == constructor kwargs
compressors = Registry("compressor")
for _kind, _cls in COMPRESSORS.items():
    compressors.register(_kind)(_cls)
del _kind, _cls


def build_compressor(kind: str, params: dict[str, Any] | None = None
                     ) -> Compressor:
    """Build a compressor from its spec component (kind, params); raises
    ValueError on unknown kinds or params so a typo'd frozen spec fails
    loudly instead of silently running uncompressed."""
    cls = COMPRESSORS.get(kind)
    if cls is None:
        raise ValueError(f"unknown compression kind {kind!r} "
                         f"(have {sorted(COMPRESSORS)})")
    try:
        return cls(**dict(params or {}))
    except TypeError as e:
        raise ValueError(f"bad params for compression {kind!r}: {e}") from e
