"""The assigned input-shape set for the LM-family architectures.

Every arch gets the same 4 logical shapes; per-arch SHAPES dicts may mark
cells skipped (e.g. long_500k for pure full-attention archs) with a reason.

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> train-style forward (prefill)
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> serve_step (1 new token)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"
    skip: str | None = None  # reason, if inapplicable to this arch


def lm_shapes(long_ok: bool, long_skip_reason: str = "") -> dict[str, ShapeCell]:
    cells = {
        "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
        "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
        "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
        "long_500k": ShapeCell(
            "long_500k", 524288, 1, "decode",
            skip=None if long_ok else (
                long_skip_reason or
                "pure full-attention arch: 500k dense KV cache is "
                "super-linear in memory; no sub-quadratic variant in the "
                "published config (DESIGN.md section 5)")),
    }
    return cells
