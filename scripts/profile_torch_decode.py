"""What one GQA decode layer's attention costs on one CUDA card, by the
form of its two contractions, at llama3-8b's decode cell (B=8 over a
32,768-position bf16 cache, 8 kv heads of 128, 4 queries a kv head).

    PYTHONPATH=src python3 scripts/profile_torch_decode.py

The scores (float32, from bf16 operands, as the reference's
`preferred_element_type=float32`) and the context P·V, each two ways:

  einsum      `torch.einsum` of the operands taken to float32 (scores) and
              of bf16 (P·V): each batches over (b, kv head), which the
              (B, T, K, hd) cache does not lay out with one stride, so it
              copies the cache permuted (and, for the scores, upcast)
  port        `models.attention._gqa_scores` and `_gqa_context`: the
              queries block-diagonal over kv heads, one batched matmul
              each over the cache as it lies (cuBLAS, bf16 in, float32
              out for the scores)

Prints one JSON line per form (CUDA-event medians of 10 calls after 2,
each beside the bytes bound: the K or V cache read once at 3.35 TB/s)
with the scores' largest difference from the einsum form over the
largest score and whether the contexts are equal, then the card's name
and power limit as nvidia-smi prints them.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, T, K, G, HD = 8, 32768, 8, 4, 128
HBM_BYTES_PER_S = 3.35e12


def _median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    from repro_torch.models import attention

    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    qg = torch.randn((B, K, G, HD), generator=gen, device="cuda").to(bf16)
    ck = torch.randn((B, T, K, HD), generator=gen, device="cuda").to(bf16)
    cv = torch.randn((B, T, K, HD), generator=gen, device="cuda").to(bf16)
    w = torch.softmax(torch.randn((B, K, G, T), generator=gen,
                                  device="cuda"), dim=-1).to(bf16)
    forms = {
        "einsum": (
            lambda: torch.einsum("bkgh,btkh->bkgt", qg.float(), ck.float()),
            lambda: torch.einsum("bkgt,btkh->bkgh", w, cv)),
        "port": (lambda: attention._gqa_scores(qg, ck),
                 lambda: attention._gqa_context(w, cv)),
    }
    ref_scores, ref_context = (f() for f in forms["einsum"])
    bound_ms = B * T * K * HD * 2 / HBM_BYTES_PER_S * 1e3
    for name, (scores, context) in forms.items():
        s, c = scores(), context()
        print(json.dumps({
            "form": name, "scores_ms": _median_ms(scores),
            "context_ms": _median_ms(context), "bound_ms_each": bound_ms,
            "scores_max_rel": float((s - ref_scores).abs().max()
                                    / ref_scores.abs().max()),
            "context_equal": bool(torch.equal(c, ref_context))}),
            flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
