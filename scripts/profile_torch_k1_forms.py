"""Kernel K1's two kernels against each other on one CUDA card, to place
the row reads a column, n (k + 1), below which its library takes the
register kernel (`kSlabMinReads` in src/repro_torch/kernels/csrc/
gossip_mix.cu, read back through `gossip_mix.slab_min_reads()`).

    PYTHONPATH=src python3 scripts/profile_torch_k1_forms.py

For each leaf in LEAVES (the LM launcher's pod mix: the embed leaf, an
FFN leaf and a K/V leaf of llama3-8b at four superblocks, bf16, a norm
leaf, fp32, and the dense main path's call, M = 4096 fp32), each of its
row counts n and each neighbor count k in KS below n (S_in[i, j] =
(i + j + 1) mod n, uniform weights 1/(k + 1)), times
`gossip_mix.gossip_mix_weighted` with form="regs" and with form="slab" on
the same inputs (CUDA-event medians as chip_smoke.py's `time_ms` takes
them: eager above 64 MiB a call, graph-replayed below),
checks that the two give the same bits, and prints one JSON line a case
with both times, the bound (z read once, out written once, at 3.35 TB/s)
the faster kernel and the one the library picks; then a summary line
with, for each leaf, the cases where the library's pick was the slower
kernel and by how much; then the card's name and power limit as
nvidia-smi prints them.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (label, dtype, M, row counts): leaves of the full-width LM cell
#: (n_super = 4) at the row counts their bytes allow on the card, and the
#: dense main path's call (n = 256, M = 4096, fp32) at fewer rows
LEAVES = (("embed", "bfloat16", 128256 * 4096, (2, 3, 4, 6, 8, 12, 16)),
          ("ffn w", "bfloat16", 4 * 4096 * 14336, (2, 4, 8, 16, 24, 32)),
          ("wk", "bfloat16", 4 * 4096 * 8 * 128,
           (2, 4, 8, 16, 32, 64, 128)),
          ("norm", "float32", 4 * 4096, (2, 4, 8, 16, 32, 64, 128, 256)),
          ("main path", "float32", 4096, (2, 4, 8, 16, 32, 64, 128, 256)))
KS = (1, 2, 4, 8)
#: bytes a call above which it is timed eagerly (graphs of such calls hold
#: their outputs for nothing: the launch overhead is negligible there)
EAGER_BYTES = 64 << 20


def _case(n: int, k: int, dtype: str, M: int) -> dict:
    import torch

    from chip_smoke import _bound, time_ms
    from repro_torch.kernels import gossip_mix

    gen = torch.Generator(device="cuda").manual_seed(n * 10 + k)
    z = torch.empty((n, M), dtype=getattr(torch, dtype), device="cuda")
    for i in range(n):  # a row at a time: no (n, M) float32 temporary
        z[i] = torch.randn((M,), generator=gen, device="cuda")
    S_in = torch.tensor([[(i + j + 1) % n for j in range(k)]
                         for i in range(n)], dtype=torch.int64,
                        device="cuda")
    w_self = torch.full((n,), 1.0 / (k + 1), dtype=torch.float32,
                        device="cuda")
    w_edge = torch.full((n, k), 1.0 / (k + 1), dtype=torch.float32,
                        device="cuda")
    # the slab kernel, then the library's own pick, each against the
    # register kernel's bits (one output besides z held at a time)
    regs = gossip_mix.gossip_mix_weighted(z, S_in, w_self, w_edge,
                                          form="regs")
    for form in ("slab", None):
        before = dict(gossip_mix.FORM_LAUNCHES)
        out = gossip_mix.gossip_mix_weighted(z, S_in, w_self, w_edge,
                                             form=form)
        picked, = (f for f, count in gossip_mix.FORM_LAUNCHES.items()
                   if count != before[f])
        if not torch.equal(out, regs):
            raise AssertionError(f"K1's kernels differ at n={n}, k={k}, "
                                 f"M={M}")
        del out
    del regs
    nbytes = 2 * z.numel() * z.element_size()
    eager = nbytes > EAGER_BYTES
    times = {}
    for form in ("regs", "slab"):
        t = time_ms(lambda: gossip_mix.gossip_mix_weighted(
            z, S_in, w_self, w_edge, form=form),
            reps=5 if eager else 25, inner=3 if eager else 20,
            graph=not eager, warmup=2)
        times[form] = t["device"]
    del z
    torch.cuda.empty_cache()
    return {"n": n, "k": k, "dtype": dtype, "M": M,
            "regs_ms": times["regs"], "slab_ms": times["slab"],
            "slab_over_regs": times["slab"] / times["regs"],
            "faster": "slab" if times["slab"] <= times["regs"] else "regs",
            "picked": picked,
            "timing": "eager" if eager else "graph",
            **_bound(nbytes, 0.0)}


def main() -> int:
    import torch

    from repro_torch.kernels import gossip_mix

    if not torch.cuda.is_available():
        print("profile_torch_k1_forms: no CUDA device", file=sys.stderr)
        return 1
    misses = {}
    for label, dtype, M, row_counts in LEAVES:
        misses[label] = []
        for n in row_counts:
            for k in KS:
                if k >= n:
                    continue
                row = _case(n, k, dtype, M)
                print(json.dumps({"leaf": label, **row}), flush=True)
                if row["picked"] != row["faster"]:
                    ratio = row[f"{row['picked']}_ms"] / row[
                        f"{row['faster']}_ms"]
                    misses[label].append({"n": n, "k": k,
                                          "picked_over_faster": ratio})
    print(json.dumps({"slab_min_reads": gossip_mix.slab_min_reads(),
                      "picked_the_slower": misses}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
