"""What sets the pace of kernel K4 on one CUDA card: its sm90 route
(flash_attention_sm90.cu, bf16) or its tf32x3 route (flash_attention.cu,
3xTF32 on mma.sync, fp32).

    PYTHONPATH=src python3 scripts/profile_torch_attention.py \
        [--dtype bfloat16|float32] [--out DIR]

Times the front door (`repro_torch.kernels.ops.flash_attention`) on inputs
of --dtype (bf16 by default: the sm90 route; float32: the tf32x3 route)
and torch's scaled_dot_product_attention on the same inputs (a yardstick
the port never calls, K and V repeated per group outside the timed window)
at llama3-8b's attention at train_4k (B=1, H=32, KH=8, S=4096, D=128,
causal) and at cells that each move one thing away from it:

  noncausal  every pair kept: twice the work, no diagonal tiles and no
             uneven blocks, so causal / noncausal time per pair shows what
             the causal tail costs
  D=64       half the tensor-core work per pair at the same key tile and
             the same softmax work per pair: with D=128 it splits the time
             per pair into a part that grows with D (the products, and on
             the tf32x3 route the operand splits and fragment loads) and
             one that does not (softmax, P's split, masks, waits)
  D=256      the 64-key tiles of the widest head dim
  KH=32      four times the distinct K and V bytes through the producer
  S=1024, S=8192  fewer and more waves of blocks

Each cell reports its share of the route's floor: on sm90 the reference's
4 D flops a kept pair and the split's 6 D at 989 TFLOP/s bf16; on tf32x3
the reference's 4 D at 495 TFLOP/s TF32 (its bound), 3 x 4 D there (the
3xTF32 floor), and 4 D at 67 TFLOP/s on the CUDA cores.
Times are CUDA-graph medians as chip_smoke.py's `time_ms` takes them. It
then profiles 20 eager calls at the first cell under `torch.profiler`
(device time of the kernel, launches, the device's idle share of the
wall) and prints one JSON line per cell, one for the fit and one for the
profile, then the card's name and power limit as nvidia-smi prints them.
With --out, the profiled run's Chrome trace is written there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (label, B, H, KH, S, D, causal); the first is the llama3-8b cell
CELLS = (("llama3-8b train_4k", 1, 32, 8, 4096, 128, True),
         ("noncausal", 1, 32, 8, 4096, 128, False),
         ("D=64", 1, 32, 8, 4096, 64, True),
         ("D=256", 1, 32, 8, 4096, 256, True),
         ("KH=32", 1, 32, 32, 4096, 128, True),
         ("S=1024", 1, 32, 8, 1024, 128, True),
         ("S=8192", 1, 32, 8, 8192, 128, True))


#: the route each --dtype takes at these cells' head dims, and its counter
ROUTE_COUNTER = {"bfloat16": ("sm90", "SM90_LAUNCHES"),
                 "float32": ("tf32x3", "TF32X3_LAUNCHES")}


def _inputs(B, H, KH, S, D, seed, dtype):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, h, S, D), generator=gen, device="cuda")
                 .to(getattr(torch, dtype)) for h in (H, KH, KH))


def _floor_shares(dtype: str, D: int, pairs: int, ms: float) -> dict:
    """The cell's time against its route's floors (see the docstring)."""
    from chip_smoke import BF16_FLOPS, FP32_FLOPS, TF32_FLOPS

    ref_flops = 4 * D * pairs
    if dtype == "bfloat16":
        split_flops = 6 * D * pairs
        return {"ref_tflops": ref_flops / ms * 1e-9,
                "split_tflops": split_flops / ms * 1e-9,
                "split_bound_share": split_flops / BF16_FLOPS * 1e3 / ms,
                "ref_bound_share": ref_flops / BF16_FLOPS * 1e3 / ms}
    return {"ref_tflops": ref_flops / ms * 1e-9,
            "tf32x3_tflops": 3 * ref_flops / ms * 1e-9,
            "ref_bound_share": ref_flops / TF32_FLOPS * 1e3 / ms,
            "tf32x3_floor_share": 3 * ref_flops / TF32_FLOPS * 1e3 / ms,
            "cuda_core_bound_share": ref_flops / FP32_FLOPS * 1e3 / ms}


def time_cell(label, B, H, KH, S, D, causal, seed, dtype) -> dict:
    import torch
    import torch.nn.functional as F

    from chip_smoke import _attention_pairs, time_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q, k, v = _inputs(B, H, KH, S, D, seed, dtype)
    kr = k.repeat_interleave(H // KH, dim=1)
    vr = v.repeat_interleave(H // KH, dim=1)
    route, counter = ROUTE_COUNTER[dtype]
    before = getattr(fa, counter)
    ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if getattr(fa, counter) != before + 1:
        raise AssertionError(f"{label}: the call did not take the {route} "
                             f"route")
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                 reps=10, inner=3)["device"]
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=causal), reps=10, inner=3)["device"]
    pairs = B * H * _attention_pairs(S, S, causal)
    return {"cell": label, "dtype": dtype, "route": route, "B": B, "H": H,
            "KH": KH, "S": S, "D": D, "causal": causal, "ms": ms,
            "sdpa_ms": sdpa, "kept_pairs": pairs,
            "ns_per_pair": ms * 1e6 / pairs,
            **_floor_shares(dtype, D, pairs, ms)}


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise AttributeError("profiler event has no device time field")


def profile_cell(out_dir: pathlib.Path | None, dtype: str,
                 calls: int = 20) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    _, B, H, KH, S, D, causal = CELLS[0]
    q, k, v = _inputs(B, H, KH, S, D, 0, dtype)
    for _ in range(3):
        ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [{"name": ev.key[:80], "calls": ev.count,
                "device_us": _device_us(ev)}
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e["device_us"])
    busy = sum(e["device_us"] for e in kernels) * 1e-6
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(out_dir / f"attention_llama3_8b_{dtype}.json"))
    return {"profile": CELLS[0][0], "dtype": dtype, "calls": calls,
            "wall_s": wall,
            "device_busy_s": busy, "idle_share": 1.0 - busy / wall,
            "kernels": kernels[:4]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=sorted(ROUTE_COUNTER),
                    default="bfloat16",
                    help="input dtype: bfloat16 (sm90 route) or float32 "
                         "(tf32x3 route)")
    ap.add_argument("--out", default=None,
                    help="directory for the profiled run's Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_attention: no CUDA device", file=sys.stderr)
        return 1
    rows = {}
    for seed, cell in enumerate(CELLS):
        rows[cell[0]] = time_cell(*cell, seed=seed, dtype=args.dtype)
        print(json.dumps(rows[cell[0]]), flush=True)
        torch.cuda.empty_cache()
    # time per pair = a + b D over D in {64, 128} (the same key tiles)
    t64, t128 = rows["D=64"]["ns_per_pair"], rows[CELLS[0][0]]["ns_per_pair"]
    b = (t128 - t64) / 64
    a = t64 - 64 * b
    base, flat = rows[CELLS[0][0]], rows["noncausal"]
    print(json.dumps({
        "fit": "ns per kept pair = a + b D (D = 64, 128)",
        "a_ns": a, "b_ns": b, "share_not_growing_with_D_at_128": a / t128,
        "causal_over_noncausal_per_pair":
            base["ns_per_pair"] / flat["ns_per_pair"],
        "kh32_over_kh8": rows["KH=32"]["ms"] / base["ms"]}), flush=True)
    print(json.dumps(profile_cell(
        pathlib.Path(args.out) if args.out else None, args.dtype)),
        flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
