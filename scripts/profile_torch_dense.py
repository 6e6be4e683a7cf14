"""Where the time goes in the PyTorch port's full-size dense cell, on one
CUDA card.

    PYTHONPATH=src python3 scripts/profile_torch_dense.py \
        [--compression {none,topk,randk,int8}] [--out DIR]

Runs the cell chip_smoke.py drives (quadratic consensus, n=256, d=4096,
expander k=4, periodic h=2, T=300, eval_every=25, sqrt(A=0.5), r=0.01),
uncompressed or under one compressor (top-k and rand-k at keep 1/4, the
compression axis of benchmarks/bench_compress.py, or deterministic int8),
through `repro_torch.run` on the card, for each mix (the sparse mix, K1 or
under a sparsifier K2, and the dense P @ z matmul): twice unprofiled (the
second is the number kept), then once under `torch.profiler` with CPU and
CUDA activities. It
prints one JSON line per mix with the unprofiled wall per iteration, the
summed device time of every kernel in the profiled run, the device's busy
and idle share of that run's wall, and the kernels by device time, then
the card's name and power limit as nvidia-smi prints them. With --out, the
profiled runs' Chrome traces are written there.
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


#: the compressor of each --compression choice
COMPRESSIONS = {"none": None,
                "topk": {"kind": "topk", "params": {"keep": 0.25}},
                "randk": {"kind": "randk", "params": {"keep": 0.25}},
                "int8": {"kind": "int8", "params": {}}}


def _spec(compression: str):
    import repro_torch

    return repro_torch.ExperimentSpec(
        name="dense_full", T=300, eval_every=25, r=0.01,
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 256, "d": 4096, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        compression=COMPRESSIONS[compression],
        backends=[{"kind": "dense", "params": {}}])


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise AttributeError("profiler event has no device time field")


def profile_mix(mix: str, compression: str,
                out_dir: pathlib.Path | None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch

    spec = _spec(compression)
    backend = repro_torch.ComponentSpec("dense", {"mix": mix})
    walls = []
    for _ in range(2):
        result = repro_torch.run(spec, backend, device="cuda")
        walls.append(result.metrics.execute_s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        repro_torch.run(spec, backend, device="cuda")
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": ev.key[:80], "calls": ev.count,
                            "device_us": _device_us(ev)})
    kernels.sort(key=lambda k: -k["device_us"])
    busy_s = sum(k["device_us"] for k in kernels) * 1e-6
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(out_dir / f"dense_full_{compression}_{mix}.json"))
    return {"mix": mix, "compression": compression, "T": spec.T,
            "execute_s": walls[-1],
            "us_per_iter": walls[-1] / spec.T * 1e6,
            "profiled_wall_s": profiled_wall, "device_busy_s": busy_s,
            "busy_share": busy_s / profiled_wall,
            "idle_share": 1.0 - busy_s / profiled_wall,
            "kernel_launches": sum(k["calls"] for k in kernels),
            "kernels": kernels[:12]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compression", choices=sorted(COMPRESSIONS),
                    default="none", help="the cell's compressor")
    ap.add_argument("--out", default=None,
                    help="directory for the profiled runs' Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_dense: no CUDA device", file=sys.stderr)
        return 1
    out_dir = pathlib.Path(args.out) if args.out else None
    for mix in ("sparse", "dense"):
        print(json.dumps(profile_mix(mix, args.compression, out_dir)),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
