"""Where the time goes in the PyTorch port's full-size dense cell, on one
CUDA card.

    PYTHONPATH=src python3 scripts/profile_torch_dense.py \
        [--compression {none,topk,randk,int8}] [--out DIR]

Runs the cell chip_smoke.py drives (quadratic consensus, n=256, d=4096,
expander k=4, periodic h=2, T=300, eval_every=25, sqrt(A=0.5), r=0.01),
uncompressed or under one compressor (top-k and rand-k at keep 1/4, the
compression axis of benchmarks/bench_compress.py, or deterministic int8),
through `repro_torch.run` on the card: for each mix (the sparse mix, K1 or
under a sparsifier K2, and the dense P @ z matmul) captured as CUDA graphs
(loop="scan") and as the eager host loop (loop="segment"); then the cell
swept over h in (1, 2, 4, 8, 16) on the sparse mix, as one batched program
of five lanes (`run_sweep(parallel="vmap")`) and as five serial runs, at
full width and at BENCH_dense.json's equivalence width (n=64, d=256).
Each is run twice unprofiled (the second is the number kept), once with a
CUDA event pair around each graph replay, then once under
`torch.profiler` with CPU and CUDA activities.

It prints one JSON line per row with the unprofiled wall per iteration
(execute_s / T, summed over a sweep's cells), the summed device time of
every kernel in the profiled run, the device's busy and idle share of
that run's wall (which includes building the simulator and capturing it)
and of its execute window (`execute_idle_share`: the replays and the
readback; the busy time counts the capture's warm-up too, about one
percent of a run), the kernels by device time, and the mix kernel's
launches two ways: as the wrappers count them (derived from the graphs'
replays in a captured run) and as the profiler names them (`mix_kernel_
profiled`; 0 where the profiler does not show the kernels a graph
replays). For a captured row, the event run gives a second idle share
measured within one run (`replay_idle_share`: 1 - the device time from
each replay's start event to its end event, summed, over that run's
execute_s; a pair's span also holds the graph launch's own latency), with
that run's wall per iteration (`replay_us_per_iter`), since both the events
and the profiler add host time to each replay. Then the card's name and
power limit as nvidia-smi prints them.
With --out, the profiled runs' Chrome traces are written there.
"""

from __future__ import annotations

import argparse
import contextlib
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
#: the sweep rows' axis: the comm period h of Fig. 2
SWEEP_AXIS, SWEEP_VALUES = "schedule.params.h", [1, 2, 4, 8, 16]


#: (n, d) of the full-size cell and of BENCH_dense.json's equivalence size
WIDTHS = {"full": (256, 4096), "small": (64, 256)}


def _spec(compression: str, width: str = "full"):
    import repro_torch

    n, d = WIDTHS[width]
    return repro_torch.ExperimentSpec(
        name="dense_full", T=300, eval_every=25, r=0.01,
        problem={"kind": "quadratic_consensus",
                 "params": {"n": n, "d": d, "seed": 0}},
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


def _mix_launches() -> int:
    from repro_torch.kernels import compress_mix, gossip_mix

    return gossip_mix.LAUNCHES + compress_mix.LAUNCHES


@contextlib.contextmanager
def _replay_events():
    """While open, record a CUDA event pair around each graph replay of the
    run program; yields the list of (start, end) pairs."""
    import torch

    from repro_torch.core import dda

    pairs = []
    step = dda._LaneProgram.step

    def recorded(prog, name):
        if prog.graphs is None:
            return step(prog, name)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(prog, name)
        end.record()
        pairs.append((start, end))

    dda._LaneProgram.step = recorded
    try:
        yield pairs
    finally:
        dda._LaneProgram.step = step


def profile_row(label: dict, call, T: int,
                out_dir: pathlib.Path | None) -> dict:
    """`call()` (returning a list of RunResults) twice unprofiled, once
    with events around each replay, then once profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        results = call()
    torch.cuda.synchronize()
    with _replay_events() as pairs:
        evented = call()
        torch.cuda.synchronize()
    evented_execute = sum(r.metrics.execute_s for r in evented)
    replay_busy_s = sum(a.elapsed_time(b) for a, b in pairs) * 1e-3
    launches = _mix_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = call()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    profiled_execute = sum(r.metrics.execute_s for r in profiled)
    launches = _mix_launches() - launches
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": ev.key[:80], "calls": ev.count,
                            "device_us": _device_us(ev)})
    kernels.sort(key=lambda k: -k["device_us"])
    busy_s = sum(k["device_us"] for k in kernels) * 1e-6
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_dir / (
            "dense_full_" + "_".join(str(v) for v in label.values())
            + ".json")))
    execute_s = sum(r.metrics.execute_s for r in results)
    return {**label, "T": T, "cells": len(results),
            "loops": sorted({r.metrics.notes["loop"] for r in results}),
            "execute_s": execute_s,
            "compile_s": sum(r.metrics.compile_s for r in results),
            "us_per_iter": execute_s / T * 1e6,
            "profiled_wall_s": profiled_wall, "device_busy_s": busy_s,
            "busy_share": busy_s / profiled_wall,
            "idle_share": 1.0 - busy_s / profiled_wall,
            "profiled_execute_s": profiled_execute,
            "execute_idle_share": 1.0 - busy_s / profiled_execute,
            "replays": len(pairs),
            "replay_busy_s": replay_busy_s if pairs else None,
            "replay_us_per_iter": evented_execute / T * 1e6,
            "replay_idle_share": (1.0 - replay_busy_s / evented_execute
                                  if pairs else None),
            "mix_kernel_launches": launches,
            "mix_kernel_profiled": sum(
                k["calls"] for k in kernels
                if "gossip_mix" in k["name"] or "compress_mix" in k["name"]),
            "kernel_launches": sum(k["calls"] for k in kernels),
            "kernels": kernels[:12]}


def main(argv=None) -> int:
    import torch

    import repro_torch

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
    spec = _spec(args.compression)
    for mix in ("sparse", "dense"):
        for loop in ("scan", "segment"):
            backend = repro_torch.ComponentSpec(
                "dense", {"mix": mix, "loop": loop})
            print(json.dumps(profile_row(
                {"compression": args.compression, "mix": mix, "loop": loop},
                lambda: [repro_torch.run(spec, backend, device="cuda")],
                spec.T, out_dir)), flush=True)
    for width in WIDTHS:
        sweep_spec = _spec(args.compression, width)
        for parallel in ("vmap", "serial"):
            print(json.dumps(profile_row(
                {"compression": args.compression, "mix": "sparse",
                 "width": width, "sweep": parallel},
                lambda: repro_torch.run_sweep(
                    sweep_spec, SWEEP_AXIS, SWEEP_VALUES, parallel=parallel,
                    device="cuda"),
                spec.T, out_dir)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
