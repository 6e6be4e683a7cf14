"""What sets the pace of kernels K5 (ssd_scan.cu, the SSD scan) and K6
(selective_scan.cu, the selective scan), pass by pass, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_torch_scans.py [--out DIR]

Cells (fp32, inputs drawn as chip_smoke.py draws them):

  K5 zamba2-2.7b      Bt=1, S=4096, H=80, P=64, N=64: chunk states, state
                      passing, chunk outputs (three kernels a call)
  K5 narrow           Bt=1, S=4096, H=2, P=32, N=16: few blocks a pass
  K6 falcon-mamba-7b  Bt=1, S=4096, d=8192, N=16: one piece, one kernel
  K6 narrow           Bt=1, S=4096, d=64, N=16: pieces, carry, outputs

For each cell: the call's time (CUDA-graph median, as chip_smoke.py's
`time_ms` takes it), then 20 eager calls under `torch.profiler`: each
kernel's device time a call, and the device's idle share of the wall. Each
kernel's time stands beside the floors that could set its pace:

  bytes    the bytes it must move (each array it reads or writes once) at
           3.35 TB/s
  sfu      its exps at 16 a clock an SM on 132 SMs at the card's maximum
           SM clock (nvidia-smi clocks.max.sm)
  tensor   its mma.sync products (3xTF32: three m16n8k8 a product) at the
           H100 data sheet's dense TF32 rate, 495 TFLOP/s

`pace` names the floor nearest the time when the time is within four
times it; else "launches" for a kernel of under 10 us (a launch and one
wave of blocks), "carry" for the passes that walk chunks or pieces in
order (the serial carry), and "latency" for the rest. One JSON line for
the clock and SFU rate, one per cell, then the card's name and power limit
as nvidia-smi prints them. With --out, each cell's Chrome trace is written
there.
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

#: H100 SXM data sheet: HBM bytes/s, dense TF32 tensor-core FLOP/s
HBM = 3.35e12
TF32_RATE = 495e12


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise AttributeError("profiler event has no device time field")


def _profile(fn, label, out_dir, calls=20) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"calls": ev.count,
                               "us_per_call": _device_us(ev) / calls}
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_dir / f"{label}.json"))
    busy = sum(k["us_per_call"] for k in kernels.values()) * calls * 1e-6
    return {"kernels": kernels, "wall_s": wall, "idle_share": 1 - busy / wall}


def _pace(us: float, floors: dict, serial: bool) -> str:
    best = max(floors, key=lambda k: floors[k])
    if floors[best] * 4 >= us:
        return best
    if us < 10:
        return "launches"
    return "carry" if serial else "latency"


def _match(kernels: dict, stem: str) -> float:
    """Device us a call of the kernels whose name contains `stem`."""
    return sum(k["us_per_call"] for name, k in kernels.items()
               if stem in name)


def k5_cell(label, Bt, S, H, P, N, sfu_rate, out_dir) -> dict:
    from chip_smoke import _scan_inputs, time_ms
    import torch

    from repro_torch.kernels import ops, ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _scan_inputs(gen, (Bt, S, H, P), (Bt, S, H), (H,), (Bt, S, N))
    ms = time_ms(lambda: ops.ssd_scan(*args), reps=10, inner=5)["device"]
    how = ssd_scan.plan(Bt, S, H, P, N, torch.cuda.get_device_properties(
        0).multi_processor_count)
    prof = _profile(lambda: ops.ssd_scan(*args), label.replace(" ", "_"),
                    out_dir)
    Q, nc = how["chunk"], how["chunks"]
    ws = 4 * Bt * H * nc * P * N
    xb, bb, yb = 4 * Bt * S * H * P, 4 * Bt * S * N, 4 * Bt * S * H * P
    heads = how["heads_per_block"]
    # products a (b, h, chunk), in multiply-adds: the state P N Q; the
    # carried term Q N P; the in-chunk term's lower triangle of 16-row
    # blocks Q P (Q/16 + 1) 8; C B^T once a head group, Q Q N / 2
    mac_state = Bt * H * nc * P * N * Q
    mac_out = Bt * H * nc * (Q * N * P + Q * P * (Q // 16 + 1) * 8) \
        + Bt * nc * -(-H // heads) * Q * Q * N // 2
    passes = {
        "ssd_chunk_state": {
            "bytes": xb + bb + ws + 4 * Bt * S * H,
            "exps": Bt * H * nc * Q, "macs": mac_state},
        "ssd_state_pass": {"bytes": 2 * ws, "exps": 0, "macs": 0,
                           "serial": True},
        "ssd_chunk_out": {
            "bytes": xb + 2 * bb + ws + yb + 4 * Bt * S * H,
            # the tables, the diagonal blocks' entries, exp(cum) by row
            "exps": Bt * H * nc * (Q * Q // 8 + Q + Q * 16 + Q),
            "macs": mac_out}}
    return _report(label, {"Bt": Bt, "S": S, "H": H, "P": P, "N": N}, how,
                   ms, prof, passes, sfu_rate)


def k6_cell(label, Bt, S, d, N, sfu_rate, out_dir) -> dict:
    from chip_smoke import _randn, _scan_inputs, time_ms
    import torch

    from repro_torch.kernels import ops, selective_scan

    gen = torch.Generator(device="cuda").manual_seed(6)
    args = _scan_inputs(gen, (Bt, S, d), (Bt, S, d), (d, N), (Bt, S, N)) \
        + (_randn(gen, (d,)),)
    ms = time_ms(lambda: ops.selective_scan(*args), reps=10,
                 inner=5)["device"]
    how = selective_scan.plan(Bt, S, d, N, torch.cuda.get_device_properties(
        0).multi_processor_count)
    prof = _profile(lambda: ops.selective_scan(*args),
                    label.replace(" ", "_"), out_dir)
    io = 4 * (2 * Bt * S * d + Bt * S * N + d * N)
    ws = 4 * Bt * how["nsplit"] * d * N
    last = S - (how["nsplit"] - 1) * how["piece"]
    passes = {"selective_scan_kernel<": {
        "bytes": io + 4 * (Bt * S * d + Bt * S * N + d) + ws,
        "exps": Bt * S * d * N, "macs": 0}}
    if how["nsplit"] > 1:
        passes = {
            "true>": passes["selective_scan_kernel<"],
            "false>": {"bytes": io + 2 * ws,
                       "exps": Bt * (S - last) * d * N, "macs": 0},
            "selective_scan_carry": {"bytes": 3 * ws, "exps": 0, "macs": 0,
                                     "serial": True}}
    return _report(label, {"Bt": Bt, "S": S, "d": d, "N": N}, how, ms, prof,
                   passes, sfu_rate)


def _report(label, shape, how, ms, prof, passes, sfu_rate) -> dict:
    rows = {}
    for stem, work in passes.items():
        us = _match(prof["kernels"], stem)
        floors = {"bytes": work["bytes"] / HBM * 1e6,
                  "sfu": work["exps"] / sfu_rate * 1e6,
                  "tensor": 3 * 2 * work["macs"] / TF32_RATE * 1e6}
        rows[stem] = {"us": us, "floors_us": floors,
                      "pace": _pace(us, floors, work.get("serial", False))}
    return {"cell": label, **shape, "plan": how, "ms": ms,
            "kernel_us_sum": sum(k["us_per_call"]
                                 for k in prof["kernels"].values()),
            "launches_per_call": sum(k["calls"]
                                     for k in prof["kernels"].values()) / 20,
            "idle_share_eager": prof["idle_share"], "passes": rows,
            "kernels": prof["kernels"]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the profiled runs' Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_scans: no CUDA device", file=sys.stderr)
        return 1
    out = pathlib.Path(args.out) if args.out else None
    sm_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_rate = 16 * sms * sm_mhz * 1e6
    print(json.dumps({"sm_clock_max_mhz": sm_mhz, "sms": sms,
                      "sfu_exps_per_s": sfu_rate,
                      "tf32_flops_per_s": TF32_RATE}), flush=True)
    for cell in (("K5 zamba2-2.7b", 1, 4096, 80, 64, 64),
                 ("K5 narrow", 1, 4096, 2, 32, 16)):
        print(json.dumps(k5_cell(*cell, sfu_rate, out)), flush=True)
        torch.cuda.empty_cache()
    for cell in (("K6 falcon-mamba-7b", 1, 4096, 8192, 16),
                 ("K6 narrow", 1, 4096, 64, 16)):
        print(json.dumps(k6_cell(*cell, sfu_rate, out)), flush=True)
        torch.cuda.empty_cache()
    print(_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
