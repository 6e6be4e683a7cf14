#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's `nvcc`; imports nothing of JAX or of the JAX package. Each
phase prints one JSON line; any failure raises, so the exit code is
non-zero and the last line is not printed. The phases:

  env       card, power limit, torch/CUDA versions; float32 matmuls must
            run at "highest" precision (the dense P @ z stays full fp32)
  build     builds every kernel of the main path from src/repro_torch/
            kernels/csrc (one nvcc per source, all at once) and prints the
            compiler's register/spill report
  kernel    K1 against its plain PyTorch version on the card over a grid
            of shapes, weights, messages and dtypes (fp32: rtol 1e-5,
            atol 1e-6; bf16: rtol 2e-2, atol 1e-5), then its time at the
            main path's shape beside the plain version, torch.matmul with
            the n x n mixing matrix (a yardstick the port never calls) and
            the bound
  manifests benchmarks/manifests/expander_{periodic,sparse}.json through
            repro_torch.run on the card and on the CPU; the two results
            must agree under convert.assert_results_match
  main_path the full-size dense cell of benchmarks/bench_dense.py (n=256,
            d=4096, expander k=4, periodic h=2, T=300) through
            repro_torch.run with every launch count set to 0 just before:
            it must take the sparse mix, launch K1 exactly once per
            communication round (149), and agree with its mix="dense" twin

Then one JSON line with every kernel's numbers, the card's name and power
limit as nvidia-smi prints them, and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=1e-5)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _median_window_ms(run_window, reps: int, inner: int) -> float:
    import torch

    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_window()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def time_ms(fn, reps: int = 25, inner: int = 20) -> dict:
    """Per-call time of `fn` in ms, the median over `reps` CUDA-event
    windows of `inner` calls each, after a warm-up, two ways:

      device: the `inner` calls captured once in a CUDA graph and the graph
              replayed, so the window holds the device work back to back
              without the host's launch overhead between calls;
      eager:  the calls issued from Python, as the main path issues them
              (host-bound when the wrapper costs more than the kernel).
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def eager_window():
        for _ in range(inner):
            fn()

    eager = _median_window_ms(eager_window, reps, inner)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _median_window_ms(graph.replay, reps, inner)
    del graph
    return {"device": device, "eager": eager}


def phase_env() -> dict:
    import torch

    smi = nvidia_smi_line()
    precision = torch.get_float32_matmul_precision()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), matmul_precision=precision,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 matmuls are not at full precision; the "
                           "dense P @ z must not run in TF32")
    return {"nvidia_smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build(build.SOURCES)
    for name in build.SOURCES:
        build.load(name)
    wall = time.perf_counter() - t0
    ptxas = {}
    for name in build.SOURCES:
        log = build.library_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, wall_s=wall, ptxas=ptxas)


def _mix_inputs(gen, n, M, k, dtype, vector_weights, with_msg):
    import torch

    dev = "cuda"
    z = torch.randn((n, M), generator=gen, device=dev).to(dtype)
    msg = (torch.randn((n, M), generator=gen, device=dev).to(dtype)
           if with_msg else None)
    S_in = torch.randint(0, n, (n, k), generator=gen, device=dev)
    if vector_weights:
        w_self = torch.rand((n,), generator=gen, device=dev) * 0.5 + 0.2
        w_edge = torch.rand((n, k), generator=gen, device=dev) * 0.3
    else:
        w_self, w_edge = 0.2, 0.8 / k
    return z, S_in, w_self, w_edge, msg


def phase_kernel() -> dict:
    """K1 against its plain version on the card, then its times."""
    import torch

    from repro_torch.kernels import gossip_mix, ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    checked = 0
    for n in (7, 12, 256, 1024):
        for M in (1, 130, 257, 4096, 65536):
            for k in (1, 4, 8):
                for dtype, tol in ((torch.float32, FP32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    for vector_weights in (False, True):
                        for with_msg in (False, True):
                            args = _mix_inputs(gen, n, M, k, dtype,
                                               vector_weights, with_msg)
                            z, S_in, w_self, w_edge, msg = args
                            out = ops.gossip_gather_mix_impl(
                                z, S_in, w_self, w_edge, msg=msg)
                            expect = ref.gossip_gather_mix_ref(
                                z, S_in, w_self, w_edge, msg=msg)
                            torch.cuda.synchronize()
                            err = (out.float() - expect.float()).abs()
                            worst[str(dtype).split(".")[1]] = max(
                                worst[str(dtype).split(".")[1]],
                                float(err.max()))
                            if out.dtype != dtype or out.shape != z.shape:
                                raise AssertionError(
                                    f"K1 returned {out.dtype} {out.shape} "
                                    f"for {dtype} {tuple(z.shape)}")
                            torch.testing.assert_close(
                                out.float(), expect.float(), **tol,
                                msg=lambda m: (f"K1 disagrees at n={n} "
                                               f"M={M} k={k} {dtype} "
                                               f"vector={vector_weights} "
                                               f"msg={with_msg}: {m}"))
                            checked += 1
    emit("kernel_check", name="gossip_mix", cases=checked,
         max_abs_err=worst, fp32_tol=FP32_TOL, bf16_tol=BF16_TOL)

    # the main path's call: n=256, M=4096, k=4, fp32, uniform weights
    n, M, k = 256, 4096, 4
    from repro_torch.core.graphs import kregular_expander

    g = kregular_expander(n, k=k, seed=0)
    S_in = torch.as_tensor([list(p) for p in g.perms], device="cuda").T \
        .contiguous()
    z = torch.randn((n, M), generator=gen, device="cuda")
    ws, we = float(g.self_weight), float(g.edge_weight)
    w_self = torch.full((n,), ws, device="cuda")
    w_edge = torch.full((n, k), we, device="cuda")
    P = torch.as_tensor(g.mixing_matrix(), dtype=torch.float32,
                        device="cuda")
    out = gossip_mix.gossip_mix_weighted(z, S_in, w_self, w_edge)
    expect = ref.gossip_gather_mix_ref(z, S_in, ws, we)
    torch.cuda.synchronize()
    max_abs_err = float((out - expect).abs().max())
    torch.testing.assert_close(out, expect, **FP32_TOL)
    torch.testing.assert_close(out, P @ z, **FP32_TOL)
    kernel_t = time_ms(
        lambda: gossip_mix.gossip_mix_weighted(z, S_in, w_self, w_edge))
    plain_t = time_ms(lambda: ref.gossip_gather_mix_ref(z, S_in, ws, we))
    library_t = time_ms(lambda: torch.matmul(P, z))
    # each input read once, the output written once: z, S_in, the weight
    # vectors the kernel reads, out
    nbytes = (2 * n * M * 4 + S_in.numel() * 8 + w_self.numel() * 4
              + w_edge.numel() * 4)
    flops = (2 * k + 1) * n * M
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    numbers = dict(name="gossip_mix", route="cuda",
                   source="src/repro_torch/kernels/csrc/gossip_mix.cu",
                   replaces="src/repro/kernels/gossip_mix.py:88",
                   max_abs_err=max_abs_err, ms=kernel_t["device"],
                   plain_ms=plain_t["device"],
                   bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   library_ms=library_t["device"])
    emit("kernel_time", shape={"n": n, "M": M, "k": k, "dtype": "float32"},
         bytes=nbytes, flops=flops, kernel_ms=kernel_t["device"],
         eager_ms=kernel_t["eager"],
         plain_eager_ms=plain_t["eager"], library_eager_ms=library_t["eager"],
         **numbers)
    return numbers


def phase_manifests() -> None:
    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.kernels import gossip_mix

    for name in ("expander_periodic", "expander_sparse"):
        spec = repro_torch.ExperimentSpec.from_file(
            ROOT / "benchmarks" / "manifests" / f"{name}.json")
        before = gossip_mix.LAUNCHES
        on_card = repro_torch.run(spec, "dense", device="cuda")
        launches = gossip_mix.LAUNCHES - before
        on_cpu = repro_torch.run(spec, "dense", device="cpu")
        card, cpu = on_card.to_dict(), on_cpu.to_dict()
        assert_results_match(card, cpu)
        if launches != card["trace"]["comms"][-1]:
            raise AssertionError(f"{name}: {launches} K1 launches for "
                                 f"{card['trace']['comms'][-1]} rounds")
        emit("manifest", name=name, mix_mode=card["extras"]["mix_mode"],
             launches=launches, final_f_card=card["trace"]["fvals"][-1],
             final_f_cpu=cpu["trace"]["fvals"][-1],
             time_to_target=card["time_to_target"])


def phase_main_path() -> int:
    """The full-size dense cell, with the launch counts read around it."""
    import math

    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.core.schedules import Periodic
    from repro_torch.kernels import gossip_mix

    spec = repro_torch.ExperimentSpec(
        name="dense_full", T=300, eval_every=25, r=0.01,
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 256, "d": 4096, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        backends=[{"kind": "dense", "params": {}}])
    gossip_mix.LAUNCHES = 0
    result = repro_torch.run(spec, device="cuda")
    launches = gossip_mix.LAUNCHES
    d = result.to_dict()
    trace = d["trace"]
    rounds = trace["comms"][-1]
    if d["extras"]["mix_mode"] != "sparse":
        raise AssertionError(f"main path mixed {d['extras']['mix_mode']}")
    # eq. 19: H_T = floor((T - 1) / h) rounds, 149 at T=300, h=2
    expected = Periodic(h=2).H(spec.T)
    if launches != rounds or rounds != expected:
        raise AssertionError(f"{launches} K1 launches for {rounds} rounds "
                             f"(expected {expected})")
    if len(trace["fvals"]) != spec.T // spec.eval_every or not all(
            v is not None and math.isfinite(v) for v in trace["fvals"]):
        raise AssertionError(f"main path trace malformed: {trace['fvals']}")
    twin = repro_torch.run(
        spec, repro_torch.ComponentSpec("dense", {"mix": "dense"}),
        device="cuda")
    twin_d = twin.to_dict()
    if twin_d["extras"]["mix_mode"] != "dense":
        raise AssertionError("the mix='dense' twin did not mix dense")
    # the twin differs by construction only in its backend params and the
    # mix mode it reports; everything the run computed must agree
    twin_d["backend"], twin_d["extras"] = d["backend"], d["extras"]
    assert_results_match(d, twin_d)
    m = result.metrics
    emit("main_path", launches=launches, rounds=rounds,
         mix_mode=d["extras"]["mix_mode"], compile_s=m.compile_s,
         execute_s=m.execute_s, wall_s=result.wall_s,
         us_per_iter=m.execute_s / spec.T * 1e6,
         twin_execute_s=twin.metrics.execute_s,
         twin_us_per_iter=twin.metrics.execute_s / spec.T * 1e6,
         final_f=trace["fvals"][-1], twin_final_f=twin_d["trace"]["fvals"][-1])
    return launches


def main() -> int:
    import repro_torch  # noqa: F401  (fails outside a checkout)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    env = phase_env()
    phase_build()
    k1 = phase_kernel()
    phase_manifests()
    k1["launches"] = phase_main_path()
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
