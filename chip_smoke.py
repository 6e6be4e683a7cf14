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
  kernel    K1 (gossip mix) against its plain PyTorch version on the card
            over a grid of shapes, weights, messages and dtypes (fp32:
            rtol 1e-5, atol 1e-6; bf16: rtol 2e-2, atol 1e-5), then its
            time at the main path's shape beside the plain version,
            torch.matmul with the n x n mixing matrix (a yardstick the port
            never calls) and the bound
  kernel K2 K2 (compress-mix) the same way over the same grid with mask
            densities 0, 1/8 and 1 (an all-ones mask must give K1's result
            bit for bit), then its time at the main path's shape with a
            top-k mask at keep 1/4, beside the plain version and the
            reference's dense compressed branch P_diag z + P_off (msg*mask)
  manifests benchmarks/manifests/expander_{periodic,sparse}.json and the
            dense backend of compressed_expander.json through
            repro_torch.run on the card and on the CPU; the two results
            must agree under convert.assert_results_match, and the run's
            kernel must launch once per communication round
  main_path the full-size dense cell of benchmarks/bench_dense.py (n=256,
            d=4096, expander k=4, periodic h=2, T=300) through
            repro_torch.run with every launch count set to 0 just before:
            it must take the sparse mix, launch K1 exactly once per
            communication round (149), and agree with its mix="dense" twin
  main_path_compressed
            the same cell under top-k and rand-k (keep 1/4, the compression
            axis of benchmarks/bench_compress.py) and deterministic int8,
            each with every launch count set to 0 just before: the sparse
            mix must launch K2 (top-k, rand-k) or K1 (int8) exactly 149
            times and the other kernel never, the residual norms must be
            finite and nonzero, and the run must agree with its
            mix="dense" twin within the tolerance stated for its
            compressor (TWIN_TOL), the flipped message entries between the
            two runs counted in lockstep; one rand-k mask at this shape
            must be bitwise equal on the card and on the CPU

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
#: the rtol a compressed full-size run is held to against its mix="dense"
#: twin, by compressor (atol 1e-6 throughout): "fvals" for fvals and
#: fvals_consensus, "state" for disagreement and the residual norms. Top-k
#: and int8 are discontinuous: a rounding difference between K2/K1 and
#: cuBLAS near a top-k threshold or an int8 rounding boundary flips a
#: transmitted entry, and the runs drift apart from there; the objective
#: stays close, the state statistics less so. Rand-k's support is a
#: function of (seed, t) alone and does not flip. The measured errors and
#: flip counts are in PERF.md.
TWIN_TOL = {"topk": {"fvals": 5e-5, "state": 5e-2},
            "randk": {"fvals": 1e-5, "state": 1e-5},
            "int8": {"fvals": 1e-5, "state": 1e-2}}


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


def _dense_cell_spec(compression=None):
    """The full-size dense cell of benchmarks/bench_dense.py (:154-157)."""
    import repro_torch

    return repro_torch.ExperimentSpec(
        name="dense_full", T=300, eval_every=25, r=0.01,
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 256, "d": 4096, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        compression=compression,
        backends=[{"kind": "dense", "params": {}}])


def _launch_counts() -> dict:
    from repro_torch.kernels import compress_mix, gossip_mix

    return {"gossip_mix": gossip_mix.LAUNCHES,
            "compress_mix": compress_mix.LAUNCHES}


def _zero_launch_counts() -> None:
    from repro_torch.kernels import compress_mix, gossip_mix

    gossip_mix.LAUNCHES = 0
    compress_mix.LAUNCHES = 0


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


def phase_kernel_k2() -> dict:
    """K2 against its plain version on the card, then its times."""
    import torch

    from repro_torch.compress import topk_mask_torch
    from repro_torch.kernels import compress_mix, gossip_mix, ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    checked = 0
    ones_checked = 0
    for n in (7, 12, 256, 1024):
        for M in (1, 130, 257, 4096, 65536):
            for k in (1, 4, 8):
                for dtype, tol in ((torch.float32, FP32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    for vector_weights in (False, True):
                        z, S_in, w_self, w_edge, msg = _mix_inputs(
                            gen, n, M, k, dtype, vector_weights, True)
                        for density in (0.0, 0.125, 1.0):
                            mask = (torch.rand((n, M), generator=gen,
                                               device="cuda")
                                    < density).to(dtype)
                            out = ops.compress_mix_impl(
                                z, msg, mask, S_in, w_self, w_edge)
                            expect = ref.compress_mix_ref(
                                z, msg, mask, S_in, w_self, w_edge)
                            torch.cuda.synchronize()
                            key = str(dtype).split(".")[1]
                            worst[key] = max(worst[key], float(
                                (out.float() - expect.float()).abs().max()))
                            if out.dtype != dtype or out.shape != z.shape:
                                raise AssertionError(
                                    f"K2 returned {out.dtype} {out.shape} "
                                    f"for {dtype} {tuple(z.shape)}")
                            torch.testing.assert_close(
                                out.float(), expect.float(), **tol,
                                msg=lambda m: (f"K2 disagrees at n={n} "
                                               f"M={M} k={k} {dtype} "
                                               f"vector={vector_weights} "
                                               f"density={density}: {m}"))
                            checked += 1
                            if density == 1.0:
                                k1 = ops.gossip_gather_mix_impl(
                                    z, S_in, w_self, w_edge, msg=msg)
                                if not torch.equal(out, k1):
                                    raise AssertionError(
                                        f"K2 with an all-ones mask differs "
                                        f"from K1 with msg at n={n} M={M} "
                                        f"k={k} {dtype}")
                                ones_checked += 1
    emit("kernel_check", name="compress_mix", cases=checked,
         all_ones_equal_k1=ones_checked, max_abs_err=worst,
         fp32_tol=FP32_TOL, bf16_tol=BF16_TOL)

    # the main path's call: n=256, M=4096, k=4, fp32, uniform weights, a
    # top-k support at keep 1/4 of the corrected messages
    n, M, k = 256, 4096, 4
    from repro_torch.core.graphs import kregular_expander

    g = kregular_expander(n, k=k, seed=0)
    S_in = torch.as_tensor([list(p) for p in g.perms], device="cuda").T \
        .contiguous()
    z = torch.randn((n, M), generator=gen, device="cuda")
    msg = z + 0.1 * torch.randn((n, M), generator=gen, device="cuda")
    mask = topk_mask_torch(msg, M // 4)
    ws, we = float(g.self_weight), float(g.edge_weight)
    w_self = torch.full((n,), ws, device="cuda")
    w_edge = torch.full((n, k), we, device="cuda")
    P = torch.as_tensor(g.mixing_matrix(), dtype=torch.float32,
                        device="cuda")
    P_diag = torch.diagonal(P).clone()
    P_off = P - torch.diag(P_diag)
    out = compress_mix.compress_mix_weighted(z, msg, mask, S_in, w_self,
                                             w_edge)
    expect = ref.compress_mix_ref(z, msg, mask, S_in, ws, we)
    torch.cuda.synchronize()
    max_abs_err = float((out - expect).abs().max())
    torch.testing.assert_close(out, expect, **FP32_TOL)
    torch.testing.assert_close(out, P_diag[:, None] * z + P_off @ (msg * mask),
                               **FP32_TOL)
    kernel_t = time_ms(lambda: compress_mix.compress_mix_weighted(
        z, msg, mask, S_in, w_self, w_edge))
    plain_t = time_ms(lambda: ref.compress_mix_ref(z, msg, mask, S_in, ws,
                                                   we))
    library_t = time_ms(lambda: P_diag[:, None] * z + P_off @ (msg * mask))
    # each input read once, the output written once: z, msg, mask, out,
    # S_in and the weight vectors the kernel reads
    nbytes = (4 * n * M * 4 + S_in.numel() * 8 + w_self.numel() * 4
              + w_edge.numel() * 4)
    flops = (3 * k + 1) * n * M
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    numbers = dict(name="compress_mix", route="cuda",
                   source="src/repro_torch/kernels/csrc/compress_mix.cu",
                   replaces="src/repro/kernels/compress_mix.py:47",
                   max_abs_err=max_abs_err, ms=kernel_t["device"],
                   plain_ms=plain_t["device"],
                   bound_ms=max(bytes_ms, flops_ms),
                   bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                   library_ms=library_t["device"])
    emit("kernel_time", shape={"n": n, "M": M, "k": k, "dtype": "float32",
                               "mask": "top-k, keep 1/4"},
         bytes=nbytes, flops=flops, kernel_ms=kernel_t["device"],
         eager_ms=kernel_t["eager"],
         plain_eager_ms=plain_t["eager"], library_eager_ms=library_t["eager"],
         library_call="P_diag[:, None] * z + P_off @ (msg * mask): three "
                      "calls (two products and a sum around one matmul); no "
                      "single PyTorch call computes K2's function",
         **numbers)
    return numbers


def phase_manifests() -> None:
    import repro_torch
    from repro_torch.convert import assert_results_match

    for name in ("expander_periodic", "expander_sparse",
                 "compressed_expander"):
        spec = repro_torch.ExperimentSpec.from_file(
            ROOT / "benchmarks" / "manifests" / f"{name}.json")
        kernel = "gossip_mix" if spec.compression is None else "compress_mix"
        before = _launch_counts()
        on_card = repro_torch.run(spec, "dense", device="cuda")
        after = _launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        on_cpu = repro_torch.run(spec, "dense", device="cpu")
        card, cpu = on_card.to_dict(), on_cpu.to_dict()
        assert_results_match(card, cpu)
        rounds = card["trace"]["comms"][-1]
        if launches[kernel] != rounds or sum(launches.values()) != rounds:
            raise AssertionError(f"{name}: launches {launches} for "
                                 f"{rounds} rounds of {kernel}")
        emit("manifest", name=name, mix_mode=card["extras"]["mix_mode"],
             kernel=kernel, launches=launches[kernel],
             final_f_card=card["trace"]["fvals"][-1],
             final_f_cpu=cpu["trace"]["fvals"][-1],
             time_to_target=card["time_to_target"])


def phase_main_path() -> int:
    """The full-size dense cell, with the launch counts read around it."""
    import math

    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.core.schedules import Periodic

    spec = _dense_cell_spec()
    _zero_launch_counts()
    result = repro_torch.run(spec, device="cuda")
    counts = _launch_counts()
    launches = counts["gossip_mix"]
    if counts["compress_mix"]:
        raise AssertionError(f"the uncompressed cell launched K2: {counts}")
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


def _flipped_entries(spec) -> dict:
    """The full-size compressed cell and its mix="dense" twin run side by
    side, one iteration at a time: at every communication round, the
    entries whose transmitted code differs between the two runs (a support
    entry of a sparsifier, an int8 code). Returns the first round that
    differs, how many entries flipped there, and the totals over the run:
    after the first flip the runs drift apart and later flips follow from
    it."""
    import numpy as np
    import torch

    from repro_torch.compress import build_compressor
    from repro_torch.core.dda import DDASimulator
    from repro_torch.experiments import components as C

    dev = torch.device("cuda")
    problem = C.build_component(C.problems, spec.problem.kind,
                                spec.problem.params, device=dev)
    graph = C.build_component(C.topologies, spec.topology.kind,
                              spec.topology.params, n=problem.n)
    comp = build_compressor(spec.compression.kind,
                            dict(spec.compression.params))
    sims = [DDASimulator(
        problem.subgrad_stack, problem.objective, graph,
        C.build_component(C.schedules, spec.schedule.kind,
                          spec.schedule.params),
        a_fn=C.build_component(C.stepsizes, spec.stepsize.kind,
                               spec.stepsize.params),
        r=spec.r, compression=comp, mix=mix,
        projection=problem.projection, device=dev)
        for mix in ("sparse", "dense")]
    mask = np.asarray(sims[0].schedule.comm_mask(0, spec.T), dtype=bool)
    zeros = torch.zeros((problem.n, problem.d), device=dev)
    states = [(zeros, zeros, zeros, zeros,
               torch.zeros((), device=dev)) for _ in sims]
    codes = (comp.support_mask_torch if comp.is_sparsifier
             else lambda c, t: comp.codes_torch(c, t)[0])
    first, total, rounds_with = None, 0, 0
    for i in range(spec.T):
        if mask[i]:
            a, b = (codes(s[0] + s[3], s[4]) for s in states)
            flips = int((a != b).sum())
            total += flips
            rounds_with += flips > 0
            if flips and first is None:
                first = {"iteration": i + 1, "entries": flips}
        states = [sim._segment(*s, mask[i:i + 1])
                  for sim, s in zip(sims, states)]
    return {"first_flip": first, "flipped_entries": total,
            "rounds_with_flips": rounds_with}


def _allclose(ours, theirs, rtol: float) -> bool:
    import numpy as np

    return len(ours) == len(theirs) and bool(np.allclose(
        np.array(ours, np.float64), np.array(theirs, np.float64), rtol=rtol,
        atol=FP32_TOL["atol"]))


def _max_rel_err(ours, theirs) -> float:
    import numpy as np

    a = np.array([np.nan if v is None else v for v in ours], np.float64)
    b = np.array([np.nan if v is None else v for v in theirs], np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def phase_main_path_compressed() -> int:
    """The full-size cell under top-k, rand-k and int8, each with the
    launch counts read around it and held against its dense twin.
    Returns K2's launches in the top-k run."""
    import math

    import torch

    import repro_torch
    from repro_torch.compress import RandK
    from repro_torch.convert import assert_results_match

    k2_launches = None
    for kind, params, kernel in (
            ("topk", {"keep": 0.25}, "compress_mix"),
            ("randk", {"keep": 0.25}, "compress_mix"),
            ("int8", {}, "gossip_mix")):
        spec = _dense_cell_spec({"kind": kind, "params": params})
        _zero_launch_counts()
        result = repro_torch.run(spec, device="cuda")
        counts = _launch_counts()
        d = result.to_dict()
        rounds = d["trace"]["comms"][-1]
        other = [k for k in counts if k != kernel][0]
        if d["extras"]["mix_mode"] != "sparse":
            raise AssertionError(f"{kind}: mixed {d['extras']['mix_mode']}")
        if counts[kernel] != 149 or rounds != 149 or counts[other] != 0:
            raise AssertionError(f"{kind}: launches {counts} for {rounds} "
                                 f"rounds (expected 149 of {kernel})")
        block = d["extras"]["compression"]
        norms = block["residual_norms"]
        if len(norms) != spec.T // spec.eval_every or not all(
                v is not None and math.isfinite(v) and v > 0
                for v in norms):
            raise AssertionError(f"{kind}: residual norms {norms}")
        if not all(v is not None and math.isfinite(v)
                   for v in d["trace"]["fvals"]):
            raise AssertionError(f"{kind}: trace {d['trace']['fvals']}")
        twin = repro_torch.run(
            spec, repro_torch.ComponentSpec("dense", {"mix": "dense"}),
            device="cuda")
        twin_d = twin.to_dict()
        if twin_d["extras"]["mix_mode"] != "dense":
            raise AssertionError("the mix='dense' twin did not mix dense")
        errors = {f: _max_rel_err(d["trace"][f], twin_d["trace"][f])
                  for f in ("fvals", "fvals_consensus", "disagreement")}
        errors["residual_norms"] = _max_rel_err(
            norms, twin_d["extras"]["compression"]["residual_norms"])
        flips = _flipped_entries(spec)
        m = result.metrics
        emit("main_path_compressed", compression=kind, params=params,
             kernel=kernel, launches=counts[kernel], rounds=rounds,
             mix_mode=d["extras"]["mix_mode"],
             wire_ratio=block["wire_ratio"], compile_s=m.compile_s,
             execute_s=m.execute_s,
             us_per_iter=m.execute_s / spec.T * 1e6,
             twin_us_per_iter=twin.metrics.execute_s / spec.T * 1e6,
             final_f=d["trace"]["fvals"][-1],
             twin_final_f=twin_d["trace"]["fvals"][-1],
             final_residual_norm=norms[-1], twin_max_rel_err=errors,
             twin_tol=TWIN_TOL[kind], **flips)
        # the twin differs by construction only in its backend params and
        # the mix mode it reports
        twin_d["backend"] = d["backend"]
        twin_d["extras"]["mix_mode"] = d["extras"]["mix_mode"]
        tol = TWIN_TOL[kind]
        assert_results_match(d, twin_d, rtol=tol["state"],
                             atol=FP32_TOL["atol"])
        for f in ("fvals", "fvals_consensus"):
            if not _allclose(d["trace"][f], twin_d["trace"][f],
                             tol["fvals"]):
                raise AssertionError(
                    f"{kind}: trace.{f} outside rtol={tol['fvals']} of the "
                    f"dense twin (max rel err {errors[f]})")
        if kind == "topk":
            k2_launches = counts[kernel]

    # one rand-k support at the full shape, on the card and on the CPU
    comp = RandK(keep=0.25, seed=0)
    t = torch.tensor(299.0)
    x = torch.randn((256, 4096))
    on_card = comp.support_mask_torch(x.cuda(), t.cuda()).cpu()
    on_cpu = comp.support_mask_torch(x, t)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("a rand-k mask differs between the card and "
                             "the CPU")
    emit("randk_mask", shape=[256, 4096], t=299, bitwise_equal=True,
         kept_per_row=int(on_cpu.sum(dim=-1)[0]))
    return k2_launches


def main() -> int:
    import repro_torch  # noqa: F401  (fails outside a checkout)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    env = phase_env()
    phase_build()
    k1 = phase_kernel()
    k2 = phase_kernel_k2()
    phase_manifests()
    k1["launches"] = phase_main_path()
    k2["launches"] = phase_main_path_compressed()
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
