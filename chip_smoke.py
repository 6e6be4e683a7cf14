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
            compiler's report for each kernel instantiation (registers,
            shared memory, stack and spills), its warnings and its
            performance remarks (wgmma serialized, fences injected)
  kernel    K1 (gossip mix) against its plain PyTorch version on the card
            over a grid of shapes, k in {1, 4, 8, 9}, weights, messages
            (none, its own tensor, a view not 16-byte aligned) and dtypes
            (fp32: rtol 1e-5, atol 1e-6; bf16: rtol 2e-2, atol 1e-5), each
            case on the kernel the library must pick (the slab kernel for
            16-byte packets, k <= 8 and n (k + 1) >= slab_min_reads(),
            else the register kernel), as it reports it
            (gossip_mix.FORM_LAUNCHES); then at
            the sweep's call (n=256, M=5 x 4096, k=4, fp32, the five
            lanes' carry as
            one state), on the slab kernel, each lane's columns equal to
            a one-lane call's bit for bit; then at the main path's
            call (n=256, M=4096, k=4, fp32, z seeded from numpy), which
            must launch the slab kernel, the sha256 of its output's bits
            (k1_digest) and its time beside the plain version,
            torch.matmul with the n x n mixing matrix (a yardstick the port
            never calls) and the bound; k1_digest must equal K1_DIGEST
  kernel K2 K2 (compress-mix) the same way over the same grid with mask
            densities 0, 1/8 and 1 (an all-ones mask must give K1's result
            bit for bit), then at the sweep's call (n=256, M=5 x 4096,
            k=4, fp32, a top-k mask at keep 1/4 drawn per node and lane),
            each lane's columns equal to a one-lane call's bit for bit;
            then its time at the main path's shape with a
            top-k mask at keep 1/4, beside the plain version and the
            reference's dense compressed branch P_diag z + P_off (msg*mask)
  manifests the dense backend of the seven manifests that declare one
            (benchmarks/manifests/: expander_periodic, expander_sparse,
            compressed_expander mix through K1 or K2; complete_every,
            fig1_complete, fig1_reduced, fig2_sparse through cuBLAS's
            P @ z) through repro_torch.run on the card and on the CPU; the
            two results must agree under convert.assert_results_match, the
            run's kernel must launch once per communication round (no hand
            kernel for the complete graphs), and the run must take the
            loop its problem declares ("graph", captured; "eager" for
            metric learning, whose eigh reads the card back). For the
            nonsmooth and metric-learning manifests, the card and CPU runs
            side by side count the discrete choices that differ (argmax
            picks, clamped eigenvalue signs: card_cpu_flips)
  main_path the full-size dense cell of benchmarks/bench_dense.py (n=256,
            d=4096, expander k=4, periodic h=2, T=300) through
            repro_torch.run with every launch count set to 0 just before:
            it must run captured as CUDA graphs (loop "graph"), take the
            sparse mix, launch K1's slab kernel exactly once per
            communication round (149, counted from the graphs' replays
            through repro_torch.kernels.counters), and agree with its
            mix="dense" twin; torch.profiler watches that run, and the K1
            kernels it names must be those 149 slab kernels, the
            capture's warm-up's 2 and its first replay's 1; the sha256 of
            its fvals and disagreement as float32 must equal
            MAIN_PATH_DIGEST, and so
            must an unprofiled captured run's and the eager
            loop="segment" run's; prints the wall per iteration of the
            unprofiled captured run, of the eager run (eager_ratio) and of
            its twin (twin_ratio: the host's noise falls on both alike)
  main_path_compressed
            the same cell under top-k and rand-k (keep 1/4, the compression
            axis of benchmarks/bench_compress.py) and deterministic int8,
            each with every launch count set to 0 just before, captured: the
            sparse mix must launch K2 (top-k, rand-k) or K1's slab kernel
            (int8) exactly 149 times and the other kernel never, the residual
            norms must be
            finite and nonzero, and the run must agree with its
            mix="dense" twin within the tolerance stated for its
            compressor (TWIN_TOL), the flipped message entries between the
            two runs counted in lockstep; one rand-k mask at this shape
            must be bitwise equal on the card and on the CPU
  sweep     the full-size cell swept over h in (1, 2, 4, 8, 16), the axis
            of the paper's Fig. 2, uncompressed (K1) and under top-k at
            keep 1/4 (K2): repro_torch.run_sweep(parallel="vmap") as one
            captured program of five lanes, with every launch count set to
            0 just before (one launch for each iteration at which any lane
            communicates: 299), then the five runs serially; each lane must
            equal its serial run, host fields exactly and device floats
            within SWEEP_RTOL (the bitwise equal entries are counted);
            prints the batched wall beside the serial walls' sum; then two
            cells with parallel="process" on the card, equal to serial bit
            for bit
  adaptive  the full-size cell under the paper's adaptive schedule
            (h0 = 1) and the "dense_adaptive" controller, uncompressed (K1)
            and under top-k at keep 1/4 (K2). First under an injected clock
            that charges each chunk eq. 9's cost at ADAPTIVE_R_TRUE (the
            closed loop's seam DDASimulator.run_chunk), on the card and
            on the CPU: the retunes, h_final and r_hat must be equal
            exactly (h must rise), the traces within FP32_TOL (top-k:
            TWIN_TOL), and the card's kernel must launch once a round.
            Then under the real clock on the card through repro_torch.run,
            every launch count set to 0 just before: captured (loop
            "graph"), K1 on its slab kernel (or K2) launched once for each
            round the loop chose; the controller's one plain sample (its
            first timed chunk, one idle iteration; the median of
            PLAIN_SAMPLE_RUNS runs) within PLAIN_SAMPLE_CAP of
            one-iteration idle chunks on a loaded program, and r_hat
            above 0 under top-k; prints r_hat, the plain samples, the
            captured run of the cell at h = 1 (periodic, no controller),
            the retunes, compile_s, the median iteration wall and the wall per
            iteration (a chunk is a run of iterations of one kind in a
            segment and ends in a device synchronize: at h = 1 one plain
            and one comm chunk in the first segment, one comm chunk in
            each other, and a statistics readback at each segment's end)
  netsim    every netsim backend of the six manifests that declare one
            through repro_torch.run (event loops in host numpy; the
            problem built on the card): finite traces, messages sent,
            drops where the scenario loses messages, retunes under the
            adaptive controller (adaptive_adversarial), a faults block
            under the churn plan (churn_adversarial), and the object and
            vectorized engines' traces equal bit for bit; prints each
            run's host wall and its trace's sha256 (not asserted: the CPU
            tests hold the bits against the reference). Then
            expander_periodic's cell on the vectorized engine with its
            gradients through netsim.torch_batch_grad on the card, beside
            the numpy gradients' run: the largest fvals difference
            (float32 against float64; relative 1e-4 at most)
  serve     the full-size cell served through repro_torch.serve, each
            served result held to a solo repro_torch.run of its spec
            exactly (comparable_result_dict), each request with every
            launch count set to 0 just before and read just after. In
            process (ExperimentServer, two threads): cold, then warm (a
            cache hit that captures nothing, compile_s under 1 ms); a
            packed lane of three requests (h 2, 4, 8; r 0.01, 0.02,
            0.04; seeds 0, 1, 2) at lane_width 3, K1 launched once for
            each iteration at which any lane communicates; the cell under
            top-k at keep 1/4 (K2); a netsim manifest run solo with its
            reason; a new signature captured beside a replay of the warm
            cell; one request over TCP through Client, its trace the solo
            run's. The in-process runs' launches must be their rounds
            (serve_launches). Then two worker processes, a ChaosPlan
            killing the first job's worker mid-run: every result exact,
            the job re-enqueued, no request executed twice. Prints cold
            and warm walls with compile_s, the packed wall beside the
            solo walls' sum, and the pool's first-job and warm-job walls
  lm        the launch backend (consensus LM training). First K1 at the
            LM launcher's call: the embed leaf of two full-width pods
            (bf16, n=2, k=1, M = 128256 x 4096) against its plain version
            bit for bit, timed beside it and torch.matmul with the 2 x 2
            mixing matrix, its bound from bytes read once and written
            once. Then `_sdpa_causal` at the cell's attention shapes (bf16,
            S = 4096: the streamed form) against the whole score-matrix
            form, output and gradients within ATTN_STREAM_RTOL. Then
            llama3-8b at full width (d_model 4096, 32 heads, 8 kv, d_ff
            14336, vocab 128256, bf16) with its 32 superblocks cut to
            LM_N_SUPER = 4, two pods stacked, S = 4096, T = 6, complete
            graph, periodic h=2, adamw, through repro_torch.run with every
            launch count set to 0 just before and read just after: losses
            finite, the pods bitwise equal after each mix, K1 launched 12
            times a comm step (24), the host fields' closed form,
            param_bytes 3,846,324,224, peak memory under LM_PEAK_CAP_GIB;
            prints K1's bound over a comm step's leaves (from the run's
            param_bytes), the step walls, the second fused step's device time by
            kind under torch.profiler, AdamW's by CUDA events, and
            attention and the loss timed alone at the cell's shapes. Then
            the smoke width at mesh (4, 1, 1), expander k=2, on the card
            and the CPU (host fields exact, losses within LM_TRACE_RTOL,
            the loss decreasing, K1 12 times a round) and the dry-run
            manifest, card against CPU
  lm_k1_expert_leaf
            K1 at deepseek-v2's routed-expert leaf of two full-width pods
            (bf16, n=2, k=1, M = 160 x 5120 x 1536 = 1,258,291,200) on
            the empty card, against its plain version bit for bit, on the
            register kernel alone; timed beside the plain version (eager:
            its float32 temporaries are about 50 GB a call) and
            torch.matmul with the 2 x 2 mixing matrix, its bound 3.005 ms
            from bytes read once and written once
  lm_moe_full
            deepseek-v2 at its published widths (d_model 5120, vocab
            102400, 128 heads of 128, MLA kv_lora 512, q_lora 1536, rope
            64, v 128; a dense prologue FFN of 12288; 160 routed experts
            at top-6 with 2 shared, expert d_ff 1536, capacity factor
            1.25; bf16) cut to its prologue layer and LM_MOE_N_SUPER = 1
            of its 59 MLA + MoE superblocks, two pods stacked, S = 4096,
            T = 6, complete graph, periodic h=2, SGD without momentum
            (AdamW's moments do not fit), through
            launch.train.train_consensus_lm with every launch count set
            to 0 just before and read just after: losses finite, the pods
            bitwise equal after each mix, K1 launched once a leaf (33) a
            comm step (66), all on its register kernel, param_bytes
            10,719,055,872, peak memory under LM_PEAK_CAP_GIB; prints the
            step walls, the peak, K1's time a comm step against its bound
            (12.80 ms, from the run's param_bytes), each MoE call's
            dropped assignments (in the overflow slot) out of 4096 x 6,
            and the second fused step's device time by kind (K1, SGD,
            matmuls, the MoE gathers, attention, the rest)
  lm_moe_smoke
            deepseek-v2 and llama4-maverick at smoke width through
            repro_torch.run at mesh (4, 1, 1), expander k=2, adamw, on
            the card and the CPU: host fields exact, losses within
            LM_MOE_TRACE_RTOL, K1 once a leaf a comm round; prints the
            router's top-K choices that differ between card and CPU
  kernel_k3 K3 (the flat per-node mix, `kernels.ops.gossip_mix`) against
            its plain version over M in {1, 3, 130, 4099, 8192, 65537,
            2^20} (and a misaligned view), k in {1, 4, 8}, fp32 and bf16
            (fp32: rtol 1e-5, atol 1e-6; bf16: rtol 2e-2, atol 1e-5); then
            the front door once at full width (one llama3-8b decoder
            layer's parameters flattened, M = 218,112,000, k = 4, fp32,
            sw = ew = 0.2) with every launch count set to 0 just before: it
            must launch K3 once and agree with the plain version; then its
            time beside the plain version, torch.addmv (a yardstick the
            port never calls) and the bound
  kernel_k4 K4 (`kernels.ops.flash_attention`) the same way, over
            tests/test_kernels.py's shapes, Sq != Sk (causal and not), MHA,
            GQA, MQA, ragged S, D in {16, 48, 80, 96, 160, 192, 256} and
            D in {1, 12, 100}, each case on the route
            `flash_attention.route` names and launched once there (bf16
            with D % 8 == 0 on "sm90", flash_attention_sm90.cu; fp32 and
            the other bf16 cases on "tf32x3", flash_attention.cu; fp32:
            atol 2e-5, rtol 2e-4, as tests/test_kernels.py; bf16: atol
            1e-5, rtol 1.6e-2, two bf16 ulps); at full width llama3-8b's
            attention at train_4k (B=1, H=32, KH=8, S=4096, D=128, bf16,
            causal) on the sm90 route, with the launch counts by route
            read around it; then on exact fp32 copies of the same q, k, v,
            all held to the fp32 tolerance: the sm90 kernel's bf16-in,
            fp32-out entry (which fails a kernel that rounds P to bf16) and
            the fp32 route (tf32x3), and torch's scaled_dot_product_attention
            on the copies, whose error is reported. Times the bf16 route
            beside the plain version and scaled_dot_product_attention (K
            and V repeated outside the timed window), and the fp32-out
            entry, the fp32 route, the plain version and
            scaled_dot_product_attention on the copies
            (fp32_route_library_ms); bounds for the reference's work
            (4 D flops a kept pair) and the split's (6 D), the fp32 route's
            for the reference's work at 495 TFLOP/s TF32, on the CUDA cores
            at 67 TFLOP/s and its 3xTF32 floor (3 x 4 D flops a pair at
            495 TFLOP/s TF32), and the two sources' build seconds
  kernel_k5 K5 (`kernels.ops.ssd_scan`, three kernels a call) over
            tests/test_kernels.py's shapes, ragged S and P, odd P (P = 37,
            N = 5), N in {6, 128, 136, 220 = MAX_N} and S = 4096 at a
            narrow width (atol 5e-4, rtol 2e-3, as tests/test_kernels.py);
            at full width zamba2-2.7b's Mamba-2 mixer (Bt=1, S=4096, H=80,
            P=64, N=64, fp32), where its error must also be within
            SCAN_CAP (1e-4: the 3xTF32 decision; an `error_cap` line).
            Its plain version is a loop over tokens, thousands of
            launches, so it is timed eagerly over 3 windows of one call; no
            single PyTorch call computes the scan. Its bound counts the
            fewest operations of the chunked form, at the chunk length that
            needs least; its bytes' time stands beside it. Its entry adds
            the kernels the full-width call launched (as the library counts
            them), the chunk length, the heads a block and the workspace
            bytes the call allocated
  kernel_k6 K6 (`kernels.ops.selective_scan`) the same way, ragged and odd
            d, S, N in {1, 3, 32, 64}, and S = 4096 at d = 64, where the
            sequence is split into pieces (atol 5e-4, rtol 2e-3); at full
            width falcon-mamba-7b's mixer (Bt=1, S=4096, d=8192, N=16,
            fp32), one piece, its error within SCAN_CAP (2e-5: exp on the
            SFU); its entry adds the kernels the call launched, the pieces,
            the lanes a channel and the workspace bytes

Then one JSON line with every kernel's numbers, the card's name and power
limit as nvidia-smi prints them, and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
#: outside the tensor cores, dense bf16 and TF32 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12

FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=1e-5)
#: K4 against its plain version, by dtype: fp32 as tests/test_kernels.py:31;
#: bf16 tighter than that file's atol 2e-2 / rtol 2e-1, since both sides
#: compute in fp32 and round once to bf16, so they may differ by one bf16
#: ulp (at most 2^-7 of the value): rtol 1.6e-2 is two ulps, atol 1e-5
#: covers the fp32 summation order near 0
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
            "bfloat16": dict(atol=1e-5, rtol=1.6e-2)}
#: K5 and K6 against their plain versions, as tests/test_kernels.py:62,77
SCAN_TOL = dict(atol=5e-4, rtol=2e-3)
#: the largest absolute error K5 and K6 may show at full width, far inside
#: SCAN_TOL: they hold the precision decisions. K5's products run in
#: 3xTF32 on the tensor cores (a single TF32 pass is about 1e-3 off there,
#: tests/test_torch_scan_forms.py shows it on the CPU) and K6's exps on the
#: SFU; about 4x and 10x the errors of the fp32 CUDA-core kernels they
#: replaced (2.67e-5 and 1.9e-6)
SCAN_CAP = {"ssd_scan": 1e-4, "selective_scan": 2e-5}
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
#: the bits of K1's output at the main path's call and of the full-size
#: cell's fvals and disagreement (`_digest`), as the eager loop gave them:
#: the captured run launches the same kernels in the same order, so it
#: must give them too
K1_DIGEST = "268a95744011ca0ff7df2cce4d3ffd801ae69a0ad4069e5aa15e0faf75cb974a"
MAIN_PATH_DIGEST = ("5f506e54118168c58972cac6e3be08280cfc1bf33a76ab994d99009f"
                    "03e75c49")
#: the relative error a sweep lane's device floats may show against its
#: serial run, as tests/test_sweeps.py holds the reference's lanes; the
#: lanes' states are the solo runs' bit for bit (the mix sees them as
#: columns), and so are their statistics, which the batch reduces lane by
#: lane on contiguous copies (the sweep phase counts the equal entries)
SWEEP_RTOL = 1e-6


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


def time_ms(fn, reps: int = 25, inner: int = 20, graph: bool = True,
            warmup: int = 3) -> dict:
    """Per-call time of `fn` in ms, the median over `reps` CUDA-event
    windows of `inner` calls each, after `warmup` calls, two ways:

      device: the `inner` calls captured once in a CUDA graph and the graph
              replayed, so the window holds the device work back to back
              without the host's launch overhead between calls;
      eager:  the calls issued from Python, as the main path issues them
              (host-bound when the wrapper costs more than the kernel).

    `graph=False` leaves out the graph (a plain loop of thousands of
    launches) and returns the eager time under both keys.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def eager_window():
        for _ in range(inner):
            fn()

    eager = _median_window_ms(eager_window, reps, inner)
    if not graph:
        return {"device": eager, "eager": eager}
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


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build(build.SOURCES)
    for name in build.SOURCES:
        build.load(name)
    wall = time.perf_counter() - t0
    ptxas = {name: _ptxas_report(
        build.library_path(name).with_suffix(".log").read_text())
        for name in build.SOURCES}
    emit("build", seconds=seconds, wall_s=wall, ptxas=ptxas)
    return seconds


def _ptxas_report(log: str) -> list:
    """The compiler's `-Xptxas -v` report, one line for each kernel
    instantiation (its name demangled where `c++filt` is on the path):
    registers, shared memory, stack and spills; then every warning and
    performance remark."""
    import shutil

    names, lines, spills = [], [], ""
    for ln in log.splitlines():
        ln = ln.strip()
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            names.append(entry.group(1))
            spills = ""
        elif "spill" in ln:  # ptxas prints it before the registers
            spills = "; " + ln
        elif "Used" in ln and "registers" in ln and names:
            lines.append(f"{names[-1]}: {ln.split(':', 1)[1].strip()}"
                         f"{spills}")
        elif "warning" in ln.lower() or "Performance Loss" in ln:
            lines.append(ln)
    filt = shutil.which("c++filt")
    if filt and names:
        plain = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(plain) == len(names):
            for mangled, readable in zip(names, plain):
                lines = [ln.replace(mangled + ":", readable + ":")
                         for ln in lines]
    return lines


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


#: each kernel's launch count in repro_torch.kernels.counters, by kernel
_COUNTS = {"gossip_mix": ("gossip_mix", "LAUNCHES"),
           "compress_mix": ("compress_mix", "LAUNCHES"),
           "gossip_mix_flat": ("gossip_mix", "FLAT_LAUNCHES"),
           "flash_attention": ("flash_attention", "LAUNCHES"),
           "ssd_scan": ("ssd_scan", "LAUNCHES"),
           "selective_scan": ("selective_scan", "LAUNCHES")}


#: K4's launches by route (flash_attention.route), beside its total above
_ROUTE_COUNTS = {"sm90": "SM90_LAUNCHES", "tf32x3": "TF32X3_LAUNCHES"}


def _launch_counts() -> dict:
    from repro_torch.kernels import counters

    snap = counters.snapshot()
    return {kernel: snap[key] for kernel, key in _COUNTS.items()}


def _route_counts() -> dict:
    from repro_torch.kernels import counters

    snap = counters.snapshot()
    return {route: snap[("flash_attention", attr)]
            for route, attr in _ROUTE_COUNTS.items()}


def _zero_launch_counts() -> None:
    """Every counter of repro_torch.kernels.counters to 0 (the ones the run
    program adds on replay among them)."""
    from repro_torch.kernels import counters

    counters.zero()


def _front_door_once(kernel: str, call):
    """`call()` (one front-door call) with every launch count set to 0 just
    before and read just after: it must have launched `kernel` exactly once
    and no other kernel. Returns its output and the launches."""
    import torch

    _zero_launch_counts()
    out = call()
    torch.cuda.synchronize()
    counts = _launch_counts()
    if counts[kernel] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"one front-door call of {kernel} launched "
                             f"{counts}")
    return out, counts[kernel]


def _bound(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS
           ) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at `peak_flops`,
    whichever is longer."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / peak_flops * 1e3
    return {"bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def _max_err(out, expect) -> float:
    return float((out.float() - expect.float()).abs().max())


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


def _digest(*arrays) -> str:
    """sha256 of the arrays' float32 bytes, one after the other."""
    import numpy as np
    import torch

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a, dtype=np.float32).tobytes())
    return h.hexdigest()


def _form_launched(before: dict) -> str:
    """The kernel (slab or regs) of the one K1 call made since
    gossip_mix.FORM_LAUNCHES read `before`."""
    from repro_torch.kernels import gossip_mix

    grown = [form for form, count in gossip_mix.FORM_LAUNCHES.items()
             if count != before[form]]
    if len(grown) != 1 or sum(gossip_mix.FORM_LAUNCHES.values()) != sum(
            before.values()) + 1:
        raise AssertionError(f"one K1 call counted {before} -> "
                             f"{gossip_mix.FORM_LAUNCHES}")
    return grown[0]


def _sweep_call(kernel: str) -> dict:
    """K1 ("gossip_mix") or K2 ("compress_mix") at the sweep phase's call:
    the five lanes' (n, B, d) carry of the full-size cell (n=256, B=5,
    d=4096, k=4, fp32, its expander) handed to the front door as the run
    program hands it, one (n, B*d) state to the kernel. Each case must
    launch its kernel once (K1 its slab kernel), agree with the plain
    version on the same inputs within FP32_TOL, and give each lane's
    columns the bits of a one-lane call on them (every column mixes on its
    own). K1 mixes z and a message stack of its own; K2's mask is top-k at
    keep 1/4, drawn per node and lane. Both weight forms: the scalars the
    run program passes and per-node vectors."""
    import numpy as np
    import torch

    from repro_torch.compress import topk_mask_torch
    from repro_torch.core.graphs import kregular_expander
    from repro_torch.kernels import gossip_mix, ops, ref

    n, B, d, k = 256, len(SWEEP_VALUES), 4096, 4
    g = kregular_expander(n, k=k, seed=0)
    S_in = torch.as_tensor([list(p) for p in g.perms], device="cuda").T \
        .contiguous()
    ws, we = float(np.float32(g.self_weight)), float(np.float32(
        g.edge_weight))
    rng = np.random.default_rng(2)

    def draw():
        return torch.from_numpy(rng.standard_normal(
            (n, B, d), dtype=np.float32)).cuda()

    def door(w_self, w_edge, z, msg, mask):
        if kernel == "gossip_mix":
            return ops.gossip_gather_mix_impl(z, S_in, w_self, w_edge,
                                              msg=msg)
        return ops.compress_mix_impl(z, msg, mask, S_in, w_self, w_edge)

    def plain(w_self, w_edge, z, msg, mask):
        if kernel == "gossip_mix":
            return ref.gossip_gather_mix_ref(z, S_in, w_self, w_edge,
                                             msg=msg)
        return ref.compress_mix_ref(z, msg, mask, S_in, w_self, w_edge)

    worst, cases, lanes_equal = 0.0, 0, 0
    for weights in ((ws, we), (torch.full((n,), ws, device="cuda"),
                               torch.full((n, k), we, device="cuda"))):
        for with_msg in ((False, True) if kernel == "gossip_mix"
                         else (True,)):
            z = draw()
            msg = z + 0.1 * draw() if with_msg else None
            mask = None
            if kernel == "compress_mix":
                mask = topk_mask_torch(msg, d // 4)
                kept = mask.sum(dim=-1)
                if mask.shape != z.shape or not bool(
                        (kept == d // 4).all()):
                    raise AssertionError("the sweep call's top-k mask does "
                                         "not keep d/4 a node and lane")
            where = (f"{kernel} at the sweep's call (n={n}, M={B}x{d}, "
                     f"k={k}, vector weights="
                     f"{isinstance(weights[0], torch.Tensor)}, "
                     f"msg={with_msg})")
            forms = dict(gossip_mix.FORM_LAUNCHES)
            before = _launch_counts()
            out = door(*weights, z, msg, mask)
            grown = {kern: c - before[kern]
                     for kern, c in _launch_counts().items()
                     if c != before[kern]}
            if grown != {kernel: 1}:
                raise AssertionError(f"{where} launched {grown}")
            if kernel == "gossip_mix" and _form_launched(forms) != "slab":
                raise AssertionError(f"{where} did not take the slab "
                                     f"kernel")
            expect = plain(*weights, z, msg, mask)
            torch.cuda.synchronize()
            if out.dtype != torch.float32 or out.shape != z.shape:
                raise AssertionError(f"{where} returned {out.dtype} "
                                     f"{tuple(out.shape)}")
            torch.testing.assert_close(out, expect, **FP32_TOL,
                                       msg=lambda m: f"{where}: {m}")
            worst = max(worst, _max_err(out, expect))
            cases += 1
            for lane in range(B):
                def one(a):
                    return None if a is None else a[:, lane].contiguous()

                solo = door(*weights, one(z), one(msg), one(mask))
                if not torch.equal(out[:, lane], solo):
                    raise AssertionError(f"{where}: lane {lane} differs "
                                         f"from a one-lane call")
                lanes_equal += 1
    return {"name": kernel, "shape": {"n": n, "M": B * d, "lanes": B,
                                      "k": k, "dtype": "float32"},
            "cases": cases, "lanes_bitwise_equal": lanes_equal,
            "max_abs_err": worst, "fp32_tol": FP32_TOL}


def phase_kernel() -> dict:
    """K1 against its plain version on the card, then its times."""
    import numpy as np
    import torch

    from repro_torch.kernels import gossip_mix, ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    checked = 0
    forms = {"regs": 0, "slab": 0}
    min_reads = gossip_mix.slab_min_reads()
    for n in (7, 12, 256, 1024):
        for M in (1, 130, 257, 4096, 65536):
            # k <= 8 takes a kernel built for its k, k = 9 the generic one
            for k in (1, 4, 8, 9):
                for dtype, tol in ((torch.float32, FP32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    for vector_weights in (False, True):
                        # msg: none (z itself), its own tensor, or a view
                        # one element in, not 16-byte aligned (the
                        # one-element path)
                        for with_msg in ("none", "own", "offset"):
                            args = _mix_inputs(gen, n, M, k, dtype,
                                               vector_weights,
                                               with_msg == "own")
                            z, S_in, w_self, w_edge, msg = args
                            if with_msg == "offset":
                                msg = _randn(gen, (n * M + 1,), dtype)[1:] \
                                    .view(n, M)
                            before = dict(gossip_mix.FORM_LAUNCHES)
                            out = ops.gossip_gather_mix_impl(
                                z, S_in, w_self, w_edge, msg=msg)
                            form = _form_launched(before)
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
                            where = (f"n={n} M={M} k={k} {dtype} "
                                     f"vector={vector_weights} "
                                     f"msg={with_msg}")
                            torch.testing.assert_close(
                                out.float(), expect.float(), **tol,
                                msg=lambda m: f"K1 disagrees at {where}: {m}")
                            # the slab kernel takes 16-byte packets (M a
                            # multiple of 16 bytes, every operand aligned),
                            # k <= 8 and n (k + 1) row reads a column from
                            # slab_min_reads(); its shared memory holds
                            # n = 1024
                            packets = M * out.element_size() % 16 == 0 \
                                and with_msg != "offset"
                            expect_form = ("slab" if packets and k <= 8
                                           and n * (k + 1) >= min_reads
                                           else "regs")
                            if form != expect_form:
                                raise AssertionError(
                                    f"K1 launched its {form} kernel at "
                                    f"{where}, not {expect_form}")
                            forms[form] += 1
                            checked += 1
    emit("kernel_check", name="gossip_mix", cases=checked,
         forms_launched=forms, max_abs_err=worst, fp32_tol=FP32_TOL,
         bf16_tol=BF16_TOL)
    emit("kernel_check_sweep_call", **_sweep_call("gossip_mix"))

    # the main path's call: n=256, M=4096, k=4, fp32, uniform weights
    n, M, k = 256, 4096, 4
    from repro_torch.core.graphs import kregular_expander

    g = kregular_expander(n, k=k, seed=0)
    S_in = torch.as_tensor([list(p) for p in g.perms], device="cuda").T \
        .contiguous()
    # z from numpy, seeded, so that its bits depend on nothing else here
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, M), dtype=np.float32)).cuda()
    ws, we = float(g.self_weight), float(g.edge_weight)
    w_self = torch.full((n,), ws, device="cuda")
    w_edge = torch.full((n, k), we, device="cuda")
    P = torch.as_tensor(g.mixing_matrix(), dtype=torch.float32,
                        device="cuda")
    before = dict(gossip_mix.FORM_LAUNCHES)
    out = gossip_mix.gossip_mix_weighted(z, S_in, w_self, w_edge)
    # the kernel timed below, and the one the main path launches 149 times
    form = _form_launched(before)
    if form != "slab":
        raise AssertionError(f"K1 launched its {form} kernel at the main "
                             f"path's call, not the slab kernel")
    expect = ref.gossip_gather_mix_ref(z, S_in, ws, we)
    torch.cuda.synchronize()
    max_abs_err = float((out - expect).abs().max())
    # the output's bits: a redesign of K1 keeps its arithmetic order, so
    # this digest does not change
    k1_digest = _digest(out)
    if k1_digest != K1_DIGEST:
        raise AssertionError(f"K1's output bits changed: k1_digest "
                             f"{k1_digest}, not {K1_DIGEST}")
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
         k1_digest=k1_digest, form=form,
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
    emit("kernel_check_sweep_call", **_sweep_call("compress_mix"))

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


#: the seven manifests with a dense backend: the first three mix through
#: the hand kernels (expanders), the other four through cuBLAS's P @ z
#: (complete graphs), which launches no hand kernel
SPARSE_MANIFESTS = ("expander_periodic", "expander_sparse",
                    "compressed_expander")
DENSE_MIX_MANIFESTS = ("complete_every", "fig1_complete", "fig1_reduced",
                       "fig2_sparse")


def phase_manifests() -> None:
    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.experiments import components as C

    for name in SPARSE_MANIFESTS + DENSE_MIX_MANIFESTS:
        spec = repro_torch.ExperimentSpec.from_file(
            ROOT / "benchmarks" / "manifests" / f"{name}.json")
        kernel = ("none" if name in DENSE_MIX_MANIFESTS
                  else "gossip_mix" if spec.compression is None
                  else "compress_mix")
        # a problem whose closures read the card back cannot be captured
        loop = ("graph" if C.build_component(
            C.problems, spec.problem.kind, spec.problem.params,
            device="cpu").capturable else "eager")
        before = _launch_counts()
        on_card = repro_torch.run(spec, "dense", device="cuda")
        after = _launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        on_cpu = repro_torch.run(spec, "dense", device="cpu")
        card, cpu = on_card.to_dict(), on_cpu.to_dict()
        flips = (_manifest_flips(spec) if name in DENSE_MIX_MANIFESTS
                 and spec.problem.kind != "quadratic_consensus" else None)
        emit("manifest", name=name, mix_mode=card["extras"]["mix_mode"],
             kernel=kernel, launches=launches.get(kernel, 0),
             loop=on_card.metrics.notes["loop"],
             final_f_card=card["trace"]["fvals"][-1],
             final_f_cpu=cpu["trace"]["fvals"][-1],
             time_to_target=card["time_to_target"],
             max_rel_err={f: _max_rel_err(card["trace"][f], cpu["trace"][f])
                          for f in ("fvals", "fvals_consensus",
                                    "disagreement")},
             card_cpu_flips=flips)
        assert_results_match(card, cpu)
        if on_card.metrics.notes["loop"] != loop:
            raise AssertionError(f"{name}: ran {on_card.metrics.notes} on "
                                 f"the card, its problem declares {loop}")
        rounds = card["trace"]["comms"][-1]
        expect = 0 if kernel == "none" else rounds
        if launches.get(kernel, 0) != expect or sum(
                launches.values()) != expect:
            raise AssertionError(f"{name}: launches {launches} for "
                                 f"{rounds} rounds of {kernel}")


def _manifest_flips(spec) -> dict:
    """A complete-graph manifest on the card and on the CPU side by side,
    one iteration at a time, as `_flipped_entries` runs its twins: after
    every iteration, the discrete choices of each side's state that
    differ. For the nonsmooth problem the subgradient's picks (which of
    each center pair `argmax` takes at x), for metric learning the signs
    of the eigenvalues the PSD projection clamps (of -a(t) z's symmetric
    part). Returns the first iteration that differs, the entries there,
    and the totals over the run."""
    import numpy as np
    import torch

    from repro_torch.core.dda import DDASimulator
    from repro_torch.experiments import components as C

    sims, states, problems = [], [], []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        problem = C.build_component(C.problems, spec.problem.kind,
                                    spec.problem.params, device=dev)
        graph = C.build_component(C.topologies, spec.topology.kind,
                                  spec.topology.params, n=problem.n)
        sims.append(DDASimulator(
            problem.subgrad_stack, problem.objective, graph,
            C.build_component(C.schedules, spec.schedule.kind,
                              spec.schedule.params),
            a_fn=C.build_component(C.stepsizes, spec.stepsize.kind,
                                   spec.stepsize.params),
            r=spec.r, projection=problem.projection, device=dev))
        zeros = torch.zeros((problem.n, problem.d), device=dev)
        states.append((zeros, zeros, zeros, zeros,
                       torch.zeros((), device=dev)))
        problems.append(problem)

    def codes(problem, sim, state):
        z, x, _, _, t = state
        if spec.problem.kind == "nonsmooth":
            diff = x[:, None, None, :] - problem.arrays["centers_j"]
            return torch.argmax(torch.sum(diff * diff, dim=-1), dim=-1)
        f = int(round((problem.d - 1) ** 0.5))
        A = (-sim.a_fn(t) * z)[:, :f * f].reshape(-1, f, f)
        return torch.linalg.eigvalsh(0.5 * (A + A.transpose(-1, -2))) > 0

    mask = np.asarray(sims[0].schedule.comm_mask(0, spec.T), dtype=bool)
    first, total, iters_with = None, 0, 0
    for i in range(spec.T):
        states = [sim._segment(*s, mask[i:i + 1])
                  for sim, s in zip(sims, states)]
        a, b = (codes(p, sim, s).cpu()
                for p, sim, s in zip(problems, sims, states))
        flips = int((a != b).sum())
        total += flips
        iters_with += flips > 0
        if flips and first is None:
            first = {"iteration": i + 1, "entries": flips}
    return {"first_flip": first, "flipped_entries": total,
            "iterations_with_flips": iters_with}


def _profiled_kernels(prof, name: str) -> int:
    """How many kernels whose name holds `name` the profiler saw run."""
    return sum(ev.count for ev in prof.key_averages() if name in ev.key)


def phase_main_path() -> int:
    """The full-size dense cell, with the launch counts read around it and
    the profiler watching it; then again unprofiled, for its wall."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.core.dda import _LaneProgram
    from repro_torch.core.schedules import Periodic

    from repro_torch.kernels import gossip_mix

    spec = _dense_cell_spec()
    _zero_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = repro_torch.run(spec, device="cuda")
        torch.cuda.synchronize()
    counts = _launch_counts()
    forms = dict(gossip_mix.FORM_LAUNCHES)
    launches = counts["gossip_mix"]
    if sum(counts.values()) != launches:
        raise AssertionError(f"the uncompressed cell launched another "
                             f"kernel than K1: {counts}")
    if forms != {"regs": 0, "slab": launches}:
        raise AssertionError(f"the uncompressed cell's K1 launches took "
                             f"the kernels {forms}, not the slab kernel")
    # the counts are derived from the graphs' replays: hold them to the
    # kernels the card ran, which are those, the capture's warm-up (one
    # comm body, so one K1 launch, a pass) and the comm graph's first
    # replay at the capture (one K1 launch)
    profiled = {form: _profiled_kernels(prof, f"gossip_mix_{form}")
                for form in ("regs", "slab")}
    if profiled != {"regs": 0,
                    "slab": launches + _LaneProgram.WARMUP + 1}:
        raise AssertionError(f"the profiler saw the K1 kernels {profiled}, "
                             f"not {launches} replayed, "
                             f"{_LaneProgram.WARMUP} warming up and 1 "
                             f"first replay at the capture")
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
    if result.metrics.notes["loop"] != "graph":
        raise AssertionError(f"the main path ran {result.metrics.notes}, "
                             f"not captured")
    digest = _digest(trace["fvals"], trace["disagreement"])
    if digest != MAIN_PATH_DIGEST:
        raise AssertionError(f"the main path's bits changed: "
                             f"main_path_digest {digest}, not "
                             f"{MAIN_PATH_DIGEST}")
    # unprofiled, for the captured wall, and the same bits
    timed = repro_torch.run(spec, device="cuda")
    if timed.metrics.notes["loop"] != "graph" or _digest(
            timed.trace.fvals, timed.trace.disagreement) != digest:
        raise AssertionError("the unprofiled captured run differs from "
                             "the profiled one")
    # the eager host loop over the same kernels, for its wall beside the
    # captured run's, and its bits
    eager = repro_torch.run(
        spec, repro_torch.ComponentSpec("dense", {"loop": "segment"}),
        device="cuda")
    if eager.metrics.notes["loop"] != "eager" or _digest(
            eager.trace.fvals, eager.trace.disagreement) != digest:
        raise AssertionError("the eager loop='segment' run differs from "
                             "the captured one")
    twin = repro_torch.run(
        spec, repro_torch.ComponentSpec("dense", {"mix": "dense"}),
        device="cuda")
    twin_d = twin.to_dict()
    if twin_d["extras"]["mix_mode"] != "dense" or \
            twin.metrics.notes["loop"] != "graph":
        raise AssertionError(f"the mix='dense' twin mixed "
                             f"{twin_d['extras']['mix_mode']}, ran "
                             f"{twin.metrics.notes}")
    # the twin differs by construction only in its backend params and the
    # mix mode it reports; everything the run computed must agree
    twin_d["backend"], twin_d["extras"] = d["backend"], d["extras"]
    assert_results_match(d, twin_d)
    m = timed.metrics
    emit("main_path", launches=launches, rounds=rounds,
         k1_forms_launched=forms, k1_kernels_profiled=profiled,
         main_path_digest=digest,
         loop=m.notes["loop"],
         mix_mode=d["extras"]["mix_mode"], compile_s=m.compile_s,
         execute_s=m.execute_s, wall_s=timed.wall_s,
         us_per_iter=m.execute_s / spec.T * 1e6,
         eager_us_per_iter=eager.metrics.execute_s / spec.T * 1e6,
         eager_ratio=m.execute_s / eager.metrics.execute_s,
         twin_execute_s=twin.metrics.execute_s,
         twin_us_per_iter=twin.metrics.execute_s / spec.T * 1e6,
         twin_ratio=m.execute_s / twin.metrics.execute_s,
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
    from repro_torch.kernels import gossip_mix

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
        others = sum(v for k, v in counts.items() if k != kernel)
        if d["extras"]["mix_mode"] != "sparse":
            raise AssertionError(f"{kind}: mixed {d['extras']['mix_mode']}")
        if result.metrics.notes["loop"] != "graph":
            raise AssertionError(f"{kind}: ran {result.metrics.notes}, not "
                                 f"captured")
        if counts[kernel] != 149 or rounds != 149 or others != 0:
            raise AssertionError(f"{kind}: launches {counts} for {rounds} "
                                 f"rounds (expected 149 of {kernel})")
        forms = dict(gossip_mix.FORM_LAUNCHES)
        if forms != {"regs": 0, "slab": counts["gossip_mix"]}:
            raise AssertionError(f"{kind}: K1's launches took the kernels "
                                 f"{forms}, not the slab kernel")
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
        if twin_d["extras"]["mix_mode"] != "dense" or \
                twin.metrics.notes["loop"] != "graph":
            raise AssertionError(f"{kind}: the mix='dense' twin mixed "
                                 f"{twin_d['extras']['mix_mode']}, ran "
                                 f"{twin.metrics.notes}")
        errors = {f: _max_rel_err(d["trace"][f], twin_d["trace"][f])
                  for f in ("fvals", "fvals_consensus", "disagreement")}
        errors["residual_norms"] = _max_rel_err(
            norms, twin_d["extras"]["compression"]["residual_norms"])
        flips = _flipped_entries(spec)
        m = result.metrics
        emit("main_path_compressed", compression=kind, params=params,
             kernel=kernel, launches=counts[kernel], rounds=rounds,
             mix_mode=d["extras"]["mix_mode"], loop=m.notes["loop"],
             wire_ratio=block["wire_ratio"], compile_s=m.compile_s,
             execute_s=m.execute_s,
             us_per_iter=m.execute_s / spec.T * 1e6,
             twin_us_per_iter=twin.metrics.execute_s / spec.T * 1e6,
             twin_ratio=m.execute_s / twin.metrics.execute_s,
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


#: the sweep phase's axis: the comm period h of Fig. 2
SWEEP_AXIS, SWEEP_VALUES = "schedule.params.h", (1, 2, 4, 8, 16)
def _lane_against_serial(lane: dict, serial: dict) -> tuple[int, int]:
    """Hold a batched sweep lane's result to its serial run's under
    convert.assert_results_match at rtol SWEEP_RTOL, atol 0 (host fields
    exactly, the trace's device floats and the residual norms relatively),
    the lane's `vmap_lanes` aside. Returns (bitwise equal trace floats,
    trace floats)."""
    from repro_torch.convert import assert_results_match

    lane = dict(lane, extras={k: v for k, v in lane["extras"].items()
                              if k != "vmap_lanes"})
    assert_results_match(lane, serial, rtol=SWEEP_RTOL, atol=0.0)
    pairs = [(lane["trace"][f], serial["trace"][f])
             for f in ("fvals", "fvals_consensus", "disagreement")]
    return (sum(a == b for ours, theirs in pairs
                for a, b in zip(ours, theirs)),
            sum(len(theirs) for _, theirs in pairs))


def phase_sweep() -> dict:
    """The full-size cell swept over h in SWEEP_VALUES (Fig. 2's axis),
    uncompressed (K1) and under top-k at keep 1/4 (K2): one batched
    program of five lanes (`run_sweep(parallel="vmap")`) with the launch
    counts set to 0 just before and read just after, then the five runs
    serially; each lane held to its serial run. Then two cells across two
    processes on the card, held to serial bit for bit. Returns the
    batched runs' launches by kernel."""
    import numpy as np

    import repro_torch
    from repro_torch.core.schedules import Periodic
    from repro_torch.kernels import gossip_mix

    launched = {}
    serial_results = None
    for compression, kernel in (
            (None, "gossip_mix"),
            ({"kind": "topk", "params": {"keep": 0.25}}, "compress_mix")):
        spec = _dense_cell_spec(compression)
        masks = np.stack([Periodic(h=h).comm_mask(0, spec.T)
                          for h in SWEEP_VALUES])
        # the batch runs its comm body wherever any lane communicates
        expect = int(masks.any(axis=0).sum())
        _zero_launch_counts()
        batched = repro_torch.run_sweep(spec, SWEEP_AXIS, SWEEP_VALUES,
                                        parallel="vmap", device="cuda")
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
        if counts[kernel] != expect or sum(counts.values()) != expect:
            raise AssertionError(f"the {kernel} sweep launched {counts}, "
                                 f"expected {expect} of {kernel}")
        if kernel == "gossip_mix" and forms != {"regs": 0, "slab": expect}:
            raise AssertionError(f"the sweep's K1 launches took the "
                                 f"kernels {forms}, not the slab kernel")
        for r in batched:
            if r.extras.get("vmap_lanes") != len(SWEEP_VALUES) or \
                    r.metrics.notes != {"loop": "graph"}:
                raise AssertionError(f"a sweep lane ran {r.extras} "
                                     f"{r.metrics.notes}, not as one "
                                     f"captured batch")
        serial = repro_torch.run_sweep(spec, SWEEP_AXIS, SWEEP_VALUES,
                                       device="cuda")
        if any(r.metrics.notes != {"loop": "graph"} for r in serial):
            raise AssertionError("a serial sweep run was not captured")
        equal = entries = 0
        for lane, solo in zip(batched, serial):
            e, n = _lane_against_serial(lane.to_dict(), solo.to_dict())
            equal += e
            entries += n
        batched_wall = sum(r.wall_s for r in batched)
        serial_wall = sum(r.wall_s for r in serial)
        emit("sweep", axis=SWEEP_AXIS, values=list(SWEEP_VALUES),
             compression=compression, kernel=kernel,
             launches=counts[kernel], comm_iterations=expect,
             serial_rounds=[r.trace.comms[-1] for r in serial],
             rtol=SWEEP_RTOL, bitwise_equal_entries=equal,
             float_entries=entries, batched_wall_s=batched_wall,
             batched_compile_s=sum(r.metrics.compile_s for r in batched),
             serial_wall_s=serial_wall,
             serial_compile_s=sum(r.metrics.compile_s for r in serial),
             serial_over_batched=serial_wall / batched_wall,
             final_f=[r.trace.fvals[-1] for r in batched])
        launched[kernel] = counts[kernel]
        if compression is None:
            serial_results = serial

    # two cells across two spawned processes on the card, bit for bit
    procs = repro_torch.run_sweep(_dense_cell_spec(), SWEEP_AXIS,
                                  SWEEP_VALUES[:2], parallel="process",
                                  processes=2, device="cuda")
    for proc, solo in zip(procs, serial_results):
        a, b = proc.to_dict(), solo.to_dict()
        if a["trace"] != b["trace"] or a["spec"] != b["spec"] or \
                a["extras"] != b["extras"] or proc.metrics.notes != {
                    "loop": "graph"}:
            raise AssertionError("a process sweep cell differs from its "
                                 "serial run")
    emit("sweep_process", cells=len(procs), bitwise_equal=True,
         loops=[r.metrics.notes["loop"] for r in procs])
    return launched


#: the stated tradeoff the injected clock charges in the adaptive phase:
#: a comm iteration costs 1/n + k * ADAPTIVE_R_TRUE, a plain one 1/n. At
#: n=256, k=4 on the expander (lambda2 0.967) eq. 21 then asks for h about
#: 3.7 (2.6 under top-k's wire ratio 1/2): the schedule must splice h up
ADAPTIVE_R_TRUE = 10.0
#: the most the closed loop's plain sample (its first timed chunk, one
#: idle iteration) may cost, as a multiple of the p50 of one-iteration
#: idle chunks timed the same way on a loaded program. On an H100
#: (scripts/profile_torch_closed_loop.py, two runs) a first chunk that
#: follows the load's kernels with no replay between costs 1.33 to 2.28
#: times that p50; one after the chunk driver's priming replay 1.07 to 1.46
PLAIN_SAMPLE_CAP = 1.5
#: closed-loop runs whose plain samples' median is held to the cap
PLAIN_SAMPLE_RUNS = 5


def _adaptive_cell_spec(compression=None):
    """The full-size cell under the paper's adaptive schedule, closed loop
    ("dense_adaptive" controller, h0 = 1)."""
    import repro_torch

    d = _dense_cell_spec(compression).to_dict()
    d.update(name="dense_adaptive_full",
             schedule={"kind": "adaptive", "params": {"h0": 1}},
             controller={"kind": "dense_adaptive",
                         "params": {"warmup_comm": 2, "warmup_plain": 1}})
    return repro_torch.ExperimentSpec.from_dict(d)


def _charged_closed_loop(spec, device: str):
    """The closed loop (`runner._dense_adaptive_run`) on `device` under an
    injected clock that charges each chunk eq. 9's cost at
    ADAPTIVE_R_TRUE, through the loop's seam `DDASimulator.run_chunk`.
    Returns (trace, schedule, controller, simulator, clock reading)."""
    import torch

    from repro_torch.adaptive import DenseController
    from repro_torch.experiments import runner

    dev = torch.device(device)
    parts = runner._dense_parts(spec, spec.backends[0], dev)
    sim = runner._dense_sim(spec, parts, dev)
    problem, graph = parts["problem"], parts["graph"]
    n, k = graph.n, graph.degree
    clock = {"t": 0.0}
    real = sim.run_chunk

    def charged(comm, chunk):
        clock["t"] += (1.0 / n + (k * ADAPTIVE_R_TRUE if comm else 0.0)) \
            * chunk
        return real(comm, chunk)

    sim.run_chunk = charged
    params = dict(spec.controller.params)
    if sim.compression is not None:
        params.setdefault("wire_ratio", sim.wire_ratio(problem.d))
    ctrl = DenseController(parts["schedule"], **params)
    x0 = torch.zeros((problem.n, problem.d), device=dev)
    trace = runner._dense_adaptive_run(sim, ctrl, x0, spec.T,
                                       spec.eval_every, spec.seed,
                                       timer=lambda: clock["t"])
    return trace, parts["schedule"], ctrl, sim, clock["t"]


def _spied_run(spec):
    """`repro_torch.run(spec)` on the card, each chunk of its closed loop
    also timed by a spy around the loop's seam. Returns the result and the
    chunks as (comm, iterations, wall in s)."""
    import repro_torch
    from repro_torch.core.dda import DDASimulator

    chunks = []
    run_chunk = DDASimulator.run_chunk

    def spied(self, comm, chunk):
        t0 = time.perf_counter()
        run_chunk(self, comm, chunk)
        chunks.append((comm, chunk, time.perf_counter() - t0))

    DDASimulator.run_chunk = spied
    try:
        result = repro_torch.run(spec, device="cuda")
    finally:
        DDASimulator.run_chunk = run_chunk
    return result, chunks


def _one_iteration_chunks(spec, reps: int = 100) -> dict:
    """The p50 walls (us) of one-iteration chunks of the idle and the comm
    body, alternating, each timed as the closed loop times a chunk, on a
    loaded program of `spec` on the card (its launches not counted)."""
    import torch

    from repro_torch.experiments import runner
    from repro_torch.kernels import counters

    dev = torch.device("cuda")
    parts = runner._dense_parts(spec, spec.backends[0], dev)
    sim = runner._dense_sim(spec, parts, dev)
    problem = parts["problem"]
    before = counters.snapshot()
    sim.start_closed_loop(torch.zeros((problem.n, problem.d), device=dev),
                          spec.T)
    walls = {"idle": [], "comm": []}
    for _ in range(reps):
        for body in walls:
            t0 = time.perf_counter()
            sim.run_chunk(body == "comm", 1)
            walls[body].append((time.perf_counter() - t0) * 1e6)
    sim.end_closed_loop()
    counters.restore(before)
    return {body: statistics.median(us) for body, us in walls.items()}


def phase_adaptive() -> dict:
    """The full-size cell under `dense_adaptive`, uncompressed (K1) and
    under top-k at keep 1/4 (K2): first under the injected clock on the
    card and on the CPU (the same retunes, h_final and r_hat exactly; the
    traces within the default tolerances, top-k within TWIN_TOL), then
    under the real clock on the card through repro_torch.run, with every
    launch count set to 0 just before: the run is captured, and its
    kernel launches once for each communication round the closed loop
    chose. Returns those launches by kernel."""
    import numpy as np

    import repro_torch
    from repro_torch.kernels import gossip_mix

    launched = {}
    for compression, kernel in (
            (None, "gossip_mix"),
            ({"kind": "topk", "params": {"keep": 0.25}}, "compress_mix")):
        spec = _adaptive_cell_spec(compression)
        _zero_launch_counts()
        card, sched, ctrl, sim, charged = _charged_closed_loop(spec, "cuda")
        counts = _launch_counts()
        cpu, cpu_sched, cpu_ctrl, cpu_sim, _ = _charged_closed_loop(spec,
                                                                    "cpu")
        retunes = [dataclasses.astuple(rt) for rt in sched.retunes]
        if retunes != [dataclasses.astuple(rt) for rt in cpu_sched.retunes] \
                or sched.h_current != cpu_sched.h_current \
                or ctrl.tracker.r_hat != cpu_ctrl.tracker.r_hat:
            raise AssertionError(f"{kernel}: the charged closed loop retuned "
                                 f"{retunes} on the card, "
                                 f"{cpu_sched.retunes} on the CPU")
        if not retunes or sched.h_current <= 1:
            raise AssertionError(f"{kernel}: r_true {ADAPTIVE_R_TRUE} must "
                                 f"raise h, got {sched.h_current}")
        if sim.last_loop != "graph":
            raise AssertionError(f"{kernel}: the closed loop ran "
                                 f"{sim.last_loop} on the card")
        rounds = card.comms[-1]
        if counts[kernel] != rounds or sum(counts.values()) != rounds:
            raise AssertionError(f"{kernel}: the charged loop launched "
                                 f"{counts} for {rounds} rounds")
        for f in ("iters", "sim_time", "comms"):
            if getattr(card, f) != getattr(cpu, f):
                raise AssertionError(f"{kernel}: trace.{f} differs card "
                                     f"against CPU")
        tol = (FP32_TOL["rtol"], FP32_TOL["rtol"]) if compression is None \
            else (TWIN_TOL["topk"]["fvals"], TWIN_TOL["topk"]["state"])
        errors = {}
        for f, rtol in (("fvals", tol[0]), ("fvals_consensus", tol[0]),
                        ("disagreement", tol[1])):
            errors[f] = _max_rel_err(getattr(card, f), getattr(cpu, f))
            if not _allclose(getattr(card, f), getattr(cpu, f), rtol):
                raise AssertionError(f"{kernel}: trace.{f} card against CPU "
                                     f"outside rtol={rtol} (max rel err "
                                     f"{errors[f]})")
        if compression is not None:
            errors["residual_norms"] = _max_rel_err(sim.last_res_norms,
                                                    cpu_sim.last_res_norms)
            if not _allclose(sim.last_res_norms, cpu_sim.last_res_norms,
                             tol[1]):
                raise AssertionError(f"{kernel}: residual norms card "
                                     f"against CPU {errors}")
        emit("adaptive_charged", kernel=kernel, compression=compression,
             r_true=ADAPTIVE_R_TRUE, r_hat=ctrl.tracker.r_hat,
             retunes=[(rt.from_t, rt.h) for rt in sched.retunes],
             h_final=sched.h_current, rounds=rounds, launches=counts[kernel],
             charged_clock=charged, card_cpu_max_rel_err=errors,
             rtol={"fvals": tol[0], "state": tol[1]})

        # the real clock, on the card, through the entry point
        _zero_launch_counts()
        result, chunks = _spied_run(spec)
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
        trace = result.trace
        rounds = trace.comms[-1]
        m = result.metrics
        if m.notes != {"loop": "graph"}:
            raise AssertionError(f"{kernel}: the closed loop ran {m.notes}")
        if counts[kernel] != rounds or sum(counts.values()) != rounds:
            raise AssertionError(f"{kernel}: the closed loop launched "
                                 f"{counts} for {rounds} rounds")
        if kernel == "gossip_mix" and forms != {"regs": 0, "slab": rounds}:
            raise AssertionError(f"the closed loop's K1 launches took the "
                                 f"kernels {forms}, not the slab kernel")
        if len(trace.fvals) != spec.T // spec.eval_every or not all(
                np.isfinite(trace.fvals)):
            raise AssertionError(f"{kernel}: closed loop trace "
                                 f"{trace.fvals}")
        if any(t >= spec.T for t, _ in result.extras["retunes"]):
            raise AssertionError(f"{kernel}: a retune at the frontier T")
        # at h0 = 1 the controller's one plain sample is the first timed
        # chunk (t = 1, one idle iteration): it must cost what such a
        # chunk costs once the program runs, not the run's set-up. One
        # sample is noisy: the median of PLAIN_SAMPLE_RUNS runs' is held
        plains = []
        for i in range(PLAIN_SAMPLE_RUNS):
            if i:
                chunks = _spied_run(spec)[1]
            if chunks[0][:2] != (False, 1):
                raise AssertionError(f"{kernel}: the first chunk was "
                                     f"{chunks[0]}, not one plain "
                                     f"iteration")
            plains.append(chunks[0][2] * 1e6)
        steady = _one_iteration_chunks(spec)
        # the captured run of the same cell communicating at every
        # iteration, the work of the closed loop at h = 1 without its
        # chunks' syncs and controller
        every = _dense_cell_spec(compression).to_dict()
        every.update(name="dense_h1_full",
                     schedule={"kind": "periodic", "params": {"h": 1}})
        captured = repro_torch.run(
            repro_torch.ExperimentSpec.from_dict(every), device="cuda")
        if statistics.median(plains) > PLAIN_SAMPLE_CAP * steady["idle"]:
            raise AssertionError(f"{kernel}: the plain samples took "
                                 f"{plains} us, their median more than "
                                 f"{PLAIN_SAMPLE_CAP} x a one-iteration "
                                 f"idle chunk's {steady['idle']} us")
        # under top-k a comm iteration costs more than twice a plain one,
        # so an uncharged plain sample leaves r_hat above 0 (uncompressed
        # a one-iteration chunk's launch and sync, which a comm chunk of
        # 24 iterations spreads, can outweigh the mix: r_hat may read 0)
        if compression is not None and not result.extras["r_hat"] > 0.0:
            raise AssertionError(f"{kernel}: r_hat {result.extras['r_hat']}"
                                 f" with a plain sample of {plains[0]} us")
        emit("adaptive", kernel=kernel, compression=compression,
             launches=counts[kernel], rounds=rounds, loop=m.notes["loop"],
             r_hat=result.extras["r_hat"],
             plain_samples_us=plains,
             one_iteration_chunk_us=steady,
             captured_h1_us_per_iter=(captured.metrics.execute_s / spec.T
                                      * 1e6),
             chunks=len(chunks),
             retunes=result.extras["retunes"],
             h_final=result.extras["h_final"],
             compile_s=m.compile_s, execute_s=m.execute_s,
             wall_s=result.wall_s,
             us_per_iter=m.execute_s / spec.T * 1e6,
             median_iter_wall_us=m.step_time_quantiles["p50"] * 1e6,
             step_time_quantiles=m.step_time_quantiles,
             final_f=trace.fvals[-1])
        launched[kernel] = counts[kernel]
    return launched


#: the six manifests that declare a netsim backend
NETSIM_MANIFESTS = ("adaptive_adversarial", "churn_adversarial",
                    "complete_every", "compressed_expander",
                    "expander_periodic", "expander_sparse")


def _trace_digest(trace) -> str:
    """sha256 of a netsim trace's JSON (every field, host float64)."""
    return hashlib.sha256(json.dumps(dataclasses.asdict(trace),
                                     sort_keys=True).encode()).hexdigest()


def phase_netsim() -> None:
    """Every netsim backend of the six manifests that declare one, through
    repro_torch.run on the card's device (the event loops are host numpy):
    finite traces, messages sent, drops where the scenario loses messages,
    retunes under the adaptive controller, a faults block under the churn
    plan; the object and vectorized engines of a manifest give equal traces
    bit for bit. Prints each run's host wall and its trace's sha256 (not
    asserted: the bits against the reference are the CPU tests' to hold).
    Then one quadratic-consensus cell with its gradient through
    `torch_batch_grad` on the card, beside the numpy gradient's run."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.experiments import components as C
    from repro_torch.experiments import runner
    from repro_torch.netsim import NetSimulator, torch_batch_grad

    for name in NETSIM_MANIFESTS:
        spec = repro_torch.ExperimentSpec.from_file(
            ROOT / "benchmarks" / "manifests" / f"{name}.json")
        traces = {}
        for i, b in enumerate(spec.backends):
            if b.kind != "netsim":
                continue
            result = repro_torch.run(spec, i, device="cuda")
            ex, trace = result.extras, result.trace
            lossy = b.params.get("loss", 0.0) > 0.0
            if not trace.fvals or not all(np.isfinite(trace.fvals)):
                raise AssertionError(f"{name}: trace {trace.fvals}")
            if ex["sent"] <= 0 or (lossy and ex["drops"] <= 0):
                raise AssertionError(f"{name}: sent {ex['sent']}, drops "
                                     f"{ex['drops']}")
            if spec.controller is not None and not ex["retunes"]:
                raise AssertionError(f"{name}: the controller never retuned")
            if spec.faults is not None and not ex["faults"]["crashes"]:
                raise AssertionError(f"{name}: no faults block {ex}")
            traces[ex["engine"]] = trace
            emit("netsim", manifest=name, backend=i, engine=ex["engine"],
                 scenario=ex["scenario"], host_wall_s=result.wall_s,
                 T=spec.T, sent=ex["sent"], drops=ex["drops"],
                 retunes=ex.get("retunes"), h_final=ex.get("h_final"),
                 faults=ex.get("faults"), final_f=trace.fvals[-1],
                 time_to_target=result.time_to_target,
                 trace_sha256=_trace_digest(trace))
        if len(traces) == 2 and traces["object"] != traces["vectorized"]:
            raise AssertionError(f"{name}: the engines' traces differ")

    # one cell's gradients through torch.func.vmap on the card
    spec = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / "expander_periodic.json")
    problem = C.build_component(C.problems, spec.problem.kind,
                                spec.problem.params, device="cuda")
    centers = problem.arrays["centers_j"]
    graph = runner._build_topology(spec, problem.n)
    from repro_torch.netsim.scenarios import DEFAULT_MESSAGE_BYTES
    batch_grad = torch_batch_grad(lambda i, x, t: 2.0 * (x - centers[i]),
                                  device="cuda")
    runs = {}
    for label, batch in (("numpy", None), ("torch_batch_grad", batch_grad)):
        scenario = runner._build_scenario("homogeneous", problem.n, spec.r,
                                          graph, DEFAULT_MESSAGE_BYTES, {})
        sim = NetSimulator(scenario, problem.grad_fn, problem.eval_fn,
                           a_fn=runner._build_stepsize(spec),
                           schedule=runner._build_schedule(spec),
                           seed=spec.seed, engine="vectorized",
                           batch_grad_fn=batch)
        t0 = time.perf_counter()
        runs[label] = sim.run(np.zeros((problem.n, problem.d)), spec.T,
                              eval_every=spec.eval_every)
        runs[label + "_wall_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    a, b = runs["numpy"], runs["torch_batch_grad"]
    if a.iters != b.iters or not all(np.isfinite(b.fvals)):
        raise AssertionError(f"torch_batch_grad run: {b}")
    diff = float(np.max(np.abs(np.subtract(a.fvals, b.fvals))))
    rel = float(np.max(np.abs(np.subtract(a.fvals, b.fvals))
                       / np.abs(a.fvals)))
    # float32 gradients against float64 ones: the traces stay close
    if rel > 1e-4:
        raise AssertionError(f"torch_batch_grad run drifted: rel {rel}")
    emit("netsim_batch_grad", manifest="expander_periodic",
         engine="vectorized", device="cuda", max_abs_fvals_diff=diff,
         max_rel_fvals_diff=rel, numpy_wall_s=runs["numpy_wall_s"],
         torch_batch_grad_wall_s=runs["torch_batch_grad_wall_s"])


#: the packed lane of the serve phase: (h, r, seed) for each request
SERVE_LANE = ((2, 0.01, 0), (4, 0.02, 1), (8, 0.04, 2))


def _served(counts: dict, call):
    """`call()` with every launch count set to 0 just before and read just
    after, added into `counts` by kernel. Returns what it returned."""
    _zero_launch_counts()
    out = call()
    for kernel, n in _launch_counts().items():
        counts[kernel] = counts.get(kernel, 0) + n
    return out


def _exact(label: str, served, solo) -> None:
    from repro_torch.serve import comparable_result_dict

    if comparable_result_dict(served) != comparable_result_dict(solo):
        raise AssertionError(f"serve: {label} differs from its solo run")


def phase_serve() -> dict:
    """The full-size cell served through `repro_torch.serve`: in process
    (two threads), through two spawned worker processes one of which a
    ChaosPlan kills mid-run, and over TCP. Every served result must equal
    a solo `repro_torch.run` of its spec exactly (`comparable_result_dict`).
    Returns the in-process runs' launches by kernel, each request's counts
    set to 0 just before it and read just after."""
    import numpy as np

    import repro_torch
    from repro_torch.core.dda import _LaneProgram
    from repro_torch.core.schedules import Periodic
    from repro_torch.serve import ChaosPlan, Client, ExperimentServer

    cell = _dense_cell_spec()
    lane = [cell.with_value("schedule.params.h", h).with_value(
        "r", r).with_value("seed", seed).with_value("name", f"lane_h{h}")
        for h, r, seed in SERVE_LANE]
    topk = _dense_cell_spec({"kind": "topk", "params": {"keep": 0.25}}
                            ).with_value("name", "dense_full_topk")
    other = cell.with_value("T", 250).with_value("name", "dense_T250")
    net = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / "expander_periodic.json")
    pool_specs = [cell.with_value("seed", seed).with_value(
        "name", f"pool_s{seed}") for seed in range(3)]
    solo = {s.name: repro_torch.run(s, device="cuda")
            for s in [cell, *lane, topk, other, *pool_specs]}
    solo["net"] = repro_torch.run(net, "netsim", device="cuda")

    captures = []
    real_capture = _LaneProgram.capture

    def counted_capture(self):
        captures.append(self.B)
        return real_capture(self)

    counts: dict = {}
    _LaneProgram.capture = counted_capture
    try:
        with ExperimentServer(workers=2, max_width=len(SERVE_LANE),
                              max_wait_s=0.2) as srv:
            cold = _served(counts, lambda: srv.submit(cell).result(600))
            n_captured = len(captures)
            warm = _served(counts, lambda: srv.submit(cell).result(600))
            new_captures = len(captures) - n_captured
            if new_captures or \
                    warm.metrics.counters.get("cache_hit") != 1.0 or \
                    warm.metrics.compile_s >= 1e-3:
                raise AssertionError(
                    f"serve: the warm run captured {new_captures} "
                    f"programs, counters {warm.metrics.counters}, "
                    f"compile_s {warm.metrics.compile_s}")
            _exact("the cold run", cold, solo[cell.name])
            _exact("the warm run", warm, solo[cell.name])

            before = dict(counts)
            packed = _served(counts, lambda: [
                f.result(600) for f in [srv.submit(s) for s in lane]])
            masks = np.stack([Periodic(h=h).comm_mask(0, cell.T)
                              for h, _, _ in SERVE_LANE])
            lane_k1 = counts["gossip_mix"] - before.get("gossip_mix", 0)
            if lane_k1 != int(masks.any(axis=0).sum()):
                raise AssertionError(f"serve: the packed lane launched K1 "
                                     f"{lane_k1} times, not once for each "
                                     f"of its {int(masks.any(axis=0).sum())}"
                                     f" communicating iterations")
            for spec, result in zip(lane, packed):
                if result.extras.get("lane_width") != len(SERVE_LANE):
                    raise AssertionError(f"serve: {spec.name} ran at "
                                         f"{result.extras}, not packed")
                _exact(f"packed lane {spec.name}", result, solo[spec.name])

            served_topk = _served(counts,
                                  lambda: srv.submit(topk).result(600))
            _exact("the top-k run", served_topk, solo[topk.name])
            served_net = _served(counts, lambda: srv.submit(
                net, backend="netsim").result(600))
            _exact("the netsim run", served_net, solo["net"])
            if "not dense" not in served_net.metrics.notes["solo_reason"]:
                raise AssertionError(f"serve: netsim solo_reason "
                                     f"{served_net.metrics.notes}")

            # one thread captures a new signature while the other replays
            # the warm cell
            n_captured = len(captures)
            side = _served(counts, lambda: [
                f.result(600) for f in [srv.submit(other),
                                        srv.submit(cell)]])
            if len(captures) != n_captured + 1:
                raise AssertionError(f"serve: side by side captured "
                                     f"{len(captures) - n_captured} "
                                     f"programs, not 1")
            _exact("the new signature beside a replay", side[0],
                   solo[other.name])
            _exact("the replay beside a capture", side[1], solo[cell.name])

            host, port = srv.start()
            with Client(host, port, timeout=600.0) as client:
                over_tcp = _served(counts, lambda: client.run(cell))
            if over_tcp.to_dict()["trace"] != \
                    solo[cell.name].to_dict()["trace"]:
                raise AssertionError("serve: the TCP result's trace "
                                     "differs from the solo run's")
            _exact("the TCP run", over_tcp, solo[cell.name])
            stats = srv.stats()
    finally:
        _LaneProgram.capture = real_capture

    k1_runs = [cold, warm, side[0], side[1], over_tcp]
    expect = {"gossip_mix": sum(r.trace.comms[-1] for r in k1_runs)
              + int(masks.any(axis=0).sum()),
              "compress_mix": served_topk.trace.comms[-1]}
    if {k: n for k, n in counts.items() if n} != expect:
        raise AssertionError(f"serve: the in-process runs launched {counts}"
                             f", expected {expect}")
    emit("serve", kernels_launched=expect, captures=len(captures),
         cold_wall_s=cold.wall_s, cold_compile_s=cold.metrics.compile_s,
         warm_wall_s=warm.wall_s, warm_compile_s=warm.metrics.compile_s,
         warm_us_per_iter=warm.metrics.execute_s / cell.T * 1e6,
         packed_lane_width=len(SERVE_LANE),
         packed_wall_s=sum(r.wall_s for r in packed),
         packed_compile_s=sum(r.metrics.compile_s for r in packed),
         solo_walls_s=sum(solo[s.name].wall_s for s in lane),
         solo_compile_s=sum(solo[s.name].metrics.compile_s for s in lane),
         topk_wall_s=served_topk.wall_s, netsim_wall_s=served_net.wall_s,
         side_by_side_wall_s=[r.wall_s for r in side],
         tcp_wall_s=over_tcp.wall_s, cache=stats["cache"],
         packer=stats["packer"])

    # two worker processes, the first job's worker killed mid-run
    plan = ChaosPlan(seed=7, kill_at_dispatch=(1,), kill_delay_s=(0.05, 0.2))
    jobs = {"first": [], "warm": []}
    with ExperimentServer(processes=2, packing=False, chaos=plan,
                          pool_kwargs={"backoff_base_s": 0.05}) as pool:
        for phase in ("first", "warm"):
            for spec in pool_specs:
                t0 = time.perf_counter()
                result = pool.submit(
                    spec, idempotency_key=f"{phase}-{spec.name}").result(600)
                c = result.metrics.counters
                # round trip; waiting for a ready worker (its spawn); the
                # run's own wall and its capture, in the worker
                jobs[phase].append({
                    "round_trip_s": time.perf_counter() - t0,
                    "queue_wait_s": c["queue_wait_s"],
                    "cache_hit": c.get("cache_hit", 0.0) == 1.0,
                    "wall_s": result.wall_s,
                    "compile_s": result.metrics.compile_s,
                    "reenqueues": c.get("reenqueues", 0.0)})
                _exact(f"the pooled {phase} run {spec.name}", result,
                       solo[spec.name])
        stats = pool.stats()
    if stats["dedup"]["max_executions_per_key"] > 1 or \
            stats["robustness"]["reenqueues"] < 1 or \
            stats["robustness"]["worker_restarts"] < 1 or \
            stats["chaos"]["kills_delivered"] < 1:
        raise AssertionError(f"serve: the pool's chaos run {stats}")
    emit("serve_pool", processes=2, first_jobs=jobs["first"],
         warm_jobs=jobs["warm"],
         reenqueues=stats["robustness"]["reenqueues"],
         worker_restarts=stats["robustness"]["worker_restarts"],
         kills_delivered=stats["chaos"]["kills_delivered"],
         max_executions_per_key=stats["dedup"]["max_executions_per_key"])
    return counts


def _hold(label: str, out, expect, tol: dict) -> float:
    """A front door's `out` against its plain version's `expect` on the same
    inputs: the same dtype and shape, finite, within `tol`. Returns the
    largest absolute difference."""
    import torch

    torch.cuda.synchronize()
    if out.dtype != expect.dtype or out.shape != expect.shape:
        raise AssertionError(f"{label}: returned {out.dtype} "
                             f"{tuple(out.shape)}, the plain version "
                             f"{expect.dtype} {tuple(expect.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite values")
    torch.testing.assert_close(out.float(), expect.float(), **tol,
                               msg=lambda m: f"{label} disagrees: {m}")
    return _max_err(out, expect)


def _check_grid(name: str, label: str, cases, door, plain, tols: dict
                ) -> None:
    """`door` against `plain` on each of `cases`, (where, args, tolerance
    key) triples, held to `tols[key]`; emits the largest error by key."""
    worst = {}
    checked = 0
    for where, args, key in cases:
        err = _hold(f"{label} at {where}", door(*args), plain(*args),
                    tols[key])
        worst[key] = max(worst.get(key, 0.0), err)
        checked += 1
    emit("kernel_check", name=name, cases=checked, max_abs_err=worst,
         tol=tols)


def _full_width(name: str, label: str, door, plain, args, tol: dict):
    """One front-door call at full width, with the launch counts read around
    it, held to `tol` against the plain version. Returns the launches and
    the largest error."""
    out, launches = _front_door_once(name, lambda: door(*args))
    err = _hold(f"{label} at full width", out, plain(*args), tol)
    del out
    return launches, err


def _report(name: str, source: str, replaces: str, launches: int,
            err: float, kernel_t: dict, plain_t: dict, library_t, nbytes,
            flops, peak: float = FP32_FLOPS, entry: dict | None = None,
            **emitted) -> dict:
    """The kernel's entry of the `kernels` line (with `entry` added to it),
    emitted with its eager times and `emitted` as a `kernel_time` line."""
    numbers = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{source}",
                   replaces=replaces, launches=launches, max_abs_err=err,
                   ms=kernel_t["device"], plain_ms=plain_t["device"],
                   **_bound(nbytes, flops, peak),
                   library_ms=library_t and library_t["device"],
                   **(entry or {}))
    emit("kernel_time", bytes=nbytes, flops=flops,
         kernel_ms=kernel_t["device"], eager_ms=kernel_t["eager"],
         plain_eager_ms=plain_t["eager"],
         library_eager_ms=library_t and library_t["eager"], **emitted,
         **numbers)
    return numbers


def _randn(gen, shape, dtype=None, scale: float = 1.0):
    import torch

    x = torch.randn(shape, generator=gen, device="cuda") * scale
    return x if dtype is None else x.to(dtype)


#: the full-width LM cell's depth: llama3-8b's 32 superblocks cut to 4 so
#: that two pods' parameters, gradients and AdamW moments fit the card
LM_N_SUPER = 4
#: the peak the full-width LM cell may allocate before its depth is cut to
#: 2 (PERF.md states the cut if it happens)
LM_PEAK_CAP_GIB = 72
#: the relative error a smoke-width LM run's losses may show on the card
#: against the CPU (bf16 matmuls accumulate in another order on each)
LM_TRACE_RTOL = 1e-3
#: leaves of a llama3 ("attn") parameter tree, each mixed by one K1 launch
LM_LEAVES = 12
#: the streamed attention against the whole score-matrix form at the cell's
#: bf16 shapes, relative to the largest magnitude of each of the output and
#: the three gradients: about two bf16 roundings of a softmax weight
#: (observed below; a dropped rescale or a mask one key off is 0.08-1.1)
ATTN_STREAM_RTOL = 1.2e-2


def _lm_spec(name: str, variant: str, mesh, topology: dict, T: int,
             batch_per_node: int, seq_len: int, arch: str = "llama3-8b"):
    import repro_torch

    return repro_torch.ExperimentSpec(
        name=name, T=T, eval_every=1, r=0.05, seed=0,
        problem={"kind": "lm", "params": {
            "arch": arch, "variant": variant,
            "batch_per_node": batch_per_node, "seq_len": seq_len}},
        topology=topology,
        schedule={"kind": "periodic", "params": {"h": 2}},
        backends=[{"kind": "launch", "params": {"mesh": list(mesh)}}])


def _lm_host_fields(result, n: int, k: int, r: float) -> None:
    """The closed form of a launch run's host fields (eq. 9/19)."""
    import math

    from repro_torch.core.schedules import Periodic

    d = result.to_dict()
    T = d["spec"]["T"]
    sched = Periodic(h=2)
    comm = [sched.is_comm_step(t) for t in range(1, T + 1)]
    rounds = sum(comm)
    want = {
        "iters": list(range(1, T + 1)),
        "comms": [sched.H(t) for t in range(1, T + 1)],
        "sim_time": [t * (1.0 / n) + sched.H(t) * k * r
                     for t in range(1, T + 1)],
    }
    for key, value in want.items():
        if d["trace"][key] != value:
            raise AssertionError(f"lm trace.{key} {d['trace'][key]} is not "
                                 f"the closed form {value}")
    ex, m = d["extras"], d["metrics"]
    units = sum(1.0 / n + (k * r if c else 0.0) for c in comm)
    if (ex["comm_rounds"], ex["step_comm"]) != (rounds, comm) or \
            not math.isclose(ex["sim_time_units"], units, rel_tol=1e-12):
        raise AssertionError(f"lm extras {ex} against {rounds} rounds, "
                             f"{comm}, {units} units")
    msgs = rounds * n * k
    if (m["msgs"], m["gossip_rounds"], m["bytes_on_wire"]) != (
            msgs, rounds, float(msgs * ex["param_bytes"])):
        raise AssertionError(f"lm metrics {m} against {msgs} messages")
    if not all(math.isfinite(v) for v in d["trace"]["fvals"]):
        raise AssertionError(f"lm losses not finite: {d['trace']['fvals']}")


def _lm_k1_call(M: int = 128256 * 4096, seed: int = 20,
                plain_graph: bool = True) -> dict:
    """K1 at an LM call: one leaf of two full-width pods (bf16, n = 2,
    k = 1, M columns; by default llama3-8b's embed leaf, 128256 x 4096),
    against its plain version bit for bit, timed beside it and
    torch.matmul with the 2 x 2 mixing matrix. `plain_graph=False` times
    the plain version eagerly (CUDA events around single calls): its
    float32 temporaries at deepseek-v2's expert leaf are about 50 GB a
    call, too many for a graph's pool beside the eager windows' cache."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.empty((2, M), dtype=torch.bfloat16, device="cuda")
    for i in range(2):
        z[i] = torch.randn((M,), generator=gen, device="cuda")
    S_in = torch.tensor([[1], [0]], dtype=torch.int64, device="cuda")
    out = ops.gossip_gather_mix_impl(z, S_in, 0.5, 0.5)
    expect = ref.gossip_gather_mix_ref(z, S_in, 0.5, 0.5)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int16), expect.view(torch.int16)):
        raise AssertionError("K1 at the LM call differs from its plain "
                             "version")
    err = _max_err(out, expect)
    del out, expect
    torch.cuda.empty_cache()
    P = torch.full((2, 2), 0.5, dtype=torch.bfloat16, device="cuda")
    kernel_t = time_ms(lambda: ops.gossip_gather_mix_impl(z, S_in, 0.5, 0.5),
                       reps=7, inner=3)
    def plain():
        return ref.gossip_gather_mix_ref(z, S_in, 0.5, 0.5)
    plain_t = (time_ms(plain, reps=5, inner=2) if plain_graph else
               time_ms(plain, reps=5, inner=1, graph=False, warmup=1))
    torch.cuda.empty_cache()
    library_t = time_ms(lambda: torch.matmul(P, z), reps=7, inner=3)
    nbytes = 2 * z.numel() * z.element_size()  # z read once, out written
    del z
    torch.cuda.empty_cache()
    return {"ms": kernel_t["device"], "eager_ms": kernel_t["eager"],
            "plain_ms": plain_t["device"], "library_ms": library_t["device"],
            "max_abs_err": err, "bytes": nbytes, **_bound(nbytes, 0.0)}


def _lm_attention_check() -> dict:
    """`_sdpa_causal` at the full-width cell's shapes (B=1, S=4096, H=32,
    KH=8, D=128, bf16), where it takes the streamed form (online softmax
    over 1024-key chunks), against the whole score-matrix form on the same
    inputs: the output and the gradients of q, k and v, each within
    `ATTN_STREAM_RTOL` of the whole form's largest magnitude."""
    import torch

    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(11)
    q = _randn(gen, (1, 4096, 32, 128), torch.bfloat16).requires_grad_()
    k = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    v = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    g = _randn(gen, (1, 4096, 32, 128), torch.bfloat16)
    if not 4096 > attention._KV_CHUNK:
        raise AssertionError("the cell's attention is not streamed")
    errs = {}
    for form in (attention._sdpa_causal, attention._sdpa_causal_whole):
        out = form(q, k, v)
        errs[form.__name__] = [out.detach()] + list(
            torch.autograd.grad(out, (q, k, v), g))
        del out
    got = errs.pop("_sdpa_causal")
    want = errs.pop("_sdpa_causal_whole")
    rel = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        rel[name] = float((a.float() - b.float()).abs().max()
                          / b.float().abs().max())
    del q, k, v, g, got, want
    torch.cuda.empty_cache()
    if not max(rel.values()) <= ATTN_STREAM_RTOL:
        raise AssertionError(f"the streamed attention is {rel} off the whole "
                             f"score-matrix form (rtol {ATTN_STREAM_RTOL})")
    return {"rel_err": rel, "rtol": ATTN_STREAM_RTOL}


def _lm_isolated_ms() -> dict:
    """Attention and the loss at the full-width cell's shapes, each timed
    alone (CUDA events, eager): `_sdpa_causal` forward, and forward with
    backward, at one layer's (B=1, S=4096, H=32, KH=8, D=128, bf16); the
    loss forward with backward at the logits' (1, 4096, 128256) bf16. A
    step runs attention's forward twice a layer (the checkpoint's
    recompute) and its backward once, for each pod and layer."""
    import torch

    from repro_torch.models import attention, common

    gen = torch.Generator(device="cuda").manual_seed(7)
    q = _randn(gen, (1, 4096, 32, 128), torch.bfloat16).requires_grad_()
    k = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    v = _randn(gen, (1, 4096, 8, 128), torch.bfloat16).requires_grad_()
    g = _randn(gen, (1, 4096, 32, 128), torch.bfloat16)

    def attn_fwd():
        with torch.no_grad():
            attention._sdpa_causal(q, k, v)

    def attn_fwd_bwd():
        torch.autograd.grad(attention._sdpa_causal(q, k, v), (q, k, v), g)

    fwd = time_ms(attn_fwd, reps=5, inner=2, graph=False)["device"]
    fwd_bwd = time_ms(attn_fwd_bwd, reps=5, inner=2, graph=False)["device"]
    del q, k, v, g
    logits = _randn(gen, (1, 4096, 128256), torch.bfloat16).requires_grad_()
    labels = torch.randint(0, 128256, (1, 4096), generator=gen,
                           device="cuda")
    loss = time_ms(lambda: torch.autograd.grad(
        common.cross_entropy_loss(logits, labels), logits),
        reps=5, inner=2, graph=False)["device"]
    del logits
    torch.cuda.empty_cache()
    return {"attention_fwd_ms": fwd, "attention_fwd_bwd_ms": fwd_bwd,
            "attention_step_ms": 2 * LM_N_SUPER * (fwd + fwd_bwd),
            "loss_fwd_bwd_ms": loss, "loss_step_ms": 2 * loss}


def phase_lm() -> dict:
    """The launch backend on the card: llama3-8b at full width, two pods
    stacked, through repro_torch.run (every launch count set to 0 just
    before and read just after); K1 at its LM call; a smoke-width run on
    the card against the CPU; the dry-run manifest. Returns K1's launches
    in the full-width run and its numbers at the LM call."""
    import dataclasses
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch
    from repro_torch.convert import assert_results_match
    from repro_torch.kernels import gossip_mix
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    import repro_torch.optim as optim_mod

    torch.cuda.empty_cache()
    k1_call = _lm_k1_call()
    emit("lm_k1_call", **k1_call)
    emit("lm_attention", **_lm_attention_check())

    full = dataclasses.replace(registry.get_config("llama3-8b", "full"),
                               n_super=LM_N_SUPER)
    real_get_config = registry.get_config
    real_steps = train_mod.make_consensus_steps
    real_adamw = optim_mod.adamw
    seen = {"mixes": 0, "profile": None}

    def cut_config(arch, variant="full"):
        if (arch, variant) == ("llama3-8b", "full"):
            return full
        return real_get_config(arch, variant)

    adamw_events = []

    def labelled_adamw(*a, **kw):
        opt = real_adamw(*a, **kw)

        def update_(grads, state, params):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with record_function("lm:adamw"):
                out = opt.update_(grads, state, params)
            end.record()
            adamw_events.append((start, end))
            return out
        return dataclasses.replace(opt, update_=update_)

    def watched_steps(*a, **kw):
        local, mix, fused = real_steps(*a, **kw)

        def checked_fused(params, opt_state, batch):
            seen["mixes"] += 1
            if seen["mixes"] == 2:  # the second comm step, profiled
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    out = fused(params, opt_state, batch)
                    torch.cuda.synchronize()
                seen["profile"] = _lm_profile_split(prof, "adamw")
            else:
                out = fused(params, opt_state, batch)
            for leaf in torch.utils._pytree.tree_leaves(out[0]):
                if not torch.equal(leaf[0], leaf[1]):
                    raise AssertionError("the two pods differ after the "
                                         "mix (complete graph, n = 2)")
            return out
        return local, mix, checked_fused

    spec = _lm_spec("lm_full", "full", (2, 1, 1),
                    {"kind": "complete", "params": {}}, T=6,
                    batch_per_node=1, seq_len=4096)
    registry.get_config = cut_config
    train_mod.make_consensus_steps = watched_steps
    optim_mod.adamw = labelled_adamw
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        result = repro_torch.run(spec, device="cuda")
        torch.cuda.synchronize()
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
    finally:
        registry.get_config = real_get_config
        train_mod.make_consensus_steps = real_steps
        optim_mod.adamw = real_adamw
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    rounds = result.extras["comm_rounds"]
    if counts["gossip_mix"] != LM_LEAVES * rounds or rounds != 2 or \
            sum(counts.values()) != counts["gossip_mix"]:
        raise AssertionError(f"the full-width LM run launched {counts} for "
                             f"{rounds} comm steps of {LM_LEAVES} leaves")
    if seen["mixes"] != rounds:
        raise AssertionError(f"{seen['mixes']} fused steps for {rounds} "
                             f"rounds")
    _lm_host_fields(result, n=2, k=1, r=0.05)
    if result.extras["param_bytes"] != 3846324224.0:
        raise AssertionError(f"param_bytes {result.extras['param_bytes']}")
    if peak > LM_PEAK_CAP_GIB * 2 ** 30:
        raise AssertionError(f"peak {peak} bytes above {LM_PEAK_CAP_GIB} "
                             f"GiB at n_super={LM_N_SUPER}")
    walls = result.extras["step_walls"]
    comm = result.extras["step_comm"]
    # AdamW's device time a step (two pods, one update each), by events
    adamw_ms = [sum(s.elapsed_time(e) for s, e in adamw_events[i:i + 2])
                for i in range(0, len(adamw_events), 2)]
    isolated = _lm_isolated_ms()
    # K1 over a comm step's leaves: each pod's parameters read once and
    # written once, from the run's own parameter bytes
    step_bytes = 2 * 2 * result.extras["param_bytes"]
    emit("lm_full", n_super=LM_N_SUPER, seq_len=4096, n_pods=2,
         losses=result.trace.fvals, k1_launches=counts["gossip_mix"],
         k1_forms_launched=forms, param_bytes=result.extras["param_bytes"],
         k1_comm_step_bound_ms=_bound(step_bytes, 0.0)["bound_ms"],
         peak_allocated_gib=peak / 2 ** 30, wall_s=result.wall_s,
         step_walls_s=walls, step_comm=comm,
         local_step_s=[w for w, c in zip(walls[1:], comm[1:]) if not c],
         fused_step_s_unprofiled=walls[2],
         fused_step_profiled_split_ms=seen["profile"],
         adamw_step_ms=adamw_ms, isolated_ms=isolated)

    # card against CPU at the smoke width: mesh (4, 1, 1), expander k = 2
    small = _lm_spec("lm_smoke", "smoke", (4, 1, 1),
                     {"kind": "expander", "params": {"k": 2, "seed": 0}},
                     T=6, batch_per_node=2, seq_len=64)
    _zero_launch_counts()
    card = repro_torch.run(small, device="cuda")
    torch.cuda.synchronize()
    small_k1 = _launch_counts()["gossip_mix"]
    cpu = repro_torch.run(small, device="cpu")
    ours, theirs = card.to_dict(), cpu.to_dict()
    rel = max(abs(a - b) / abs(b) for a, b in zip(ours["trace"]["fvals"],
                                                  theirs["trace"]["fvals"]))
    if not rel <= LM_TRACE_RTOL:
        raise AssertionError(f"the smoke LM run's losses on the card are "
                             f"{rel} off the CPU's (rtol {LM_TRACE_RTOL})")
    for side in (ours, theirs):
        side["trace"]["fvals"] = theirs["trace"]["fvals"]
        side["trace"]["fvals_consensus"] = theirs["trace"]["fvals_consensus"]
    assert_results_match(ours, theirs)
    _lm_host_fields(card, n=4, k=2, r=0.05)
    if not card.trace.fvals[-1] < card.trace.fvals[0]:
        raise AssertionError(f"the smoke LM run's loss did not decrease: "
                             f"{card.trace.fvals}")
    if small_k1 != LM_LEAVES * card.extras["comm_rounds"]:
        raise AssertionError(f"the smoke LM run launched K1 {small_k1} "
                             f"times")

    dry = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / "launch_dryrun.json")
    dry_card = repro_torch.run(dry, device="cuda").to_dict()
    assert_results_match(dry_card, repro_torch.run(dry, device="cpu")
                         .to_dict())
    emit("lm_smoke", card_cpu_max_rel=rel, rtol=LM_TRACE_RTOL,
         losses=card.trace.fvals, k1_launches=small_k1,
         dryrun_extras=dry_card["extras"])
    if not all(math.isfinite(v) for v in card.trace.fvals):
        raise AssertionError("smoke LM losses not finite")
    return {"launches": counts["gossip_mix"], "call": k1_call}


#: deepseek-v2's full-width cell: the dense MLA prologue layer and one of
#: its 59 MLA + MoE superblocks (2 of 60 layers), two pods, B = 1 and
#: S = 4096 a pod (train_4k's sequence), T = 6, SGD without momentum
LM_MOE_N_SUPER = 1
LM_MOE_SEQ = 4096
#: leaves of the cut deepseek-v2 tree, each mixed by one K1 launch: embed,
#: final_norm, lm_head; the prologue's 9 MLA and 4 FFN leaves; the
#: superblock's 9 MLA, 5 MoE and 3 shared-expert leaves
LM_MOE_LEAVES = 33
#: a pod's parameter bytes in that tree: 5,357,830,144 bf16 elements and
#: 848,896 float32 ones (the norms and the router)
LM_MOE_PARAM_BYTES = 5357830144 * 2 + 848896 * 4
#: the routed-expert leaf's columns a pod (160 experts x 5120 x 1536)
LM_EXPERT_LEAF = 160 * 5120 * 1536
#: the smoke-width MoE and MLA archs, card against CPU
LM_MOE_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
#: the relative error those runs' losses may show on the card against the
#: CPU: bf16 matmuls accumulate in another order on each, and a router
#: choice near a tie then flips (observed 1.09e-3 for deepseek-v2, with 404
#: of 24,576 choices flipped, above LM_TRACE_RTOL); the standard the CPU
#: tests hold the port's MoE runs to against the reference's
#: (tests/test_torch_launch_moe.py, observed 2.5e-3 there)
LM_MOE_TRACE_RTOL = 5e-3


def phase_lm_k1_expert_leaf() -> dict:
    """K1 at deepseek-v2's routed-expert leaf of two full-width pods (bf16,
    n = 2, k = 1, M = 1,258,291,200), on the empty card before the cell,
    against its plain version bit for bit; timed beside it and
    torch.matmul(P, z), its bound from bytes read once and written once."""
    import torch

    from repro_torch.kernels import gossip_mix

    torch.cuda.empty_cache()
    before = dict(gossip_mix.FORM_LAUNCHES)
    call = _lm_k1_call(M=LM_EXPERT_LEAF, seed=21, plain_graph=False)
    forms = {form: gossip_mix.FORM_LAUNCHES[form] - before[form]
             for form in before}
    emit("lm_k1_expert_leaf", n=2, k=1, M=LM_EXPERT_LEAF,
         forms_launched=forms, **call)
    if forms["slab"] or not forms["regs"]:
        raise AssertionError(f"K1 at the expert leaf ran {forms}, not the "
                             f"register kernel alone (n (k + 1) = 4)")
    return call


def _lm_profile_split(prof, optimizer: str) -> dict:
    """Device time (ms) of one profiled fused step by kind, from the
    profiler's kernel events: K1; the optimizer (kernels inside the GPU
    side of the "lm:<optimizer>" ranges); the matmuls (cuBLAS/CUTLASS
    kernels: the projections, the MoE's expert einsums, attention's
    einsums, the head, forward and backward); the MoE dispatch and combine
    (gather and scatter kernels: the gathers forward, their scatter-adds
    backward, and the loss's small gather); attention (the rest of the
    kernels launched by an op with a 5-D input, as the profiler ties each
    kernel to the op that launched it: the streamed attention's score
    chunks and carries, the only 5-D tensors of the models); the rest
    (norms, rope, the FFNs' and router's elementwise work, the loss, the
    embedding, gradient sums, copies). Needs a profile taken with
    record_shapes=True."""
    from torch.autograd import DeviceType

    def kind_of(name: str) -> str:
        if "gossip_mix" in name:
            return "k1"
        if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet",
                                   "cublas")):
            return "matmul"
        if "gather" in name or "scatter" in name:
            return "moe_gather"
        return "other"

    kernels, windows, attention = [], [], 0.0
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU:
            shapes = getattr(evt, "input_shapes", None) or ()
            if any(isinstance(sh, (list, tuple)) and len(sh) == 5
                   for sh in shapes):
                attention += sum(k.duration for k in evt.kernels
                                 if kind_of(k.name.lower()) == "other")
            continue
        if evt.device_type != DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        if evt.name.startswith("lm:"):
            windows.append(span)
        else:
            kernels.append((evt.name.lower(), span))
    split = {"k1": 0.0, optimizer: 0.0, "matmul": 0.0, "moe_gather": 0.0,
             "attention": attention / 1e3, "other": -attention / 1e3}
    for name, (t0, t1) in kernels:
        kind = kind_of(name)
        if kind != "k1" and any(w0 <= t0 < w1 for w0, w1 in windows):
            kind = optimizer
        split[kind] += (t1 - t0) / 1e3
    split["total"] = sum(split.values())
    split["kernels"] = len(kernels)
    split[f"{optimizer}_windows"] = len(windows)
    return split


def phase_lm_moe_full() -> dict:
    """deepseek-v2 at its published widths (MLA, 160 routed experts at
    top-6 with 2 shared, bf16) cut to 2 of its 60 layers, two pods stacked
    on the card, B = 1 and S = 4096 a pod, complete graph, periodic h = 2,
    T = 6, seed 0, through `launch.train.train_consensus_lm` with SGD
    without momentum (AdamW's float32 moments for two pods, 85.7 GB, do
    not fit the card), every launch count set to 0 just before and read
    just after: losses finite, the pods bitwise equal after each mix, K1
    once a leaf a comm step (33 leaves) and all on its register kernel,
    param_bytes the tree's, peak memory under LM_PEAK_CAP_GIB. Prints the
    step walls, the peak, K1's time a comm step against its bound, the
    dropped assignments of each MoE call (those in the overflow slot E*C)
    and the second fused step's device time by kind."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import optim
    from repro_torch.core.schedules import Periodic
    from repro_torch.kernels import gossip_mix
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config("deepseek-v2-236b",
                                                  "full"),
                              n_super=LM_MOE_N_SUPER)
    seen = {"mixes": 0, "profile": None, "leaves": set()}
    drops = []
    real_steps = train_mod.make_consensus_steps
    real_dispatch = mlp_mod._dispatch_indices

    def counting_dispatch(ids, num_experts, capacity):
        dest = real_dispatch(ids, num_experts, capacity)
        drops.append((dest == num_experts * capacity).sum())  # no sync
        return dest

    def watched_steps(*a, **kw):
        local, mix, fused = real_steps(*a, **kw)

        def checked_fused(params, opt_state, batch):
            seen["mixes"] += 1
            if seen["mixes"] == 2:  # the second comm step, profiled
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    out = fused(params, opt_state, batch)
                    torch.cuda.synchronize()
                seen["profile"] = _lm_profile_split(prof, "sgd")
            else:
                out = fused(params, opt_state, batch)
            leaves = torch.utils._pytree.tree_leaves(out[0])
            seen["leaves"].add(len(leaves))
            for leaf in leaves:
                if not torch.equal(leaf[0], leaf[1]):
                    raise AssertionError("the two pods differ after the "
                                         "mix (complete graph, n = 2)")
            return out
        return local, mix, checked_fused

    sgd = optim.sgd(optim.cosine_lr(3e-4, 6))

    def labelled_update_(grads, state, params):
        with record_function("lm:sgd"):
            sgd.update_(grads, state, params)
    opt = dataclasses.replace(sgd, update_=labelled_update_)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device="cuda")
    train_mod.make_consensus_steps = watched_steps
    mlp_mod._dispatch_indices = counting_dispatch
    try:
        _zero_launch_counts()
        t0 = time.perf_counter()
        report = train_mod.train_consensus_lm(
            cfg, opt, mesh, steps=6, schedule=Periodic(h=2),
            topology="complete", batch_per_node=1, seq_len=LM_MOE_SEQ,
            seed=0, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        forms = dict(gossip_mix.FORM_LAUNCHES)
    finally:
        train_mod.make_consensus_steps = real_steps
        mlp_mod._dispatch_indices = real_dispatch
    peak = torch.cuda.max_memory_allocated()
    drops = [int(d) for d in drops]
    torch.cuda.empty_cache()
    rounds = report.comm_rounds
    launches = counts["gossip_mix"]
    if launches != LM_MOE_LEAVES * rounds or rounds != 2 or \
            sum(counts.values()) != launches:
        raise AssertionError(f"the MoE cell launched {counts} for {rounds} "
                             f"comm steps of {LM_MOE_LEAVES} leaves")
    if forms != {"regs": launches, "slab": 0}:
        raise AssertionError(f"K1 ran {forms} in the MoE cell, not the "
                             f"register kernel alone")
    if seen["mixes"] != rounds or seen["leaves"] != {LM_MOE_LEAVES}:
        raise AssertionError(f"{seen['mixes']} fused steps with "
                             f"{seen['leaves']} leaves for {rounds} rounds")
    if report.extras["param_bytes"] != LM_MOE_PARAM_BYTES:
        raise AssertionError(f"param_bytes {report.extras['param_bytes']}")
    if not all(math.isfinite(v) for v in report.losses):
        raise AssertionError(f"MoE cell losses not finite: {report.losses}")
    if peak > LM_PEAK_CAP_GIB * 2 ** 30:
        raise AssertionError(f"peak {peak} bytes above {LM_PEAK_CAP_GIB} "
                             f"GiB at S={LM_MOE_SEQ}")
    calls = 2 * 6 * 2 * LM_MOE_N_SUPER  # pods, steps, forward + recompute
    if len(drops) != calls:
        raise AssertionError(f"{len(drops)} MoE calls, not {calls}")
    walls, comm = report.extras["step_walls"], report.extras["step_comm"]
    step_bytes = 2 * 2 * report.extras["param_bytes"]
    split = seen["profile"]
    emit("lm_moe_full", arch=cfg.name, n_super=LM_MOE_N_SUPER,
         seq_len=LM_MOE_SEQ, n_pods=2, optimizer="sgd",
         losses=report.losses, k1_launches=launches,
         k1_forms_launched=forms, leaves=LM_MOE_LEAVES,
         param_bytes=report.extras["param_bytes"],
         k1_comm_step_ms=split["k1"],
         k1_comm_step_bound_ms=_bound(step_bytes, 0.0)["bound_ms"],
         peak_allocated_gib=peak / 2 ** 30, wall_s=wall,
         step_walls_s=walls, step_comm=comm,
         local_step_s=[w for w, c in zip(walls[1:], comm[1:]) if not c],
         fused_step_s_unprofiled=walls[2],
         capacity=mlp_mod.moe_capacity(cfg, LM_MOE_SEQ),
         assignments_per_call=LM_MOE_SEQ * cfg.moe_top_k,
         dropped_per_call=drops, fused_step_profiled_split_ms=split)
    return {"launches": launches, "k1_comm_step_ms": split["k1"]}


def phase_lm_moe_smoke() -> dict:
    """deepseek-v2 and llama4-maverick at smoke width through
    repro_torch.run at mesh (4, 1, 1), expander k = 2, with the runner's
    AdamW, on the card (every launch count set to 0 just before and read
    just after) and on the CPU: host fields exact, losses within
    LM_MOE_TRACE_RTOL, K1 once a leaf a comm round. Prints, per arch, the
    router's top-K choices that differ between card and CPU. Returns K1's
    launches by arch."""
    import torch

    import repro_torch
    from repro_torch.compress import prng
    from repro_torch.convert import assert_results_match
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import registry, transformer

    torch.cuda.empty_cache()
    real_top = mlp_mod._top_indices
    launches = {}
    for arch in LM_MOE_ARCHS:
        spec = _lm_spec("lm_moe_smoke", "smoke", (4, 1, 1),
                        {"kind": "expander", "params": {"k": 2, "seed": 0}},
                        T=6, batch_per_node=2, seq_len=64, arch=arch)
        choices = {"cuda": [], "cpu": []}
        results = {}
        for device in ("cuda", "cpu"):
            def recording_top(probs, k, side=choices[device]):
                ids = real_top(probs, k)
                side.append(ids.cpu())
                return ids
            mlp_mod._top_indices = recording_top
            try:
                _zero_launch_counts()
                results[device] = repro_torch.run(spec, device=device)
                if device == "cuda":
                    torch.cuda.synchronize()
                    counts = _launch_counts()
            finally:
                mlp_mod._top_indices = real_top
        card, cpu = results["cuda"], results["cpu"]
        ours, theirs = card.to_dict(), cpu.to_dict()
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            ours["trace"]["fvals"], theirs["trace"]["fvals"]))
        flips = sum(int((a != b).sum()) for a, b in zip(choices["cuda"],
                                                        choices["cpu"]))
        total = sum(a.numel() for a in choices["cpu"])
        leaves = len(torch.utils._pytree.tree_leaves(transformer.init(
            prng.key(0, "cpu"), registry.get_config(arch, "smoke"))[0]))
        emit("lm_moe_smoke", arch=arch, card_cpu_max_rel=rel,
             rtol=LM_MOE_TRACE_RTOL, losses=card.trace.fvals,
             cpu_losses=cpu.trace.fvals, k1_launches=counts["gossip_mix"],
             leaves=leaves, router_choices=total,
             router_choices_card_cpu_differ=flips,
             moe_calls=len(choices["cuda"]))
        if len(choices["cuda"]) != len(choices["cpu"]) or not total:
            raise AssertionError(f"{arch}: the card made "
                                 f"{len(choices['cuda'])} MoE calls, the "
                                 f"CPU {len(choices['cpu'])}")
        if not rel <= LM_MOE_TRACE_RTOL:
            raise AssertionError(f"{arch}: the smoke run's losses on the card "
                                 f"are {rel} off the CPU's (rtol "
                                 f"{LM_MOE_TRACE_RTOL})")
        for side in (ours, theirs):
            side["trace"]["fvals"] = theirs["trace"]["fvals"]
            side["trace"]["fvals_consensus"] = theirs["trace"][
                "fvals_consensus"]
        assert_results_match(ours, theirs)
        _lm_host_fields(card, n=4, k=2, r=0.05)
        if counts["gossip_mix"] != leaves * card.extras["comm_rounds"] or \
                sum(counts.values()) != counts["gossip_mix"]:
            raise AssertionError(f"{arch}: the smoke run launched {counts} "
                                 f"for {card.extras['comm_rounds']} rounds "
                                 f"of {leaves} leaves")
        launches[arch] = counts["gossip_mix"]
    return launches


def phase_kernel_k3() -> dict:
    """K3 (the flat per-node mix) against its plain version on the card,
    then its front door at full width, then its times."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def cases():
        for M in (1, 3, 130, 4099, 8192, 65537, 1 << 20):
            for k in (1, 4, 8):
                for dtype in (torch.float32, torch.bfloat16):
                    for off in (0, 1):
                        # a view one element in is not 16-byte aligned: the
                        # kernel takes its scalar path
                        sb = _randn(gen, (M + off,), dtype)[off:]
                        nb = _randn(gen, (k * M + off,), dtype)[off:] \
                            .view(k, M)
                        yield (f"M={M} k={k} {dtype} offset={off}",
                               (sb, nb, 0.2, 0.8 / k),
                               str(dtype).split(".")[1])

    _check_grid("gossip_mix_flat", "K3", cases(), ops.gossip_mix,
                ref.gossip_mix_ref,
                {"float32": FP32_TOL, "bfloat16": BF16_TOL})

    # full width: one llama3-8b decoder layer's parameters, flattened
    # (configs/llama3_8b.py: q, k, v, o 41,943,040 + SwiGLU 176,160,768 +
    # two norms 8,192), k = 4 received buffers, fp32
    M, k, sw, ew = 218_112_000, 4, 0.2, 0.2
    args = (_randn(gen, (M,)), _randn(gen, (k, M)), sw, ew)
    sb, nb = args[:2]
    launches, err = _full_width("gossip_mix_flat", "K3", ops.gossip_mix,
                                ref.gossip_mix_ref, args, FP32_TOL)
    ew_vec = torch.full((k,), ew, device="cuda")
    _hold("torch.addmv", torch.addmv(sb, nb.T, ew_vec, beta=sw),
          ref.gossip_mix_ref(*args), FP32_TOL)
    kernel_t = time_ms(lambda: ops.gossip_mix(*args), reps=10, inner=5)
    plain_t = time_ms(lambda: ref.gossip_mix_ref(*args), reps=5, inner=2)
    library_t = time_ms(lambda: torch.addmv(sb, nb.T, ew_vec, beta=sw),
                        reps=5, inner=2)
    # self and the k buffers read once, out written once; k + 2 flops an
    # element (k - 1 adds, two products, one add)
    numbers = _report(
        "gossip_mix_flat", "gossip_mix.cu",
        "src/repro/kernels/gossip_mix.py:46", launches, err, kernel_t,
        plain_t, library_t, nbytes=(k + 2) * M * 4, flops=(k + 2) * M,
        shape={"M": M, "k": k, "dtype": "float32"},
        library_call="torch.addmv(self, nbrs.T, full(k, ew), beta=sw)")
    del args, sb, nb
    torch.cuda.empty_cache()
    return numbers


def _attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(row, column) pairs the mask keeps: all of them, or under the
    top-left causal mask min(r + 1, Sk) for row r."""
    if not causal:
        return Sq * Sk
    full = max(Sq - Sk, 0) * Sk
    tri = min(Sq, Sk)
    return tri * (tri + 1) // 2 + full


def phase_kernel_k4(build_s: dict) -> dict:
    """K4 (flash attention) against its plain version on the card, each case
    on the route `flash_attention.route` names, then its front door at full
    width in bf16 (the sm90 route), the sm90 kernel's fp32-out entry and the
    fp32 route on fp32 copies, then its times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    shapes = []
    for S, D, H, KH in ((128, 64, 4, 4), (256, 64, 8, 2), (256, 128, 4, 1),
                        (512, 32, 2, 2)):   # tests/test_kernels.py:17-22
        for causal in (True, False):
            shapes.append((2, H, KH, S, S, D, causal))
    for Sq, Sk in ((128, 256), (256, 128), (128, 512), (100, 100)):
        for causal in (True, False):
            shapes.append((1, 4, 2, Sq, Sk, 64, causal))
    for D in (16, 48, 80, 96, 160, 192, 256):
        shapes.append((1, 2, 1, 128, 128, D, True))
    # D not a multiple of 8: bf16 too takes the tf32x3 route, staged with
    # a conversion; D = 1 and 12 rows go 4 bytes a copy in fp32
    for D in (1, 12, 100):
        shapes.append((1, 4, 2, 128, 128, D, True))
    shapes.append((1, 32, 32, 256, 256, 80, True))   # zamba2-2.7b's heads

    def cases():
        for B, H, KH, Sq, Sk, D, causal in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                yield (f"B={B} H={H} KH={KH} Sq={Sq} Sk={Sk} D={D} "
                       f"causal={causal} {dtype}",
                       (_randn(gen, (B, H, Sq, D), dtype),
                        _randn(gen, (B, KH, Sk, D), dtype),
                        _randn(gen, (B, KH, Sk, D), dtype), causal),
                       str(dtype).split(".")[1])

    grid_routes = {"sm90": 0, "tf32x3": 0}

    def door(q, k, v, causal=True):
        """The front door, which must launch once on the route's kernel."""
        want = fa.route(q.dtype, q.shape[-1])
        before = _route_counts()
        out = ops.flash_attention(q, k, v, causal=causal)
        moved = {r: n - before[r] for r, n in _route_counts().items()}
        if moved != {r: int(r == want) for r in moved}:
            raise AssertionError(f"K4 on {q.dtype} D={q.shape[-1]} should "
                                 f"launch once on {want}, launched {moved}")
        grid_routes[want] += 1
        return out

    def plain(q, k, v, causal=True):
        return ref.flash_attention_ref(q, k, v, causal=causal)

    _check_grid("flash_attention", "K4", cases(), door, plain, ATTN_TOL)
    grid_taken = dict(grid_routes)  # the grid's; calls below add more
    sm90_cases = sum(shape[5] % 8 == 0 for shape in shapes)
    if grid_taken != {"sm90": sm90_cases,
                      "tf32x3": 2 * len(shapes) - sm90_cases}:
        raise AssertionError(f"K4's grid took the routes {grid_taken}: "
                             f"every bf16 case with D % 8 == 0 on sm90, "
                             f"every other case on tf32x3")

    # full width: llama3-8b's attention (configs/llama3_8b.py: 32 heads, 8
    # kv heads, head dim 128) at train_4k (configs/shapes.py), bf16, causal
    B, H, KH, S, D = 1, 32, 8, 4096, 128
    q, k, v = (_randn(gen, (B, h, S, D), torch.bfloat16)
               for h in (H, KH, KH))
    launches, err = _full_width("flash_attention", "K4", door, plain,
                                (q, k, v), ATTN_TOL["bfloat16"])
    routes = _route_counts()
    if routes != {"sm90": 1, "tf32x3": 0}:
        raise AssertionError(f"K4 at full width took the routes {routes}")
    # the same inputs as exact fp32 copies, held to the fp32 tolerance: the
    # sm90 kernel with an fp32 output (a kernel that rounded P to bf16 would
    # be about 1e-3 off, against rtol 2e-4), and the fp32 route's kernel
    copies = (q.float(), k.float(), v.float())
    expect32 = plain(*copies)
    err_fp32_out = _hold("K4 sm90 fp32-out at full width on fp32 copies",
                         fa._flash_attention_fp32_out(q, k, v), expect32,
                         ATTN_TOL["float32"])
    err_fp32 = _hold("K4 fp32 route at full width on fp32 copies",
                     door(*copies), expect32, ATTN_TOL["float32"])
    kr = k.repeat_interleave(H // KH, dim=1)
    vr = v.repeat_interleave(H // KH, dim=1)
    kr32, vr32 = kr.float(), vr.float()
    err_fp32_library = _max_err(F.scaled_dot_product_attention(
        copies[0], kr32, vr32, is_causal=True), expect32)
    del expect32
    kernel_t = time_ms(lambda: ops.flash_attention(q, k, v), reps=10,
                       inner=3)
    plain_t = time_ms(lambda: plain(q, k, v), reps=5, inner=2)
    library_t = time_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), reps=10, inner=5)
    fp32_out_t = time_ms(lambda: fa._flash_attention_fp32_out(q, k, v),
                         reps=10, inner=3)
    fp32_route_t = time_ms(lambda: ops.flash_attention(*copies), reps=5,
                           inner=2)
    fp32_plain_t = time_ms(lambda: plain(*copies), reps=5, inner=2)
    # the library call on the fp32 copies: the fp32 route's yardstick
    fp32_library_t = time_ms(lambda: F.scaled_dot_product_attention(
        copies[0], kr32, vr32, is_causal=True), reps=10, inner=3)
    del kr32, vr32
    del copies
    torch.cuda.empty_cache()
    # q, k, v read once, out written once; 4 D flops (q.k and p v) for
    # each (row, column) pair the causal mask keeps: the reference's work;
    # the sm90 kernel's split does P V twice, 6 D flops a pair
    pairs = B * H * _attention_pairs(S, S, True)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KH * S * D)
    flops = 4 * D * pairs
    numbers = _report(
        "flash_attention", "flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:79", launches, err, kernel_t,
        plain_t, library_t, nbytes, flops, BF16_FLOPS,
        shape={"B": B, "H": H, "KH": KH, "Sq": S, "Sk": S, "D": D,
               "dtype": "bfloat16", "causal": True},
        route_launches=routes, grid_routes=grid_taken,
        max_abs_err_fp32_out=err_fp32_out,
        max_abs_err_fp32_route=err_fp32,
        bound_basis="the reference's work, 4 D flops a kept pair, on the "
                    "bf16 tensor cores at 989 TFLOP/s",
        split_flops=6 * D * pairs,
        split_bound_ms=_bound(nbytes, 6 * D * pairs, BF16_FLOPS)["bound_ms"],
        fp32_out_ms=fp32_out_t["device"],
        fp32_route_ms=fp32_route_t["device"],
        fp32_route_plain_ms=fp32_plain_t["device"],
        fp32_route_bound_ms=_bound(2 * nbytes, flops, FP32_FLOPS)["bound_ms"],
        fp32_route_tf32_bound_ms=_bound(2 * nbytes, flops,
                                        TF32_FLOPS)["bound_ms"],
        fp32_route_library_ms=fp32_library_t["device"],
        fp32_route_library_max_abs_err=err_fp32_library,
        fp32_route_tf32x3_floor_ms=_bound(0, 3 * flops,
                                          TF32_FLOPS)["bound_ms"],
        build_s={name: build_s[name] for name in
                 ("flash_attention_sm90", "flash_attention")},
        library_call="F.scaled_dot_product_attention(q, k, v, "
                     "is_causal=True), K and V repeated per group outside "
                     "the timed window")
    del q, k, v, kr, vr
    return numbers


def _scan_inputs(gen, x_shape, dt_shape, A_shape, B_shape):
    """tests/test_kernels.py's distributions: x ~ 0.5 N, dt = softplus(N -
    1), A = -exp(0.3 N) < 0, B and C ~ 0.5 N."""
    import torch
    import torch.nn.functional as F

    x = _randn(gen, x_shape, scale=0.5)
    dt = F.softplus(_randn(gen, dt_shape) - 1.0)
    A = -torch.exp(_randn(gen, A_shape, scale=0.3))
    return x, dt, A, _randn(gen, B_shape, scale=0.5), \
        _randn(gen, B_shape, scale=0.5)


#: the plain scans issue a few launches per token; their timing windows
PLAIN_SCAN_TIMING = dict(reps=3, inner=1, graph=False, warmup=1)
PLAIN_SCAN_NOTE = ("eager, median of 3 windows of one call after one "
                   "warm-up: the plain loop issues several launches per "
                   "token, too many to capture in a graph")


def _ssd_flops(Bt: int, S: int, H: int, P: int, N: int) -> float:
    """The fewest operations of the SSD scan: its chunked form (ssd_scan.cu)
    at the chunk length Q that needs least. Per token and head: 2NP for
    C h0, 2NP + NP/Q for the state update (the decay once a chunk), (Q+1)P
    for the in-chunk product's lower triangle; per token (Q+1)N for C B^T,
    which the heads share. Q = 1 is the recurrence, 5NP; the least is near
    Q = sqrt(N)."""
    return min(Bt * S * (H * (4 * N * P + N * P / Q + (Q + 1) * P)
                         + (Q + 1) * N)
               for Q in range(1, S + 1))


def _capped(name: str, err: float) -> None:
    """Raise unless the full-width error `err` of `name` is within its
    SCAN_CAP; emit the check."""
    if not err <= SCAN_CAP[name]:
        raise AssertionError(f"{name} at full width is {err} off the plain "
                             f"version, over its cap {SCAN_CAP[name]}")
    emit("error_cap", name=name, max_abs_err=err, cap=SCAN_CAP[name])


def phase_kernel_k5() -> dict:
    """K5 (the SSD scan) against its plain version on the card, then its
    front door at full width, then its times."""
    import torch

    from repro_torch.kernels import ops, ref, ssd_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def cases():
        for Bt, S, H, P, N in ((2, 256, 4, 32, 16), (2, 512, 2, 64, 64),
                               (2, 128, 8, 64, 32),  # tests/test_kernels.py:65
                               (1, 100, 3, 40, 6), (1, 128, 2, 80, 128),
                               (1, 1024, 2, 64, 64),
                               # long S at a narrow width (64 chunks), the
                               # 32-token chunks of N > 128, MAX_N, each
                               # with a ragged last chunk
                               (1, 4096, 2, 32, 16), (1, 100, 3, 72, 136),
                               (1, 120, 2, 64, ssd_scan.MAX_N),
                               # odd P, P N % 4 != 0: x staged and y
                               # stored a float at a time, the state pass
                               # one element a thread
                               (1, 128, 2, 37, 5)):
            yield ((Bt, S, H, P, N),
                   _scan_inputs(gen, (Bt, S, H, P), (Bt, S, H), (H,),
                                (Bt, S, N)), "float32")

    _check_grid("ssd_scan", "K5", cases(), ops.ssd_scan, ref.ssd_scan_ref,
                {"float32": SCAN_TOL})

    # full width: zamba2-2.7b's Mamba-2 mixer (configs/zamba2_2_7b.py:
    # d_inner 5120 = 80 heads of 64, state 64) over 4096 tokens, fp32
    Bt, S, H, P, N = 1, 4096, 80, 64, 64
    args = _scan_inputs(gen, (Bt, S, H, P), (Bt, S, H), (H,), (Bt, S, N))
    launches, err = _full_width("ssd_scan", "K5", ops.ssd_scan,
                                ref.ssd_scan_ref, args, SCAN_TOL)
    kernels = ssd_scan.KERNELS  # counted by the library in that one call
    _capped("ssd_scan", err)
    how = ssd_scan.LAST_PLAN
    kernel_t = time_ms(lambda: ops.ssd_scan(*args), reps=10, inner=5)
    plain_t = time_ms(lambda: ref.ssd_scan_ref(*args), **PLAIN_SCAN_TIMING)
    # x, dt, A, B, C read once, y written once
    nbytes = 4 * (2 * Bt * S * H * P + Bt * S * H + H + 2 * Bt * S * N)
    return _report(
        "ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:69",
        launches, err, kernel_t, plain_t, None, nbytes=nbytes,
        flops=_ssd_flops(Bt, S, H, P, N),
        entry={"kernels_per_call": kernels / launches, "chunk": how["chunk"],
               "heads_per_block": how["heads_per_block"],
               "workspace_bytes": how["workspace_bytes"],
               "bytes_bound_ms": _bound(nbytes, 0)["bound_ms"]},
        shape={"Bt": Bt, "S": S, "H": H, "P": P, "N": N,
               "dtype": "float32"},
        plain_timing=PLAIN_SCAN_NOTE, library_call=None)


def phase_kernel_k6() -> dict:
    """K6 (the selective scan) against its plain version on the card, then
    its front door at full width, then its times."""
    import torch

    from repro_torch.kernels import ops, ref, selective_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)

    def cases():
        for Bt, S, d, N in ((2, 256, 128, 8), (2, 512, 256, 16),
                            (2, 256, 512, 16),  # tests/test_kernels.py:48-49
                            (1, 200, 100, 3), (1, 256, 1024, 1),
                            (1, 512, 64, 32), (1, 256, 96, 64),
                            # long S at a narrow width: 64 pieces and a carry
                            (1, 4096, 64, 16),
                            # odd d: x and dt staged 4 bytes a copy
                            (1, 256, 37, 3)):
            yield ((Bt, S, d, N),
                   _scan_inputs(gen, (Bt, S, d), (Bt, S, d), (d, N),
                                (Bt, S, N)) + (_randn(gen, (d,)),),
                   "float32")

    _check_grid("selective_scan", "K6", cases(), ops.selective_scan,
                ref.selective_scan_ref, {"float32": SCAN_TOL})

    # full width: falcon-mamba-7b's mixer (configs/falcon_mamba_7b.py:
    # d_inner = 2 x 4096, state 16) over 4096 tokens, fp32
    Bt, S, d, N = 1, 4096, 8192, 16
    args = _scan_inputs(gen, (Bt, S, d), (Bt, S, d), (d, N), (Bt, S, N)) \
        + (torch.ones((d,), device="cuda"),)
    launches, err = _full_width("selective_scan", "K6", ops.selective_scan,
                                ref.selective_scan_ref, args, SCAN_TOL)
    kernels = selective_scan.KERNELS  # counted by the library in that call
    _capped("selective_scan", err)
    how = selective_scan.LAST_PLAN
    kernel_t = time_ms(lambda: ops.selective_scan(*args), reps=10, inner=5)
    plain_t = time_ms(lambda: ref.selective_scan_ref(*args),
                      **PLAIN_SCAN_TIMING)
    # x, dt, A, B, C, D read once, y written once; 7 operations for each
    # (token, channel, n): dt * A, its exp, two products and an add for the
    # state, a product and an add for y
    return _report(
        "selective_scan", "selective_scan.cu",
        "src/repro/kernels/selective_scan.py:54", launches, err, kernel_t,
        plain_t, None,
        nbytes=4 * (3 * Bt * S * d + d * N + 2 * Bt * S * N + d),
        flops=7 * Bt * S * d * N,
        entry={"kernels_per_call": kernels / launches,
               "nsplit": how["nsplit"], "lanes": how["lanes"],
               "workspace_bytes": how["workspace_bytes"]},
        shape={"Bt": Bt, "S": S, "d": d, "N": N, "dtype": "float32"},
        plain_timing=PLAIN_SCAN_NOTE, library_call=None)


def main() -> int:
    import repro_torch  # noqa: F401  (fails outside a checkout)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    env = phase_env()
    build_s = phase_build()
    k1 = phase_kernel()
    k2 = phase_kernel_k2()
    phase_manifests()
    k1["launches"] = phase_main_path()
    k2["launches"] = phase_main_path_compressed()
    sweep = phase_sweep()
    k1["sweep_launches"] = sweep["gossip_mix"]
    k2["sweep_launches"] = sweep["compress_mix"]
    adaptive = phase_adaptive()
    k1["adaptive_launches"] = adaptive["gossip_mix"]
    k2["adaptive_launches"] = adaptive["compress_mix"]
    phase_netsim()
    serve = phase_serve()
    k1["serve_launches"] = serve["gossip_mix"]
    k2["serve_launches"] = serve["compress_mix"]
    lm = phase_lm()
    k1["lm_launches"] = lm["launches"]
    k1["lm_call"] = lm["call"]
    k1["lm_expert_leaf_call"] = phase_lm_k1_expert_leaf()
    lm_moe = phase_lm_moe_full()
    k1["lm_moe_launches"] = lm_moe["launches"]
    k1["lm_moe_comm_step_ms"] = lm_moe["k1_comm_step_ms"]
    k1["lm_moe_smoke_launches"] = phase_lm_moe_smoke()
    k3 = phase_kernel_k3()
    k4 = phase_kernel_k4(build_s)
    k5 = phase_kernel_k5()
    k6 = phase_kernel_k6()
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}), flush=True)
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
