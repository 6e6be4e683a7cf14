"""How the dense closed loop's chunks time on one CUDA card: each body's
chunk wall in steady state, and the first timed chunk (the controller's
only plain sample at h0 = 1) after the card sat idle or busy.

    PYTHONPATH=src python3 scripts/profile_torch_closed_loop.py \
        [--compression {none,topk}] [--chunks 200] [--repeats 3]

The cell is chip_smoke.py's `adaptive` cell: quadratic consensus, n=256,
d=4096, expander k=4, T=300, eval_every=25, sqrt(A=0.5), r=0.01, the
`adaptive` schedule at h0=1 under the `dense_adaptive` controller,
uncompressed (K1) or under top-k at keep 1/4 (K2), captured as CUDA
graphs. Two measurements, each printed as one JSON line:

  steady  the one-lane program loaded once, then `--chunks` one-iteration
          chunks of each body, alternating idle and comm, each timed as
          the closed loop times it (`time.perf_counter` around
          `DDASimulator.run_chunk`, which ends in a device synchronize),
          then `--chunks` / 8 chunks of 24 comm iterations (a comm chunk of
          the closed loop's first segment at h = 1), per iteration: p10,
          p50 and p90 of each in us.
  first   `runner._dense_adaptive_run` on the real clock, `--repeats`
          times for each lead-in and start: the card "idle" for 1 s before
          the loop, or "busy" (the idle body replayed for about 20 ms just
          before); the chunk driver's start (`DDASimulator.start_closed_loop`,
          prime "stats": the statistics body replayed once after the load)
          or one without that replay (prime "none"). It prints the first
          timed chunk (t=1, the plain sample), the comm chunks' p50 per
          iteration, r_hat and the final h, and the SM clock nvidia-smi
          reads after the idle second or before the busy replays.

Then the card's name and power limit as nvidia-smi prints them.
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
                "topk": {"kind": "topk", "params": {"keep": 0.25}}}


def _spec(compression):
    import repro_torch

    return repro_torch.ExperimentSpec(
        name="dense_adaptive_full", T=300, eval_every=25, r=0.01,
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 256, "d": 4096, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "adaptive", "params": {"h0": 1}},
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        compression=compression,
        controller={"kind": "dense_adaptive",
                    "params": {"warmup_comm": 2, "warmup_plain": 1}},
        backends=[{"kind": "dense", "params": {}}])


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _quantiles(us: list[float]) -> dict[str, float]:
    import numpy as np

    q = np.percentile(np.asarray(us), [10, 50, 90])
    return {"p10": float(q[0]), "p50": float(q[1]), "p90": float(q[2]),
            "n": len(us)}


def _build(spec, device):
    from repro_torch.experiments import runner

    parts = runner._dense_parts(spec, spec.backends[0], device)
    sim = runner._dense_sim(spec, parts, device)
    params = dict(spec.controller.params)
    if sim.compression is not None:
        params.setdefault("wire_ratio",
                          sim.wire_ratio(parts["problem"].d))
    return parts, sim, params


def steady(spec, device, chunks: int) -> dict:
    import torch

    parts, sim, _ = _build(spec, device)
    problem = parts["problem"]
    x0 = torch.zeros((problem.n, problem.d), device=device)
    sim.start_closed_loop(x0, spec.T)
    walls = {"idle": [], "comm": [], "comm_24": []}
    for _ in range(chunks):
        for body, comm in (("idle", False), ("comm", True)):
            t0 = time.perf_counter()
            sim.run_chunk(comm, 1)
            walls[body].append((time.perf_counter() - t0) * 1e6)
    for _ in range(max(chunks // 8, 1)):
        t0 = time.perf_counter()
        sim.run_chunk(True, 24)
        walls["comm_24"].append((time.perf_counter() - t0) * 1e6 / 24)
    sim.end_closed_loop()
    return {"loop": sim.last_loop,
            **{body: _quantiles(us) for body, us in walls.items()}}


def _start_unprimed(sim):
    """`sim.start_closed_loop` without its priming replay of the
    statistics body."""
    def start(x0_stack, T):
        sim._check_x0(x0_stack)
        sim._reset_timings()
        prog = sim._program(x0_stack, 1, T)
        sim.last_loop = "eager" if prog.graphs is None else "graph"
        prog.load(x0_stack)
        sim._synchronize()
        sim._loop_prog = prog
    return start


def first(spec, device, lead_in: str, prime: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.adaptive import DenseController
    from repro_torch.experiments import runner

    parts, sim, params = _build(spec, device)
    problem = parts["problem"]
    x0 = torch.zeros((problem.n, problem.d), device=device)
    sim.start_closed_loop(x0, spec.T)  # the capture, outside the lead-in
    sim.end_closed_loop()
    if lead_in == "idle":
        time.sleep(1.0)
        clock = _smi("clocks.sm")
    else:
        clock = _smi("clocks.sm")
        sim.start_closed_loop(x0, spec.T)
        t_end = time.perf_counter() + 0.02
        while time.perf_counter() < t_end:
            sim.run_chunk(False, 20)
        sim.end_closed_loop()
    if prime == "none":
        sim.start_closed_loop = _start_unprimed(sim)
    ctrl = DenseController(parts["schedule"], **params)
    timings = {"compile_s": 0.0, "iter_walls": []}
    runner._dense_adaptive_run(sim, ctrl, x0, spec.T, spec.eval_every,
                               spec.seed, timings=timings)
    walls = np.asarray(timings["iter_walls"]) * 1e6
    return {"lead_in": lead_in, "prime": prime,
            "first_chunk_us": float(walls[0]),
            "comm_p50_us": float(np.median(walls[1:])),
            "r_hat": ctrl.tracker.r_hat,
            "h_final": parts["schedule"].h_current, "sm_clock": clock}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compression", choices=sorted(COMPRESSIONS),
                    default="none")
    ap.add_argument("--chunks", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    spec = _spec(COMPRESSIONS[args.compression])
    print(json.dumps({"row": "steady", "compression": args.compression,
                      **steady(spec, device, args.chunks)}), flush=True)
    for lead_in in ("idle", "busy"):
        for rep in range(args.repeats):
            for prime in ("stats", "none"):
                print(json.dumps({"row": "first",
                                  "compression": args.compression,
                                  "repeat": rep,
                                  **first(spec, device, lead_in, prime)}),
                      flush=True)
    print(_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
