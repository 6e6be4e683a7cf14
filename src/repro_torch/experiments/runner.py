"""`run(spec) -> RunResult` on the port: the dense backend of
`repro.experiments.runner`, in PyTorch.

The dense backend builds the problem, graph, schedule, stepsize and
compressor from the spec, runs `core.dda.DDASimulator` on the requested
device (the CUDA card unless the caller asks for the CPU) and returns the
reference's `RunResult`. `run_sweep` runs a grid of cells serially, as one
batched program (`DDASimulator.run_batch`, parallel="vmap") or across
processes, as the reference's. The netsim and launch backends and the dense
closed loop ("dense_adaptive") are not ported yet: asking for them raises
`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import tradeoff as _tradeoff
from repro_torch.core.dda import DDASimulator, SimTrace, trace_time_to_reach
from repro_torch.core.graphs import CommGraph
from repro_torch.experiments import components as C
from repro_torch.experiments.registry import Registry
from repro_torch.experiments.result import RunResult
from repro_torch.experiments.spec import ComponentSpec, ExperimentSpec
from repro_torch.obs import RunMetrics, Tracer, profile_ctx

#: bytes per scalar in a dense gossip payload (float32)
_DENSE_SCALAR_BYTES = 4

__all__ = ["backends", "batch_compat_report", "run", "run_all",
           "run_sweep"]

backends = Registry("backend")

#: eps the closed-loop predictions are quoted at (L = R = 1 units), matching
#: the reference's convention
PREDICT_EPS = 0.1


# ---------------------------------------------------------------------------
# shared build helpers
# ---------------------------------------------------------------------------


#: built problems, keyed by canonical (kind, params, device) JSON. Problem
#: builders are deterministic and their closures stateless, so instances
#: are safely shared across runs; what the cache buys is F* (lazily
#: computed and instance-cached; for the non-smooth problem an
#: 800-iteration centralized subgradient descent). Bounded FIFO.
_PROBLEM_CACHE: dict[str, Any] = {}
_PROBLEM_CACHE_MAX = 32


def _build_problem(spec: ExperimentSpec, device: torch.device):
    key = json.dumps([spec.problem.kind,
                      sorted(spec.problem.params.items()), str(device)])
    hit = _PROBLEM_CACHE.get(key)
    if hit is None:
        hit = C.build_component(C.problems, spec.problem.kind,
                                spec.problem.params, device=device)
        if len(_PROBLEM_CACHE) >= _PROBLEM_CACHE_MAX:
            _PROBLEM_CACHE.pop(next(iter(_PROBLEM_CACHE)))
        _PROBLEM_CACHE[key] = hit
    return hit


def _build_topology(spec: ExperimentSpec, n: int):
    return C.build_component(C.topologies, spec.topology.kind,
                             spec.topology.params, n=n)


def _build_schedule(spec: ExperimentSpec):
    return C.build_component(C.schedules, spec.schedule.kind,
                             spec.schedule.params)


def _build_stepsize(spec: ExperimentSpec):
    return C.build_component(C.stepsizes, spec.stepsize.kind,
                             spec.stepsize.params)


def _require(condition: bool, msg: str) -> None:
    if not condition:
        raise ValueError(msg)


def _eps_value(spec: ExperimentSpec, problem) -> float | None:
    if spec.eps_frac is None:
        return None
    return problem.eps_value(spec.eps_frac)


def _target_fields(trace: SimTrace, eps_value: float | None
                   ) -> tuple[float | None, float | None]:
    if eps_value is None:
        return None, None
    tta = trace_time_to_reach(trace, eps_value)
    return eps_value, (None if math.isinf(tta) else tta)


def _dense_predictions(graph: CommGraph, r: float, schedule,
                       lam2: float, c: float = 1.0) -> dict[str, Any]:
    """Paper design-rule outputs for a dense run. `c` is the compressor's
    bytes-on-wire ratio: every optimum is quoted at the effective tradeoff
    r*c (see core.tradeoff)."""
    return {
        "r": r,
        "wire_ratio": c,
        "n_opt": _tradeoff.n_opt_complete(r, c),
        "h_opt": _tradeoff.h_opt_int(graph.n, graph.degree, r, lam2, c),
        "tau_eps": _tradeoff.time_to_accuracy(
            PREDICT_EPS, graph.n, graph.degree, r, lam2,
            schedule=schedule, c=c),
    }


def _compression_block(kind: str, ratio: float, full_bytes: float,
                       wire_bytes: float, residual_norms
                       ) -> dict[str, Any]:
    """The canonical `RunMetrics.compression` record: the compressor kind,
    its bytes-on-wire ratio, how many bytes compression kept off the wire,
    and the mean per-node error-feedback residual norm at each trace
    point."""
    if residual_norms is None:
        rns: list[float] = []
    else:
        rns = [float(v) for v in np.asarray(residual_norms).ravel()]
    return {"kind": kind, "wire_ratio": float(ratio),
            "bytes_saved": float(max(full_bytes - wire_bytes, 0.0)),
            "residual_norms": rns}


# ---------------------------------------------------------------------------
# dense backend
# ---------------------------------------------------------------------------


def _dense_message_counts(trace: SimTrace, n: int, k: int, d: int,
                          ratio: float = 1.0) -> dict[str, Any]:
    """Closed-form message accounting for a dense run: each gossip round
    is every node shipping its d-vector to its k neighbors; `ratio` is the
    compressor's wire ratio (bytes actually crossing the wire)."""
    rounds = int(trace.comms[-1]) if trace.comms else 0
    msgs = rounds * n * k
    return {"gossip_rounds": rounds, "msgs": msgs,
            "bytes_on_wire": float(msgs * d * _DENSE_SCALAR_BYTES * ratio)}


def _dense_parts(spec: ExperimentSpec, backend: ComponentSpec,
                 device: torch.device) -> dict[str, Any]:
    """Validate a dense run and build everything BUT the simulator: the
    problem (on `device`), graph, schedule and stepsize closures, the
    compressor and the parsed backend params."""
    _require(spec.faults is None,
             "fault injection is event-driven (netsim backends only); the "
             "dense synchronous loop has no crash/recover semantics")
    params = dict(backend.params)
    compress_keep = params.pop("compress_keep", None)
    mix = params.pop("mix", "auto")
    loop = params.pop("loop", "scan")
    _require(not params, f"dense backend has unknown params {sorted(params)}")
    compression = None
    if spec.compression is not None:
        _require(compress_keep is None,
                 "backend param 'compress_keep' and spec.compression are "
                 "mutually exclusive; spec.compression is the canonical "
                 "compression axis (kind 'topk' subsumes compress_keep)")
        from repro_torch.compress import build_compressor
        compression = build_compressor(spec.compression.kind,
                                       dict(spec.compression.params))
    if spec.controller is not None:
        raise NotImplementedError(
            f"controller {spec.controller.kind!r} is not ported yet "
            f"(slice: dense adaptive)")
    problem = _build_problem(spec, device)
    _require(isinstance(problem, C.Problem),
             f"dense backend cannot run problem kind "
             f"{spec.problem.kind!r}")
    _require(problem.subgrad_stack is not None,
             f"problem {problem.name!r} has no stacked subgradient")
    _require(spec.stepsize.kind != "inv_sqrt",
             'stepsize "inv_sqrt" is host-only; use "sqrt" on dense')
    graph = _build_topology(spec, problem.n)
    _require(isinstance(graph, CommGraph),
             "dense backend needs a fixed CommGraph topology "
             "(time-varying sequences are netsim-only)")
    _require(spec.time_limit is None,
             "time_limit is event-clock only (netsim backends)")
    return dict(problem=problem, graph=graph,
                schedule=_build_schedule(spec),
                a_fn=_build_stepsize(spec),
                compress_keep=compress_keep, compression=compression,
                mix=mix, loop=loop)


def _dense_sim(spec: ExperimentSpec, parts: dict[str, Any],
               device: torch.device) -> DDASimulator:
    """Fresh DDASimulator from `_dense_parts` output; it captures its runs
    on a card unless the problem declares it cannot be captured."""
    problem = parts["problem"]
    return DDASimulator(problem.subgrad_stack, problem.objective,
                        parts["graph"], parts["schedule"],
                        a_fn=parts["a_fn"], r=spec.r,
                        compress_keep=parts["compress_keep"],
                        compression=parts["compression"], mix=parts["mix"],
                        projection=problem.projection, device=device,
                        capture=problem.capturable)


@backends.register("dense")
def _run_dense(spec: ExperimentSpec, backend: ComponentSpec,
               tracer: Tracer | None = None, *, device=None) -> RunResult:
    """Dense backend on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    tr = tracer if tracer is not None else Tracer()
    with tr.span("build"):
        parts = _dense_parts(spec, backend, device)
        problem, graph = parts["problem"], parts["graph"]
        sim = _dense_sim(spec, parts, device)
        x0 = torch.zeros((problem.n, problem.d), dtype=torch.float32,
                         device=device)
    t0 = time.perf_counter()
    with profile_ctx(spec.profile_dir):
        trace = sim.run(x0, spec.T, eval_every=spec.eval_every,
                        seed=spec.seed, loop=parts["loop"])
    wall = time.perf_counter() - t0
    compile_s = sim.last_timings["compile_s"]
    tr.add_host_span("compile", tr.now() - wall, compile_s)
    tr.add_host_span("execute", tr.now() - wall + compile_s,
                     wall - compile_s)
    # how the run ran ("graph" or "eager"); not in extras, which the parity
    # check compares with the reference's exactly
    metrics_fields: dict[str, Any] = {"notes": {"loop": sim.last_loop}}
    if sim.last_timings["eval_s"]:
        metrics_fields.update(eval_s=sim.last_timings["eval_s"])
    tr.count("device_execute_s", sim.last_timings["execute_s"])
    # execute_s is the non-compile remainder of the backend wall, so
    # compile_s + execute_s == wall_s exactly, as in the reference
    metrics_fields["execute_s"] = max(wall - compile_s, 0.0)
    metrics_fields["compile_s"] = min(compile_s, wall)
    eps_value, tta = _target_fields(trace, _eps_value(spec, problem))
    ratio = sim.wire_ratio(problem.d)
    predictions = _dense_predictions(graph, spec.r, parts["schedule"],
                                     graph.lambda2(), c=ratio)
    counts = _dense_message_counts(trace, problem.n, graph.degree,
                                   problem.d, ratio=ratio)
    extras: dict[str, Any] = {"mix_mode": sim.mix_mode}
    if sim.compression is not None:
        comp_block = _compression_block(
            sim.compression.kind, ratio,
            full_bytes=float(counts["msgs"] * problem.d
                             * _DENSE_SCALAR_BYTES),
            wire_bytes=counts["bytes_on_wire"],
            residual_norms=sim.last_res_norms)
        extras["compression"] = comp_block
        metrics_fields["compression"] = comp_block
    metrics = RunMetrics.from_tracer(tr, **metrics_fields, **counts)
    return RunResult(spec=spec, backend=backend, trace=trace, wall_s=wall,
                     eps_value=eps_value, time_to_target=tta,
                     predictions=predictions, extras=extras,
                     metrics=metrics)


@backends.register("netsim")
def _run_netsim(spec, backend, tracer=None, *, device=None):
    raise NotImplementedError("the netsim backend is not ported yet "
                              "(slice: netsim)")


@backends.register("launch")
def _run_launch(spec, backend, tracer=None, *, device=None):
    raise NotImplementedError("the launch backend is not ported yet "
                              "(slice: LM stack)")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _resolve_backend(spec: ExperimentSpec,
                     backend: int | str | ComponentSpec | None
                     ) -> ComponentSpec:
    if backend is None:
        return spec.backends[0]
    if isinstance(backend, ComponentSpec):
        return backend
    if isinstance(backend, int):
        return spec.backends[backend]
    for b in spec.backends:
        if b.kind == backend:
            return b
    # a kind the spec does not declare is still runnable (explicit ask)
    if backend in backends:
        return ComponentSpec(backend)
    raise KeyError(f"unknown backend {backend!r}; spec declares "
                   f"{[b.kind for b in spec.backends]}, registry has "
                   f"{backends.names()}")


def run(spec: ExperimentSpec,
        backend: int | str | ComponentSpec | None = None,
        tracer: Tracer | None = None, *, device=None) -> RunResult:
    """Run one spec on one backend (default: the first it declares).

    `device` is where the run happens: None means the CUDA card, and
    raises when there is none; pass "cpu" to run on the CPU. It is not a
    field of the spec, so a spec round-trips JSON-exact against the
    reference. `tracer` (optional `repro_torch.obs.Tracer`) collects the
    run's spans and counters; `RunResult.metrics` is populated either way.
    """
    b = _resolve_backend(spec, backend)
    return backends.builder(b.kind)(spec, b, tracer=tracer, device=device)


def run_all(spec: ExperimentSpec, *, device=None) -> list[RunResult]:
    """Run a spec on EVERY backend it declares, in declaration order."""
    return [run(spec, b, device=device) for b in spec.backends]


def run_sweep(spec: ExperimentSpec, axis: str, values: Sequence[Any],
              backend: int | str | ComponentSpec | None = None,
              parallel: str | None = None,
              processes: int | None = None, *,
              device=None) -> list[RunResult]:
    """One run per value of a dotted-path axis -- the paper's grids as one
    call: `run_sweep(spec, "schedule.params.h", [1, 2, 4, 8, 16])`,
    `run_sweep(spec, "problem.params.n", [4, 8, 16])`,
    `run_sweep(spec, "r", [0.001, 0.01, 0.1])`.

    `parallel` picks the executor (results are index-aligned with `values`
    and cell-for-cell identical to the serial path up to float reduction
    order):

      * None / "serial" -- one `run()` per cell, in order (the baseline).
      * "vmap" -- dense-backend grids whose cells differ only along
        data-batchable axes (seed / r / the whole schedule component /
        eps_frac / name) run as ONE batched program
        (`DDASimulator.run_batch`): one capture and one replayed program
        for the grid instead of one per cell. Grids that are not batchable
        fall back to the serial path, each result carrying the reason.
        The batch gains where launches set the pace (narrow cells). Where
        the device does (full-width cells), a lane's work is unchanged
        and the gain is small; under a sorting compressor (top-k) the
        batch is slower than serial, since its comm body sorts every
        lane whenever any lane communicates (PERF.md section 5).
      * "process" -- fan cells out across OS processes (spawn context: a
        fork after CUDA has started breaks CUDA). Results merge back in
        order, bit-identical to serial. `processes` caps the pool
        (default: cell count capped by CPU count).

    `device` is where every cell runs (None: the CUDA card).
    """
    cells = [spec.with_value(axis, v) for v in values]
    if parallel in (None, "serial"):
        return [run(c, backend=backend, device=device) for c in cells]
    if parallel == "vmap":
        out, reason = _run_sweep_vmap(cells, backend, device)
        if out is not None:
            return out
        # fall back to serial, with the reason the grid did not pack on
        # every result (metrics.notes and extras), as the reference does
        results = [run(c, backend=backend, device=device) for c in cells]
        for r in results:
            if r.metrics is not None:
                r.metrics = dataclasses.replace(
                    r.metrics,
                    notes={**r.metrics.notes, "vmap_fallback": reason})
            r.extras["vmap_fallback"] = reason
        return results
    if parallel == "process":
        return _run_sweep_process(cells, backend, processes, device)
    raise ValueError(f"parallel must be None/'serial'/'vmap'/'process', "
                     f"got {parallel!r}")


# ---------------------------------------------------------------------------
# sweep executors
# ---------------------------------------------------------------------------


#: spec fields a batched sweep may vary per lane: everything else must be
#: identical across cells so one program (one problem, topology, stepsize
#: and shape) serves every lane. The schedule varies because the program
#: consumes it as a precomputed comm MASK (data); seed is the PRNG fold; r
#: only shapes the host-side time axis; eps_frac/name are host-side
#: bookkeeping.
_VMAP_LANE_FIELDS = ("name", "seed", "r", "schedule", "eps_frac")


def _vmap_signature(spec: ExperimentSpec, backend: ComponentSpec) -> str:
    d = spec.to_dict()
    for f in _VMAP_LANE_FIELDS:
        d.pop(f)
    d.pop("backends")
    return json.dumps([d, backend.to_dict()], sort_keys=True)


def batch_compat_report(spec: ExperimentSpec, backend: ComponentSpec, *,
                        device=None) -> str | None:
    """Why this (spec, backend) cannot ride a `run_batch` lane -- None
    when it can. The reasons are the reference's word for word. Builds at
    most the (cached) problem, on `device` (None: the CUDA card), and the
    topology."""
    if backend.kind != "dense":
        return (f"backend {backend.kind!r} is not dense (vmap lanes are the "
                f"dense scanned program; netsim/launch runs are host loops)")
    if spec.controller is not None:
        return ("a controller run drives its own wall-clock chunk loop and "
                "retunes its schedule online; lanes share one comm mask")
    if spec.time_limit is not None:
        return "time_limit is event-clock only (netsim backends)"
    if spec.profile_dir is not None:
        return "profiling wants one run per capture"
    if spec.faults is not None:
        return "fault injection is event-driven (netsim backends only)"
    params = dict(backend.params)
    params.pop("compress_keep", None)
    params.pop("mix", None)
    if params.pop("loop", "scan") != "scan":
        return "loop='segment' is the host-loop baseline (one lane per run)"
    if params:
        return f"dense backend has unknown params {sorted(params)}"
    if spec.stepsize.kind == "inv_sqrt":
        return 'stepsize "inv_sqrt" is host-only; lanes need the jnp path'
    problem = _build_problem(spec, resolve_device(device))
    if not isinstance(problem, C.Problem) or problem.subgrad_stack is None:
        return (f"problem kind {spec.problem.kind!r} has no stacked jax "
                f"subgradient")
    graph = _build_topology(spec, problem.n)
    if not isinstance(graph, CommGraph):
        return ("topology is a time-varying sequence (netsim-only); lanes "
                "need one fixed CommGraph")
    return None


def _vmap_pool_report(cells: Sequence[ExperimentSpec],
                      resolved: Sequence[ComponentSpec],
                      device=None) -> str | None:
    """Why this POOL of cells cannot batch into one program -- None when
    it can: every cell individually batchable, plus pairwise shape
    compatibility (identical outside the per-lane fields)."""
    for c, b in zip(cells, resolved):
        reason = batch_compat_report(c, b, device=device)
        if reason is not None:
            return f"cell {c.name!r}: {reason}"
    sigs = {_vmap_signature(c, b) for c, b in zip(cells, resolved)}
    if len(sigs) != 1:
        return (f"cells differ outside the batchable lane fields "
                f"{_VMAP_LANE_FIELDS} ({len(sigs)} distinct shape "
                f"signatures; every lane must share one compiled program)")
    return None


def _dense_batch_results(cells: Sequence[ExperimentSpec],
                         resolved: Sequence[ComponentSpec],
                         sim: DDASimulator, problem, graph,
                         schedules: Sequence[Any],
                         traces: Sequence[SimTrace], wall: float,
                         lane_counter: str = "vmap_lanes"
                         ) -> list[RunResult]:
    """Per-lane RunResults for one `run_batch` call: the wall split
    amortized over the lanes, closed-form message counts and per-lane
    predictions, as the reference assembles them."""
    B = len(cells)
    lam2 = graph.lambda2()
    lane_wall = wall / B
    # one capture serves every lane: amortize it evenly so per-lane
    # compile_s + execute_s == wall_s holds just like the serial path
    lane_compile = min(sim.last_timings["compile_s"] / B, lane_wall)
    ratio = sim.wire_ratio(problem.d)
    rn_all = sim.last_res_norms  # (B, S) from run_batch, or None
    results = []
    for i, (c, bk, sched, trc) in enumerate(zip(cells, resolved,
                                                schedules, traces)):
        eps_value, tta = _target_fields(trc, _eps_value(c, problem))
        predictions = _dense_predictions(graph, c.r, sched, lam2, c=ratio)
        counts = _dense_message_counts(trc, problem.n, graph.degree,
                                       problem.d, ratio=ratio)
        extras = {"mix_mode": sim.mix_mode, lane_counter: B}
        comp_block = None
        if sim.compression is not None:
            comp_block = _compression_block(
                sim.compression.kind, ratio,
                full_bytes=float(counts["msgs"] * problem.d
                                 * _DENSE_SCALAR_BYTES),
                wire_bytes=counts["bytes_on_wire"],
                residual_norms=None if rn_all is None else rn_all[i])
            extras["compression"] = comp_block
        metrics = RunMetrics(
            compile_s=lane_compile,
            execute_s=max(lane_wall - lane_compile, 0.0),
            counters={lane_counter: float(B)},
            compression=comp_block,
            notes={"loop": sim.last_loop},
            **counts)
        results.append(RunResult(
            spec=c, backend=bk, trace=trc, wall_s=lane_wall,
            eps_value=eps_value, time_to_target=tta,
            predictions=predictions,
            extras=extras,
            metrics=metrics))
    return results


def _run_sweep_vmap(cells: Sequence[ExperimentSpec], backend, device=None
                    ) -> tuple[list[RunResult] | None, str | None]:
    """Batched executor for shape-compatible dense cells. Returns
    (results, None) when the pool batched, (None, reason) when it did not
    (the caller falls back to serial, which also raises any real
    validation error with the serial path's message)."""
    device = resolve_device(device)
    resolved = [_resolve_backend(c, backend) for c in cells]
    reason = _vmap_pool_report(cells, resolved, device)
    if reason is not None:
        return None, reason
    spec0 = cells[0]
    parts = _dense_parts(spec0, resolved[0], device)
    problem, graph = parts["problem"], parts["graph"]
    sim = _dense_sim(spec0, parts, device)
    schedules = [_build_schedule(c) for c in cells]
    masks = np.stack([s.comm_mask(0, spec0.T) for s in schedules])
    x0 = torch.zeros((problem.n, problem.d), dtype=torch.float32,
                     device=device)
    t0 = time.perf_counter()
    traces = sim.run_batch(x0, spec0.T, spec0.eval_every, masks,
                           seeds=[c.seed for c in cells],
                           rs=[c.r for c in cells])
    wall = time.perf_counter() - t0
    return _dense_batch_results(cells, resolved, sim, problem, graph,
                                schedules, traces, wall), None


def _process_cell(payload) -> RunResult:
    """Top-level worker (picklable) for `parallel="process"`."""
    spec_json, backend_ser, device = payload
    spec = ExperimentSpec.from_json(spec_json)
    backend = (ComponentSpec.from_dict(backend_ser)
               if isinstance(backend_ser, dict) else backend_ser)
    return run(spec, backend=backend, device=device)


def _run_sweep_process(cells: Sequence[ExperimentSpec], backend,
                       processes: int | None, device=None
                       ) -> list[RunResult]:
    import multiprocessing as mp
    import os
    backend_ser = (backend.to_dict() if isinstance(backend, ComponentSpec)
                   else backend)
    device = str(resolve_device(device))
    payloads = [(c.to_json(indent=None), backend_ser, device) for c in cells]
    n_proc = max(1, min(len(cells), processes or os.cpu_count() or 1))
    ctx = mp.get_context("spawn")  # a fork after CUDA init breaks CUDA
    with ctx.Pool(n_proc) as pool:
        return pool.map(_process_cell, payloads, chunksize=1)
