"""`run(spec) -> RunResult` on the port: `repro.experiments.runner` in
PyTorch.

Backends (the `backends` registry):

  * "dense"  -- `core.dda.DDASimulator` on the requested device (the CUDA
    card unless the caller asks for the CPU). With a "dense_adaptive"
    controller the closed loop is driven here (`_dense_adaptive_run`): the
    one-lane run program replayed a uniform-comm chunk at a time, each
    chunk timed on the host clock and fed to `adaptive.DenseController`,
    which retunes h at segment boundaries.
  * "netsim" -- `netsim.NetSimulator` on a scenario preset (params pick the
    preset and its knobs, plus engine / algorithm / adaptive controller),
    with fault plans and checkpoints. Its event loops are host numpy on
    either device, bit for bit the reference's.
  * "launch" -- consensus LM training (`launch.train.
    train_consensus_lm`) of a registry architecture, its pods stacked on
    the device and mixed through kernel K1. The VLM family fails as the
    reference's does, with its error: its token batches carry no encoder
    states for the cross-attention blocks.

Each returns the reference's `RunResult`. `run_sweep` runs a grid of cells
serially, as one batched program (`DDASimulator.run_batch`,
parallel="vmap") or across processes, as the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import tradeoff as _tradeoff
from repro_torch.core.dda import (DEVICE_LOCK, DDASimulator, SimTrace,
                                  trace_time_to_reach)
from repro_torch.core.graphs import CommGraph, GraphSequence
from repro_torch.experiments import components as C
from repro_torch.experiments.registry import Registry
from repro_torch.experiments.result import RunResult
from repro_torch.experiments.spec import ComponentSpec, ExperimentSpec
from repro_torch.obs import RunMetrics, Tracer, profile_ctx, sample_quantiles

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
#: threads share the cache (the experiment server's dispatcher and runs)
_PROBLEM_LOCK = threading.Lock()


def _build_problem(spec: ExperimentSpec, device: torch.device):
    key = json.dumps([spec.problem.kind,
                      sorted(spec.problem.params.items()), str(device)])
    with _PROBLEM_LOCK:
        hit = _PROBLEM_CACHE.get(key)
    if hit is None:
        # its tensors are made on the device
        with DEVICE_LOCK.shared():
            hit = C.build_component(C.problems, spec.problem.kind,
                                    spec.problem.params, device=device)
        with _PROBLEM_LOCK:
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
    on a card unless the problem declares it cannot be captured.
    Everything that shapes its run programs (problem closures, graph,
    stepsize, mix and compression) comes from fields the serving layer's
    `cache_signature` pins, which is what makes it reusable across
    requests: the per-request knobs (schedule, r) are rebound by the
    caller before each run."""
    problem = parts["problem"]
    with DEVICE_LOCK.shared():  # its weights are made on the device
        return DDASimulator(problem.subgrad_stack, problem.objective,
                            parts["graph"], parts["schedule"],
                            a_fn=parts["a_fn"], r=spec.r,
                            compress_keep=parts["compress_keep"],
                            compression=parts["compression"],
                            mix=parts["mix"], projection=problem.projection,
                            device=device, capture=problem.capturable)


@backends.register("dense")
def _run_dense(spec: ExperimentSpec, backend: ComponentSpec,
               tracer: Tracer | None = None, sim_cache=None, *,
               device=None) -> RunResult:
    """Dense backend on `device` (None: the CUDA card).

    `sim_cache` (optional, a `repro_torch.serve.CompileCache` or anything
    with its `lease(spec, backend, factory)` contract) keeps the simulator,
    and with it its run programs and their captured graphs, across calls:
    repeat traffic with the same cache signature captures nothing. The
    lease holds a per-entry lock for the run, and the per-request knobs
    outside the signature (schedule, r) are rebound under it. Without a
    cache the run's own simulator is released at its end (its graphs freed
    alone on the card, `DDASimulator.release`)."""
    device = resolve_device(device)
    tr = tracer if tracer is not None else Tracer()
    with tr.span("build"):
        parts = _dense_parts(spec, backend, device)
        if sim_cache is None:
            lease = contextlib.nullcontext(
                (_dense_sim(spec, parts, device), False))
        else:
            lease = sim_cache.lease(spec, backend,
                                    lambda: _dense_sim(spec, parts, device))
    # the lease is waited for outside DEVICE_LOCK: its holder may capture
    with lease as (sim, cache_hit):
        if sim_cache is not None:
            # a cached simulator may have been built for another request
            # of the same signature: rebind the knobs it leaves free
            sim.schedule = parts["schedule"]
            sim.r = spec.r
            tr.count("cache_hit" if cache_hit else "cache_miss")
        try:
            with DEVICE_LOCK.shared():
                return _run_dense_leased(spec, backend, tr, sim, parts)
        finally:
            if sim_cache is None:
                sim.release()


def _run_dense_leased(spec: ExperimentSpec, backend: ComponentSpec,
                      tr: Tracer, sim: DDASimulator,
                      parts: dict[str, Any]) -> RunResult:
    """The dense run from x0 = 0 on a simulator the caller holds (built
    for this run or leased from a cache)."""
    problem, graph = parts["problem"], parts["graph"]
    schedule = parts["schedule"]
    x0 = torch.zeros((problem.n, problem.d), dtype=torch.float32,
                     device=sim.device)
    extras: dict[str, Any] = {"mix_mode": sim.mix_mode}
    metrics_fields: dict[str, Any] = {}
    if spec.controller is not None:
        _require(parts["loop"] == "scan",
                 "a dense_adaptive run drives its own wall-clock chunked "
                 "segment loop; leave the 'loop' param unset")
        _require(spec.controller.kind == "dense_adaptive",
                 f"dense backend needs a 'dense_adaptive' controller, got "
                 f"{spec.controller.kind!r}")
        from repro_torch.adaptive import AdaptiveSchedule, DenseController
        _require(isinstance(schedule, AdaptiveSchedule),
                 "a controller run needs schedule kind 'adaptive'")
        ctrl_params = dict(spec.controller.params)
        if sim.compression is not None:
            # the dense tracker's r_hat comes from wall-clock timings that
            # do NOT shrink with compression; tell the controller the wire
            # ratio so its retunes target the effective tradeoff r*c
            ctrl_params.setdefault("wire_ratio",
                                   sim.wire_ratio(problem.d))
        ctrl = DenseController(schedule, **ctrl_params)
        ctrl.attach_tracer(tr)
        timings: dict[str, Any] = {"compile_s": 0.0, "iter_walls": []}
        t0 = time.perf_counter()
        with tr.span("execute"), profile_ctx(spec.profile_dir):
            trace = _dense_adaptive_run(sim, ctrl, x0, spec.T,
                                        spec.eval_every, spec.seed,
                                        timings=timings)
        wall = time.perf_counter() - t0
        extras["retunes"] = [(rt.from_t, rt.h) for rt in schedule.retunes]
        extras["h_final"] = schedule.h_current
        extras["r_hat"] = ctrl.tracker.r_hat
        metrics_fields.update(
            compile_s=timings["compile_s"],
            retunes=len(schedule.retunes),
            retune_history=schedule.retunes,
            r_hat=ctrl.tracker.r_hat,
            r_hat_trajectory=ctrl.r_hat_history,
            step_time_quantiles=sample_quantiles(timings["iter_walls"],
                                                 "host"))
    else:
        t0 = time.perf_counter()
        with profile_ctx(spec.profile_dir):
            trace = sim.run(x0, spec.T, eval_every=spec.eval_every,
                            seed=spec.seed, loop=parts["loop"])
        wall = time.perf_counter() - t0
        compile_s = sim.last_timings["compile_s"]
        tr.add_host_span("compile", tr.now() - wall, compile_s)
        tr.add_host_span("execute", tr.now() - wall + compile_s,
                         wall - compile_s)
        metrics_fields["compile_s"] = compile_s
        if sim.last_timings["eval_s"]:
            metrics_fields.update(eval_s=sim.last_timings["eval_s"])
        tr.count("device_execute_s", sim.last_timings["execute_s"])
    # how the run ran ("graph" or "eager"); not in extras, which the parity
    # check compares with the reference's exactly
    metrics_fields["notes"] = {"loop": sim.last_loop}
    # execute_s is the non-compile remainder of the backend wall, so
    # compile_s + execute_s == wall_s exactly, as in the reference
    compile_s = float(metrics_fields["compile_s"])
    metrics_fields["execute_s"] = max(wall - compile_s, 0.0)
    metrics_fields["compile_s"] = min(compile_s, wall)
    eps_value, tta = _target_fields(trace, _eps_value(spec, problem))
    ratio = sim.wire_ratio(problem.d)
    predictions = _dense_predictions(graph, spec.r, schedule,
                                     graph.lambda2(), c=ratio)
    counts = _dense_message_counts(trace, problem.n, graph.degree,
                                   problem.d, ratio=ratio)
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


def _dense_adaptive_run(sim: DDASimulator, ctrl, x0: torch.Tensor, T: int,
                        eval_every: int, seed: int,
                        timer: Callable[[], float] = time.perf_counter,
                        timings: dict[str, Any] | None = None
                        ) -> SimTrace:
    """`DDASimulator.run` with the measure->predict->act loop on the wall
    clock, the counterpart of the reference's `_dense_adaptive_run`.

    The simulator's chunk driver holds the run: `start_closed_loop` builds
    its one-lane run program once (captured on a card unless the problem
    cannot be; the build is charged to `timings["compile_s"]`, outside any
    timed chunk), loads it and synchronizes, and the carry stays in the
    program's buffers from chunk to chunk. Each evaluation segment splits
    into uniform-comm chunks, read live from `sched.is_comm_step` (the
    controller splices h at segment boundaries, so no mask is built
    ahead). A chunk is `sim.run_chunk(comm, chunk)`: `chunk` replays of
    the comm or idle body, then a device synchronize; `timer()` is read
    around that call, which is the seam a test wraps to charge a fake
    clock. Each chunk's per-iteration wall feeds `DenseController.observe`;
    at each segment end `sim.segment_stats()` gives the trace point (and,
    under compression, the residual norm), and the controller may splice a
    re-solved h at the frontier `done` (never at T: that would shape no
    iteration).

    `timings` (optional dict) receives `compile_s` and, per iteration, the
    measured wall in `iter_walls`. Launch counts come from the replays, as
    in `run` (`sim.end_closed_loop`).
    """
    n, k = sim.graph.n, sim.graph.degree
    r_eff = sim.r * sim.wire_ratio(int(np.prod(x0.shape[1:])))
    ctrl.bind(n, k, sim.graph.lambda2())
    sched = sim.schedule
    trace = SimTrace([], [], [], [], [])
    res_norms: list[float] = []
    sim_time = 0.0
    comm_total = 0
    if T > 0:
        sim.start_closed_loop(x0, T)
        if timings is not None:
            timings["compile_s"] += sim.last_timings["compile_s"]

    done = 0
    while done < T:
        seg_end = min(done + eval_every, T)
        while done < seg_end:
            comm = sched.is_comm_step(done + 1)
            chunk = 1
            while (done + chunk < seg_end
                   and sched.is_comm_step(done + chunk + 1) == comm):
                chunk += 1
            t0 = timer()
            sim.run_chunk(comm, chunk)
            per_iter = max(timer() - t0, 0.0) / chunk
            if timings is not None:
                timings["iter_walls"].extend([per_iter] * chunk)
            for _ in range(chunk):
                ctrl.observe(per_iter, comm)
            done += chunk
            if comm:
                comm_total += chunk
                sim_time += chunk * (1.0 / n + k * r_eff)
            else:
                sim_time += chunk * (1.0 / n)
        stats = sim.segment_stats()
        trace.iters.append(done)
        trace.sim_time.append(sim_time)
        trace.fvals.append(stats.fval)
        trace.fvals_consensus.append(stats.fval_consensus)
        trace.comms.append(comm_total)
        trace.disagreement.append(stats.disagreement)
        if sim.compression is not None:
            res_norms.append(stats.res_norm)
        if done < T:  # a splice at the frontier T would shape zero
            ctrl.maybe_retune(done)  # iterations: don't record phantoms
    if T > 0:
        sim.end_closed_loop()
    sim.last_res_norms = (np.asarray(res_norms)
                          if sim.compression is not None else None)
    return trace


# ---------------------------------------------------------------------------
# netsim backend
# ---------------------------------------------------------------------------

_SCENARIO_KNOBS = {
    "homogeneous": (),
    "lossy": ("loss", "jitter", "retries", "retry_timeout"),
    "straggler": ("slow_factor", "n_slow"),
    "adversarial": ("loss", "slow_factor", "n_slow", "rewire_every",
                    "retries", "retry_timeout"),
    "time_varying": ("rewire_every", "loss"),
}


def _build_scenario(kind: str, n: int, r: float, topology,
                    message_bytes: float, knobs: dict[str, Any]):
    from repro_torch.netsim import scenarios as S
    allowed = _SCENARIO_KNOBS.get(kind)
    if allowed is None:
        raise KeyError(f"unknown scenario {kind!r}; have "
                       f"{sorted(_SCENARIO_KNOBS)}")
    unknown = set(knobs) - set(allowed)
    if unknown:
        raise ValueError(f"scenario {kind!r} has unknown knobs "
                         f"{sorted(unknown)} (allowed: {list(allowed)})")
    builder = {"homogeneous": S.homogeneous, "lossy": S.lossy,
               "straggler": S.straggler, "adversarial": S.adversarial,
               "time_varying": S.time_varying_expander}[kind]
    if kind == "time_varying" and "rewire_every" not in knobs:
        raise ValueError("time_varying scenario needs rewire_every")
    return builder(n, r, message_bytes=message_bytes, graph=topology,
                   **knobs)


@backends.register("netsim")
def _run_netsim(spec: ExperimentSpec, backend: ComponentSpec,
                tracer: Tracer | None = None, *, device=None) -> RunResult:
    """Netsim backend. The event loops are host numpy on either device;
    the problem's torch halves are built on `device` (None: the CUDA
    card), as every entry point of the port."""
    from repro_torch.netsim import NetSimulator

    device = resolve_device(device)
    tr = tracer if tracer is not None else Tracer()
    _require(spec.profile_dir is None,
             "profile_dir wraps the dense scanned program; the netsim "
             "event loops are host numpy (nothing for torch.profiler to "
             "see)")
    params = dict(backend.params)
    scenario_kind = params.pop("scenario", "homogeneous")
    engine = params.pop("engine", "auto")
    algorithm = params.pop("algorithm", "dda")
    message_bytes = params.pop("message_bytes", None)
    pushsum_w_floor = params.pop("pushsum_w_floor", 0.5)
    pushsum_inject = params.pop("pushsum_inject", "plain")
    knobs = {k: params.pop(k)
             for k in list(params)
             if k in {"loss", "jitter", "slow_factor", "n_slow",
                      "rewire_every", "retries", "retry_timeout"}}
    _require(not params,
             f"netsim backend has unknown params {sorted(params)}")

    with tr.span("build"):
        problem = _build_problem(spec, device)
        _require(isinstance(problem, C.Problem),
                 f"netsim backend cannot run problem kind "
                 f"{spec.problem.kind!r}")
        topology = _build_topology(spec, problem.n)
        if scenario_kind == "time_varying" or knobs.get("rewire_every"):
            _require(isinstance(topology, GraphSequence),
                     "a rewiring scenario needs an 'expander_sequence' "
                     "topology")

        if message_bytes is None:
            from repro_torch.netsim.scenarios import DEFAULT_MESSAGE_BYTES
            message_bytes = DEFAULT_MESSAGE_BYTES
        scenario = _build_scenario(scenario_kind, problem.n, spec.r,
                                   topology, message_bytes, knobs)
        a_fn = _build_stepsize(spec)
        schedule = _build_schedule(spec)

        ctrl = None
        if spec.controller is not None:
            _require(spec.controller.kind == "adaptive",
                     f"netsim backend needs an 'adaptive' controller, got "
                     f"{spec.controller.kind!r}")
            from repro_torch.adaptive import (AdaptiveController,
                                              AdaptiveSchedule)
            _require(isinstance(schedule, AdaptiveSchedule),
                     "a controller run needs schedule kind 'adaptive'")
            ctrl = AdaptiveController(schedule, **spec.controller.params)

        plan = None
        if spec.faults is not None:
            from repro_torch.faults import faultplans
            plan = C.build_component(faultplans, spec.faults.kind,
                                     spec.faults.params, n=problem.n)

        compression = None
        if spec.compression is not None:
            from repro_torch.compress import build_compressor
            compression = build_compressor(spec.compression.kind,
                                           dict(spec.compression.params))

        sim = NetSimulator(scenario, problem.grad_fn, problem.eval_fn,
                           a_fn=a_fn,
                           schedule=None if ctrl is not None else schedule,
                           algorithm=algorithm, seed=spec.seed,
                           pushsum_w_floor=pushsum_w_floor,
                           pushsum_inject=pushsum_inject,
                           engine=engine, controller=ctrl, tracer=tr,
                           faults=plan, compression=compression)
    x0 = np.zeros((problem.n, problem.d))
    time_limit = math.inf if spec.time_limit is None else spec.time_limit
    t0 = time.perf_counter()
    with tr.span("execute"):
        trace = sim.run(x0, spec.T, eval_every=spec.eval_every,
                        time_limit=time_limit)
    wall = time.perf_counter() - t0

    eps_value, tta = _target_fields(trace, _eps_value(spec, problem))
    measurement = None
    predictions = None
    if sim.msg_flights and sim.compute_times:
        predictions = sim.predict(eps=PREDICT_EPS)
        measurement = predictions.pop("measurement")
    extras: dict[str, Any] = {
        "engine": sim._engine_inst.name,
        "scenario": scenario.name,
        "sent": sim.sent, "drops": sim.drops, "rewires": sim.rewires,
    }
    metrics_fields: dict[str, Any] = dict(
        compile_s=0.0,  # event loops are host numpy: nothing compiles
        execute_s=wall,
        msgs=sim.sent,
        # wire_bytes is message_bytes scaled by the compressor's ratio
        # (identical when uncompressed): bytes that actually crossed links
        bytes_on_wire=float(sim.sent * sim.net.wire_bytes),
        drops=sim.drops,
        gossip_rounds=int(trace.comms[-1]) if trace.comms else 0,
        step_time_quantiles=sample_quantiles(sim.compute_times, "sim"))
    if sim.compression is not None:
        comp_block = _compression_block(
            sim.compression.kind,
            sim.net.wire_bytes / sim.net.message_bytes,
            full_bytes=float(sim.sent * sim.net.message_bytes),
            wire_bytes=float(sim.sent * sim.net.wire_bytes),
            residual_norms=sim.comp_res_norms)
        extras["compression"] = comp_block
        metrics_fields["compression"] = comp_block
    if plan is not None:
        faults_block = {**(sim.fault_stats or {}),
                        "retransmits": sim.retransmits}
        extras["faults"] = faults_block
        metrics_fields["faults"] = faults_block
    elif sim.retransmits:
        metrics_fields["faults"] = {"retransmits": sim.retransmits}
    if ctrl is not None:
        extras["retunes"] = [(rt.from_t, rt.h)
                             for rt in ctrl.schedule.retunes]
        extras["h_final"] = ctrl.schedule.h_current
        extras["h_opt_hat"] = ctrl.schedule.h_opt_hat
        extras["r_hat"] = ctrl.tracker.r_hat
        if ctrl.reweighter is not None:
            extras["lam2_eff"] = ctrl.reweighter.last_lam2
        extras["reweight_gossip"] = ctrl.reweight_gossip
        metrics_fields.update(retunes=len(ctrl.schedule.retunes),
                              retune_history=ctrl.schedule.retunes,
                              r_hat=ctrl.tracker.r_hat,
                              r_hat_trajectory=ctrl.r_hat_history)
    metrics = RunMetrics.from_tracer(tr, **metrics_fields)
    return RunResult(spec=spec, backend=backend, trace=trace, wall_s=wall,
                     eps_value=eps_value, time_to_target=tta,
                     r_measurement=measurement, predictions=predictions,
                     extras=extras, metrics=metrics)


@backends.register("launch")
def _run_launch(spec: ExperimentSpec, backend: ComponentSpec,
                tracer: Tracer | None = None, *, device=None) -> RunResult:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_consensus_lm
    from repro_torch.models import registry as _models
    from repro_torch.optim import adamw, cosine_lr

    device = resolve_device(device)
    tr = tracer if tracer is not None else Tracer()
    _require(spec.faults is None,
             "fault injection is event-driven (netsim backends only); "
             "launch runs real processes")
    _require(spec.profile_dir is None,
             "profile_dir wraps the dense scanned program; profile the "
             "launch path with jax.profiler around train_consensus_lm "
             "directly")
    params = dict(backend.params)
    mesh_shape = tuple(params.pop("mesh", None) or (1, 1, 1))
    dryrun = params.pop("dryrun", False)
    lr = params.pop("lr", 3e-4)
    mix_target = params.pop("mix_target", "params")
    log_every = params.pop("log_every", 0)
    _require(not params,
             f"launch backend has unknown params {sorted(params)}")

    with tr.span("build"):
        problem = _build_problem(spec, device)
        _require(isinstance(problem, C.LMProblem),
                 'launch backend needs the "lm" problem kind')
        _require(len(mesh_shape) == 3, "mesh must be (pod, data, model)")
        _require(spec.controller is None,
                 "the launch backend has no controller hook yet (ROADMAP)")
        # reject spec fields this backend cannot honor rather than silently
        # dropping them -- the other backends validate the same way
        _require(spec.eps_frac is None,
                 "launch has no F* to target; eps_frac is dense/netsim-only")
        _require(spec.time_limit is None,
                 "time_limit is event-clock only (netsim backends)")
        _require(spec.stepsize == ComponentSpec("sqrt", {"A": 1.0}),
                 "the launch optimizer's LR schedule is the backend's 'lr' "
                 "param; leave spec.stepsize at its default")
        n_pods = mesh_shape[0]
        shards = mesh_shape[1] * mesh_shape[2]
        # under a default process group each pod is one a rank, or its
        # replica is sharded over data x model ranks (one pod a rank, or
        # the pods stacked on every rank); else the pods stack on one card,
        # each whole, and the mesh refuses data/model axes
        group = None
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if shards == 1:
                _require(world == n_pods,
                         f"the default process group has {world} ranks but "
                         f"the mesh's pod axis {n_pods}: the launch backend "
                         f"runs one pod a rank")
            else:
                _require(world in (n_pods * shards, shards),
                         f"the default process group has {world} ranks but "
                         f"the mesh {list(mesh_shape)} needs "
                         f"{n_pods * shards} (one pod a rank) or {shards} "
                         f"(the pods stacked on every rank)")
            group = dist.group.WORLD
        mesh = make_mesh(mesh_shape, ("pod", "data", "model"),
                         device=device, group=group)
        graph = _build_topology(spec, n_pods)
        _require(isinstance(graph, CommGraph),
                 "launch backend needs a fixed CommGraph topology")
        schedule = _build_schedule(spec)

        cfg = _models.get_config(problem.arch, problem.variant)
        optimizer = adamw(cosine_lr(lr, max(spec.T, 1)))
    t0 = time.perf_counter()
    with tr.span("execute"), DEVICE_LOCK.shared():
        report = train_consensus_lm(
            cfg, optimizer, mesh, steps=spec.T, schedule=schedule,
            graph=graph, r_estimate=spec.r,
            batch_per_node=problem.batch_per_node,
            seq_len=problem.seq_len, seed=spec.seed, log_every=log_every,
            mix_target=mix_target, dryrun=dryrun, tracer=tr)
    wall = time.perf_counter() - t0

    # fold the per-step losses into the canonical trace shape at the spec's
    # eval cadence; sim_time is the closed-form eq. 9/19 charge
    n, k = graph.n, graph.degree
    trace = SimTrace([], [], [], [], [])
    for step in range(spec.eval_every, report.steps + 1, spec.eval_every):
        H = schedule.H(step)
        trace.iters.append(step)
        trace.sim_time.append(step * (1.0 / n) + H * k * spec.r)
        trace.fvals.append(float(report.losses[step - 1]))
        # the recorded loss is already the pod-mean, which is the closest
        # thing this mode has to F at the consensus average; keep the
        # column populated so all six SimTrace fields stay row-aligned
        trace.fvals_consensus.append(float(report.losses[step - 1]))
        trace.comms.append(H)
        trace.disagreement.append(0.0)
    extras = {"arch": problem.arch, "variant": problem.variant,
              "mesh": list(mesh_shape), "comm_rounds": report.comm_rounds,
              "sim_time_units": report.sim_time_units, **report.extras}

    # message accounting mirrors the dense closed form: every gossip round
    # is each pod shipping its parameter payload to its k graph
    # neighbors; param_bytes comes measured from the train loop
    compile_s = float(report.extras.get("local_compile_s", 0.0)
                      + report.extras.get("fused_compile_s", 0.0))
    msgs = report.comm_rounds * n_pods * k
    metrics_fields: dict[str, Any] = dict(
        compile_s=min(compile_s, wall),
        execute_s=max(wall - compile_s, 0.0),
        msgs=msgs,
        bytes_on_wire=float(msgs * report.extras.get("param_bytes", 0.0)),
        gossip_rounds=report.comm_rounds)
    step_walls = report.extras.get("step_walls")
    if step_walls:
        metrics_fields["step_time_quantiles"] = sample_quantiles(
            step_walls, "host")
    metrics = RunMetrics.from_tracer(tr, **metrics_fields)
    return RunResult(spec=spec, backend=backend, trace=trace, wall_s=wall,
                     extras=extras, metrics=metrics)


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
    parts = _dense_parts(cells[0], resolved[0], device)
    sim = _dense_sim(cells[0], parts, device)
    try:
        return _dense_lanes(cells, resolved, sim, parts), None
    finally:
        sim.release()


def _dense_lanes(cells: Sequence[ExperimentSpec],
                 resolved: Sequence[ComponentSpec], sim: DDASimulator,
                 parts: dict[str, Any], lane_counter: str = "vmap_lanes"
                 ) -> list[RunResult]:
    """`cells` as the lanes of one `run_batch` from x0 = 0 on a simulator
    the caller holds (built from `parts` of the first cell, or leased),
    and their per-lane results (`_dense_batch_results`)."""
    problem = parts["problem"]
    spec0 = cells[0]
    schedules = [_build_schedule(c) for c in cells]
    masks = np.stack([s.comm_mask(0, spec0.T) for s in schedules])
    with DEVICE_LOCK.shared():
        x0 = torch.zeros((problem.n, problem.d), dtype=torch.float32,
                         device=sim.device)
        t0 = time.perf_counter()
        traces = sim.run_batch(x0, spec0.T, spec0.eval_every, masks,
                               seeds=[c.seed for c in cells],
                               rs=[c.r for c in cells])
        wall = time.perf_counter() - t0
        return _dense_batch_results(cells, resolved, sim, problem,
                                    parts["graph"], schedules, traces, wall,
                                    lane_counter=lane_counter)


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
