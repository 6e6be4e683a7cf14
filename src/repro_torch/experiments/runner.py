"""`run(spec) -> RunResult` on the port: the dense backend of
`repro.experiments.runner`, in PyTorch.

The dense backend builds the problem, graph, schedule, stepsize and
compressor from the spec, runs `core.dda.DDASimulator` on the requested
device (the CUDA card unless the caller asks for the CPU) and returns the
reference's `RunResult`. The netsim and launch backends, the dense closed
loop ("dense_adaptive") and the sweep executors are not ported yet: asking
for them raises `NotImplementedError`.
"""

from __future__ import annotations

import json
import math
import time
from typing import Any

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

__all__ = ["backends", "run", "run_all"]

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
    """Fresh DDASimulator from `_dense_parts` output."""
    problem = parts["problem"]
    return DDASimulator(problem.subgrad_stack, problem.objective,
                        parts["graph"], parts["schedule"],
                        a_fn=parts["a_fn"], r=spec.r,
                        compress_keep=parts["compress_keep"],
                        compression=parts["compression"], mix=parts["mix"],
                        projection=problem.projection, device=device)


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
    metrics_fields: dict[str, Any] = {}
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
