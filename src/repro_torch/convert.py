"""Between the reference and the port: state carried across, data exposed for
comparison, and the one parity check of two `RunResult`s.

  * `state_from_reference` turns a `repro` DDASimulator carry
    `(z, x, xhat, res, t)`, given as numpy arrays, into the port's tensors,
    so a run can start on one side and finish on the other.
  * `problem_arrays` exposes a built port problem's data tensors as numpy,
    under the names the reference's closures give them.
  * `assert_results_match` compares two RunResult dicts under the port's
    stated tolerances: host fields exactly, trace floats and residual
    norms within `RTOL`/`ATOL`, execution timings not at all.
  * `lm_params_from_reference` / `lm_params_to_reference` carry the LM
    launcher's parameter and `OptState` trees, and a decode cache tree
    (dicts, the prologue's list, float32 states beside bf16 keys), across
    (numpy, bf16 as ml_dtypes' bfloat16 on the reference's side), so both
    packages can start from the same weights and cache.

Numpy in, numpy out: this module imports neither `jax` nor `repro`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["ATOL", "LAUNCH_TIMINGS", "RTOL", "STATE_FIELDS",
           "assert_results_match", "lm_params_from_reference",
           "lm_params_to_reference", "problem_arrays",
           "state_from_reference"]

#: the carry of `DDASimulator._segment`, in order
STATE_FIELDS = ("z", "x", "xhat", "res", "t")

#: the float32 tolerance on the trace floats and time_to_target: the one
#: `BENCH_dense.json` `config.tol` gates the reference's own fused path with
RTOL = 1e-5
ATOL = 1e-6

#: the launch backend's execution timings in `extras`: the step functions'
#: build seconds and each step's wall (not compared)
LAUNCH_TIMINGS = ("local_compile_s", "fused_compile_s", "step_walls")

#: trace fields compared within RTOL/ATOL; the other trace fields are host
#: numpy and compared exactly
_FLOAT_TRACE = ("fvals", "fvals_consensus", "disagreement")
#: RunMetrics fields computed on the host in closed form
_EXACT_METRICS = ("gossip_rounds", "msgs", "bytes_on_wire")
#: the compression block's device-computed field; its other fields (kind,
#: wire_ratio, bytes_saved) are host numbers and compared exactly
_FLOAT_COMPRESSION = "residual_norms"


def state_from_reference(arrays: Mapping[str, np.ndarray], device=None
                         ) -> tuple[torch.Tensor, ...]:
    """The carry `(z, x, xhat, res, t)` as float32 tensors on `device`
    (None: the CUDA card). `arrays` maps each name of `STATE_FIELDS` to the
    reference's array; `t` is the 0-d count of iterations done."""
    device = resolve_device(device)
    missing = [f for f in STATE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state is missing {missing}")
    out = []
    for f in STATE_FIELDS:
        a = np.asarray(arrays[f])
        if a.dtype != np.float32:
            raise TypeError(f"{f} must be float32 (the reference's dtype), "
                            f"got {a.dtype}")
        out.append(torch.as_tensor(a.copy(), device=device))
    if out[4].dim() != 0:
        raise ValueError("t must be a 0-d count")
    shape = out[0].shape
    for f, v in zip(STATE_FIELDS[:4], out[:4]):
        if v.shape != shape:
            raise ValueError(f"{f} has shape {tuple(v.shape)}, z "
                             f"{tuple(shape)}")
    return tuple(out)


def _map_tree(fn, tree, opt_state_cls):
    """`fn` on every array leaf of nested dicts, lists, tuples and
    namedtuples; a namedtuple with the fields (step, inner), an
    `OptState`, becomes `opt_state_cls`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, opt_state_cls) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, opt_state_cls) for v in tree]
    if isinstance(tree, tuple):
        items = [_map_tree(fn, v, opt_state_cls) for v in tree]
        if getattr(tree, "_fields", None) == ("step", "inner"):
            return opt_state_cls(*items)
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return fn(tree)


def lm_params_from_reference(params_np, *, device=None):
    """The JAX package's LM parameter tree, `OptState`, decode cache or a
    tuple of them, as numpy (`jax.tree.map(np.asarray, tree)`), into the
    port's tensors on `device` (None: the CUDA card). bf16 leaves
    (ml_dtypes' bfloat16) keep their bits; every reference `OptState`
    becomes the port's."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device)
    from repro_torch.optim import OptState
    return _map_tree(leaf, params_np, OptState)


def lm_params_to_reference(tree, opt_state_cls=None):
    """The inverse: the port's tree as numpy on the host, bf16 leaves as
    numpy's registered "bfloat16" (ml_dtypes', the reference's numpy
    dtype, known once the reference is imported), each `OptState` as
    `opt_state_cls(step, inner)` (pass the reference's `OptState`; by
    default a plain pair)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy knows "bfloat16" once ml_dtypes has registered it, as
            # importing the reference does
            return t.view(torch.uint16).numpy().view(np.dtype("bfloat16"))
        return t.numpy()
    return _map_tree(leaf, tree, opt_state_cls or (lambda *items: items))


def problem_arrays(problem) -> dict[str, np.ndarray]:
    """A built port problem's data tensors, as numpy on the host."""
    return {k: v.detach().cpu().numpy() for k, v in problem.arrays.items()}


def _floats(values) -> np.ndarray:
    """JSON floats as float64, with null (a sanitized inf/nan) as nan."""
    return np.array([np.nan if v is None else v for v in values],
                    dtype=np.float64)


def _close(a, b, rtol: float = RTOL, atol: float = ATOL) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = _floats(np.atleast_1d(a)), _floats(np.atleast_1d(b))
    return a.shape == b.shape and bool(np.allclose(a, b, rtol=rtol,
                                                   atol=atol, equal_nan=True))


def _compare_compression(where: str, ours, ref, bad: list[str],
                         rtol: float, atol: float) -> None:
    """A compression block (or None): residual norms within rtol/atol,
    every other field exactly."""
    if ours is None or ref is None:
        if ours is not ref:
            bad.append(f"{where}: {ours!r} != {ref!r}")
        return
    host = {k: v for k, v in ours.items() if k != _FLOAT_COMPRESSION}
    host_ref = {k: v for k, v in ref.items() if k != _FLOAT_COMPRESSION}
    if host != host_ref:
        bad.append(f"{where}: {host!r} != {host_ref!r}")
    if not _close(ours.get(_FLOAT_COMPRESSION), ref.get(_FLOAT_COMPRESSION),
                  rtol, atol):
        bad.append(f"{where}.{_FLOAT_COMPRESSION} outside rtol={rtol}, "
                   f"atol={atol}")


def assert_results_match(ours: Mapping[str, Any], ref: Mapping[str, Any],
                         *, rtol: float = RTOL, atol: float = ATOL) -> None:
    """Raise AssertionError naming every field where two RunResult dicts
    (`RunResult.to_dict()` of each side) disagree.

    Exact: spec, backend, iters, sim_time, comms, eps_value, predictions,
    r_measurement, extras (but for the residual norms of its compression
    block and the launch backend's timings, `LAUNCH_TIMINGS`: present on
    both sides, not compared), and the message counts and the compression
    block's kind, wire_ratio and bytes_saved in `metrics`. A launch run's
    extras (arch, variant, mesh, comm_rounds, sim_time_units, param_bytes,
    step_comm, n_pods, k, dryrun) are exact with the rest.
    Within rtol/atol (by default the port's RTOL/ATOL): fvals,
    fvals_consensus, disagreement, time_to_target and the compression
    block's residual_norms. A looser rtol/atol is for compressed runs whose
    transmitted entries flip between the two sides (PERF.md states where).
    Ignored (execution noise): wall_s and the rest of `metrics`.
    """
    bad = []
    for key in ("spec", "backend", "eps_value", "predictions",
                "r_measurement"):
        if ours.get(key) != ref.get(key):
            bad.append(f"{key}: {ours.get(key)!r} != {ref.get(key)!r}")
    extras, extras_ref = dict(ours.get("extras") or {}), dict(
        ref.get("extras") or {})
    for key in LAUNCH_TIMINGS:
        if (key in extras) != (key in extras_ref):
            bad.append(f"extras.{key} present on one side only")
        extras.pop(key, None)
        extras_ref.pop(key, None)
    _compare_compression("extras.compression",
                         extras.pop("compression", None),
                         extras_ref.pop("compression", None), bad, rtol, atol)
    if extras != extras_ref:
        bad.append(f"extras: {extras!r} != {extras_ref!r}")
    t_ours, t_ref = ours["trace"], ref["trace"]
    for key in ("iters", "sim_time", "comms"):
        if t_ours[key] != t_ref[key]:
            bad.append(f"trace.{key} differs")
    for key in _FLOAT_TRACE:
        if not _close(t_ours[key], t_ref[key], rtol, atol):
            err = (np.nanmax(np.abs(_floats(t_ours[key])
                                    - _floats(t_ref[key])))
                   if len(t_ours[key]) == len(t_ref[key]) else "shape")
            bad.append(f"trace.{key} outside rtol={rtol}, atol={atol} "
                       f"(max abs err {err})")
    if not _close(ours.get("time_to_target"), ref.get("time_to_target"),
                  rtol, atol):
        bad.append(f"time_to_target: {ours.get('time_to_target')!r} != "
                   f"{ref.get('time_to_target')!r}")
    m_ours, m_ref = ours.get("metrics") or {}, ref.get("metrics") or {}
    for key in _EXACT_METRICS:
        if m_ours.get(key) != m_ref.get(key):
            bad.append(f"metrics.{key}: {m_ours.get(key)!r} != "
                       f"{m_ref.get(key)!r}")
    _compare_compression("metrics.compression", m_ours.get("compression"),
                         m_ref.get("compression"), bad, rtol, atol)
    if bad:
        raise AssertionError("results differ:\n  " + "\n  ".join(bad))
