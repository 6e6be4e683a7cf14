"""The port's `run_sweep` on the CPU: its batched executor (parallel="vmap")
against its serial path and against the reference's `repro.run_sweep(...,
parallel="vmap")`, the fallbacks and their reasons (the reference's word
for word), the process executor, and the executor's argument check. Port
copies of tests/test_sweeps.py, at its sizes (n=8, d=12, T=60).

Tolerances: a lane against its serial run within rtol 1e-6 (the bound of
tests/test_sweeps.py: a lane's state is its solo run's, its statistics
reduce in another order); the port against the reference under
`repro_torch.convert.assert_results_match` (rtol 1e-5, atol 1e-6 on the
trace floats; exact elsewhere, `extras` included).
"""

import inspect

import numpy as np
import pytest

import repro
import repro_torch
from repro.experiments import runner as ref_runner
from repro_torch.convert import assert_results_match
from repro_torch.experiments import runner as port_runner


def _spec_kw(**kw):
    base = dict(
        name="sweep",
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 8, "d": 12, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        backends=[{"kind": "dense"}],
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        T=60, eval_every=20, seed=0, r=0.01, eps_frac=0.05)
    base.update(kw)
    return base


def _specs(**kw):
    """The same spec on each side: (port, reference)."""
    return (repro_torch.ExperimentSpec(**_spec_kw(**kw)),
            repro.ExperimentSpec(**_spec_kw(**kw)))


def _netsim_kw():
    return dict(
        name="sweep-net",
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 8, "d": 6, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "every"},
        backends=[{"kind": "netsim",
                   "params": {"scenario": "lossy", "loss": 0.2}}],
        stepsize={"kind": "inv_sqrt", "params": {"A": 0.5}},
        T=40, eval_every=10, seed=0, r=0.01)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12)))


SWEEPS = [("seed", [0, 1, 2]), ("schedule.params.h", [1, 2, 5]),
          ("r", [0.0, 0.01, 0.1]),
          ("schedule", [{"kind": "every"},
                        {"kind": "sparse", "params": {"p": 0.3}}])]
SWEEP_IDS = ["seed", "h", "r", "schedule"]


@pytest.mark.parametrize("axis,values", SWEEPS, ids=SWEEP_IDS)
def test_vmap_sweep_matches_serial(axis, values):
    spec, _ = _specs()
    serial = repro_torch.run_sweep(spec, axis, values, device="cpu")
    vmapped = repro_torch.run_sweep(spec, axis, values, parallel="vmap",
                                    device="cpu")
    assert all(r.extras.get("vmap_lanes") == len(values) for r in vmapped)
    assert all(r.metrics.notes == {"loop": "eager"} for r in vmapped)
    for a, b in zip(serial, vmapped):
        assert a.spec == b.spec
        assert a.trace.iters == b.trace.iters
        assert a.trace.sim_time == b.trace.sim_time
        assert a.trace.comms == b.trace.comms
        for f in ("fvals", "fvals_consensus", "disagreement"):
            assert _rel(getattr(a.trace, f), getattr(b.trace, f)) < 1e-6
        assert a.predictions == b.predictions
        assert a.eps_value == pytest.approx(b.eps_value)
        # per-lane wall split: compile_s + execute_s == wall_s
        assert b.metrics.compile_s + b.metrics.execute_s == pytest.approx(
            b.wall_s)


@pytest.mark.parametrize("axis,values", SWEEPS, ids=SWEEP_IDS)
def test_vmap_sweep_matches_reference(axis, values):
    ours_spec, ref_spec = _specs()
    ours = repro_torch.run_sweep(ours_spec, axis, values, parallel="vmap",
                                 device="cpu")
    theirs = repro.run_sweep(ref_spec, axis, values, parallel="vmap")
    assert len(ours) == len(theirs) == len(values)
    for a, b in zip(ours, theirs):
        assert a.extras["vmap_lanes"] == b.extras["vmap_lanes"]
        assert a.metrics.counters == b.metrics.counters
        assert_results_match(a.to_dict(), b.to_dict())


def test_compressed_vmap_sweep_matches_reference():
    ours_spec, ref_spec = _specs(
        compression={"kind": "topk", "params": {"keep": 0.25}})
    values = [1, 2, 5]
    ours = repro_torch.run_sweep(ours_spec, "schedule.params.h", values,
                                 parallel="vmap", device="cpu")
    theirs = repro.run_sweep(ref_spec, "schedule.params.h", values,
                             parallel="vmap")
    for a, b in zip(ours, theirs):
        assert a.extras["vmap_lanes"] == 3
        assert len(a.extras["compression"]["residual_norms"]) == 3
        assert_results_match(a.to_dict(), b.to_dict())


def test_vmap_sweep_falls_back_on_the_n_axis():
    """A shape-changing axis falls back to the serial executor with the
    reference's reason, on every result (metrics.notes and extras)."""
    ours_spec, ref_spec = _specs()
    ours = repro_torch.run_sweep(ours_spec, "problem.params.n", [4, 8],
                                 parallel="vmap", device="cpu")
    theirs = repro.run_sweep(ref_spec, "problem.params.n", [4, 8],
                             parallel="vmap")
    assert [r.spec.problem.params["n"] for r in ours] == [4, 8]
    for a, b in zip(ours, theirs):
        assert "vmap_lanes" not in a.extras
        reason = a.metrics.notes["vmap_fallback"]
        assert reason == a.extras["vmap_fallback"]
        assert reason == b.metrics.notes["vmap_fallback"]
        assert "lane fields" in reason and "2 distinct" in reason
        assert a.metrics.notes["loop"] == "eager"
        assert_results_match(a.to_dict(), b.to_dict())
    # the reason survives the JSON artifact round-trip
    rt = repro_torch.RunResult.from_json(ours[0].to_json())
    assert rt.metrics.notes["vmap_fallback"] == \
        ours[0].metrics.notes["vmap_fallback"]


def test_netsim_pool_gets_the_reference_reason():
    """A netsim spec is refused before anything is built, with the
    reference's reason; its serial fallback then runs the netsim backend,
    each cell the reference's fallback's bit for bit, carrying the
    reason."""
    ours_spec = repro_torch.ExperimentSpec(**_netsim_kw())
    ref_spec = repro.ExperimentSpec(**_netsim_kw())
    cells = [ours_spec.with_value("seed", s) for s in (0, 1)]
    ref_cells = [ref_spec.with_value("seed", s) for s in (0, 1)]
    out, reason = port_runner._run_sweep_vmap(cells, None, "cpu")
    ref_out, ref_reason = ref_runner._run_sweep_vmap(ref_cells, None)
    assert out is None and ref_out is None
    assert reason == ref_reason
    assert "not dense" in reason
    ours = repro_torch.run_sweep(ours_spec, "seed", [0, 1],
                                 parallel="vmap", device="cpu")
    theirs = repro.run_sweep(ref_spec, "seed", [0, 1], parallel="vmap")
    assert [r.spec.seed for r in ours] == [0, 1]
    for a, b in zip(ours, theirs):
        assert a.extras["vmap_fallback"] == b.extras["vmap_fallback"] == \
            a.metrics.notes["vmap_fallback"] == reason
        assert a.to_dict()["trace"] == b.to_dict()["trace"]
        assert_results_match(a.to_dict(), b.to_dict())


#: spec and backend changes that make a cell unbatchable, one reason each
UNBATCHABLE = {
    "controller": dict(controller={"kind": "dense_adaptive", "params": {}},
                       schedule={"kind": "adaptive", "params": {}}),
    "time_limit": dict(time_limit=5.0),
    "profile_dir": dict(profile_dir="profile"),
    "inv_sqrt": dict(stepsize={"kind": "inv_sqrt", "params": {"A": 0.5}}),
    "sequence": dict(topology={"kind": "expander_sequence",
                               "params": {"k": 4, "length": 2}}),
    "loop": dict(backends=[{"kind": "dense",
                            "params": {"loop": "segment"}}]),
    "unknown": dict(backends=[{"kind": "dense", "params": {"tile": 8}}]),
}


@pytest.mark.parametrize("change", sorted(UNBATCHABLE))
def test_batch_compat_report_gives_the_reference_reason(change):
    ours_spec, ref_spec = _specs(**UNBATCHABLE[change])
    ours = port_runner.batch_compat_report(
        ours_spec, ours_spec.backends[0], device="cpu")
    theirs = ref_runner.batch_compat_report(ref_spec, ref_spec.backends[0])
    assert ours is not None
    assert ours == theirs


def test_batch_compat_report_passes_a_batchable_cell():
    ours_spec, ref_spec = _specs()
    assert port_runner.batch_compat_report(
        ours_spec, ours_spec.backends[0], device="cpu") is None
    assert ref_runner.batch_compat_report(ref_spec,
                                          ref_spec.backends[0]) is None


def test_process_sweep_matches_serial_bitwise():
    """Dense cells across a spawn pool, on the CPU: each run is
    deterministic, so the merged results are the serial executor's bit for
    bit."""
    spec, _ = _specs()
    serial = repro_torch.run_sweep(spec, "seed", [0, 1], device="cpu")
    proc = repro_torch.run_sweep(spec, "seed", [0, 1], parallel="process",
                                 processes=2, device="cpu")
    for a, b in zip(serial, proc):
        assert a.spec == b.spec
        assert a.trace == b.trace
        assert a.extras == b.extras
        assert a.predictions == b.predictions
        assert b.metrics.notes == {"loop": "eager"}


def test_run_sweep_rejects_unknown_parallel():
    spec, _ = _specs()
    with pytest.raises(ValueError, match="parallel"):
        repro_torch.run_sweep(spec, "seed", [0], parallel="threads",
                              device="cpu")


def test_run_sweep_has_the_reference_signature_and_a_device():
    ours = inspect.signature(repro_torch.run_sweep)
    theirs = inspect.signature(repro.run_sweep)
    assert list(ours.parameters)[:-1] == list(theirs.parameters)
    assert ours.parameters["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert ours.parameters["device"].default is None
    assert repro_torch.run_sweep is port_runner.run_sweep
    assert port_runner._VMAP_LANE_FIELDS == ref_runner._VMAP_LANE_FIELDS
