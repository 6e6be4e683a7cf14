"""The dense closed loop (`experiments.runner._dense_adaptive_run`: the
one-lane run program replayed a uniform-comm chunk at a time, each chunk
timed and fed to `adaptive.DenseController`) against the reference's, on
the CPU, under one injected clock: a fake timer that charges each chunk
what eq. 9 says it costs (1/n an iteration, plus k * r_true when it
communicates). The reference's test (tests/test_experiments.py:315)
charges its `_segment`; the port's seam is `DDASimulator.run_chunk`.

Exact: retunes (every field), h_final, r_hat and its trajectory, and the
trace's iters, sim_time and comms. Within rtol 1e-5, atol 1e-6 (the port's
float32 tolerance, `convert.RTOL`/`ATOL`): fvals, fvals_consensus,
disagreement and the residual norms.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adaptive import AdaptiveSchedule as RefSchedule
from repro.adaptive import DenseController as RefController
from repro.compress import build_compressor as ref_compressor
from repro.core.dda import DDASimulator as RefSim
from repro.core.dda import stepsize_sqrt as ref_stepsize
from repro.experiments import components as ref_C
from repro.experiments.runner import _dense_adaptive_run as ref_loop

import repro_torch
from repro_torch.adaptive import AdaptiveSchedule, DenseController
from repro_torch.compress import build_compressor
from repro_torch.convert import ATOL, RTOL
from repro_torch.core.dda import DDASimulator, stepsize_sqrt
from repro_torch.experiments import components as C
from repro_torch.experiments.runner import _dense_adaptive_run

CPU = torch.device("cpu")


class FakeClock:
    """Reads the charge of the chunks run so far."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


#: (topology, n, d, r_true, compression): the reference test's two cases
#: on the complete graph (h must stay 1 at r_true 0.05, and must rise at
#: 5.0), and an expander k=4 under top-k (the sparse mix through K2's
#: plain version; r_true 50, since the controller scales the measured r
#: by top-k's wire ratio before it solves for h)
CASES = {
    "complete-cheap": (("complete", {}), 8, 4, 0.05, None),
    "complete-costly": (("complete", {}), 8, 4, 5.0, None),
    "expander-topk": (("expander", {"k": 4, "seed": 0}), 16, 8, 50.0,
                      ("topk", {"keep": 0.25})),
}


def _pair(case):
    (topo, tparams), n, d, r_true, comp = CASES[case]
    ref_p = ref_C.build_component(ref_C.problems, "quadratic_consensus",
                                  {"n": n, "d": d, "seed": 0})
    port_p = C.build_component(C.problems, "quadratic_consensus",
                               {"n": n, "d": d, "seed": 0}, device=CPU)
    ref_g = ref_C.build_component(ref_C.topologies, topo, tparams, n=n)
    port_g = C.build_component(C.topologies, topo, tparams, n=n)
    k = port_g.degree
    ref_kw, port_kw = {}, {}
    if comp is not None:
        ref_kw["compression"] = ref_compressor(*comp)
        port_kw["compression"] = build_compressor(*comp)
    ref_sched, port_sched = RefSchedule(h0=1), AdaptiveSchedule(h0=1)
    ref = RefSim(ref_p.subgrad_stack, ref_p.objective, ref_g, ref_sched,
                 a_fn=ref_stepsize(0.5), r=0.5, **ref_kw)
    port = DDASimulator(port_p.subgrad_stack, port_p.objective, port_g,
                        port_sched, a_fn=stepsize_sqrt(0.5), r=0.5,
                        device=CPU, **port_kw)

    def charge(comm, iters):
        return (1.0 / n + (k * r_true if comm else 0.0)) * iters

    ref_clock, port_clock = FakeClock(), FakeClock()
    real_segment, real_chunk = ref._segment, port.run_chunk

    def charged_segment(z, x, xhat, res, t, mask, keys):
        mask = np.asarray(mask)
        ref_clock.t += charge(bool(mask[0]), len(mask))
        return real_segment(z, x, xhat, res, t, mask, keys)

    def charged_chunk(comm, chunk):
        port_clock.t += charge(comm, chunk)
        return real_chunk(comm, chunk)

    ref._segment = charged_segment
    port.run_chunk = charged_chunk
    c = port.wire_ratio(d)
    ref_ctrl = RefController(ref_sched, warmup_comm=2, wire_ratio=c)
    port_ctrl = DenseController(port_sched, warmup_comm=2, wire_ratio=c)
    return ((ref, ref_ctrl, ref_clock, jnp.zeros((n, d))),
            (port, port_ctrl, port_clock, torch.zeros((n, d))), r_true)


@pytest.mark.parametrize("case", sorted(CASES))
def test_closed_loop_matches_reference_under_injected_clock(case):
    (ref, ref_ctrl, ref_clock, ref_x0), (port, ctrl, clock, x0), r_true = \
        _pair(case)
    ref_timings = {"compile_s": 0.0, "iter_walls": []}
    timings = {"compile_s": 0.0, "iter_walls": []}
    theirs = ref_loop(ref, ref_ctrl, ref_x0, T=200, eval_every=20, seed=0,
                      timer=ref_clock, timings=ref_timings)
    ours = _dense_adaptive_run(port, ctrl, x0, T=200, eval_every=20, seed=0,
                               timer=clock, timings=timings)
    assert port.last_loop == "eager"
    assert clock.t == ref_clock.t
    assert timings["iter_walls"] == ref_timings["iter_walls"]
    # constant injected timings: inverting eq. 9 recovers r_true
    assert ctrl.tracker.r_hat == ref_ctrl.tracker.r_hat
    assert ctrl.tracker.r_hat == pytest.approx(r_true, rel=1e-6)
    assert ctrl.r_hat_history == ref_ctrl.r_hat_history
    sched, ref_sched = ctrl.schedule, ref_ctrl.schedule
    assert [dataclasses.astuple(rt) for rt in sched.retunes] == \
        [dataclasses.astuple(rt) for rt in ref_sched.retunes]
    assert sched.h_current == ref_sched.h_current
    if case == "complete-cheap":
        assert sched.h_current == 1 and not sched.retunes
    else:
        assert sched.h_current > 1 and sched.retunes
        assert all(rt.from_t < 200 for rt in sched.retunes)
    for f in ("iters", "sim_time", "comms"):
        assert getattr(ours, f) == getattr(theirs, f), f
    for f in ("fvals", "fvals_consensus", "disagreement"):
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    if port.compression is None:
        assert port.last_res_norms is None and ref.last_res_norms is None
    else:
        assert len(port.last_res_norms) == len(ours.iters)
        np.testing.assert_allclose(port.last_res_norms, ref.last_res_norms,
                                   rtol=RTOL, atol=ATOL)


def test_closed_loop_reads_the_schedule_live():
    """A retune at a segment boundary shapes the chunks after it: the
    comm rounds the loop ran equal the schedule's H(T) after the run, with
    its splices, and differ from the h0 pattern's."""
    _, (port, ctrl, clock, x0), _ = _pair("complete-costly")
    trace = _dense_adaptive_run(port, ctrl, x0, T=200, eval_every=20,
                                seed=0, timer=clock)
    assert ctrl.schedule.retunes
    assert trace.comms[-1] == ctrl.schedule.H(200)
    assert trace.comms[-1] < 199


def _run_api_spec(**changes):
    spec = dict(
        name="dense-adaptive",
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 8, "d": 4, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "adaptive", "params": {"h0": 1}},
        controller={"kind": "dense_adaptive",
                    "params": {"warmup_comm": 2, "warmup_plain": 1}},
        backends=[{"kind": "dense"}],
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        T=120, eval_every=20, seed=0, r=0.5)
    spec.update(changes)
    return repro_torch.ExperimentSpec(**spec)


def test_dense_adaptive_through_run_api():
    """The port copy of tests/test_experiments.py::
    test_dense_adaptive_through_run_api, plus the port's record of how the
    run ran and the reference's metrics keys."""
    res = repro_torch.run(_run_api_spec(), device="cpu")
    assert res.trace.iters[-1] == 120
    assert "retunes" in res.extras and "r_hat" in res.extras
    assert set(res.extras) == {"mix_mode", "retunes", "h_final", "r_hat"}
    # no phantom end-of-run splice: every recorded retune shaped at least
    # one future iteration
    assert all(t < 120 for t, _ in res.extras["retunes"])
    assert np.isfinite(res.trace.fvals).all()
    m = res.metrics
    assert m.notes == {"loop": "eager"}
    assert m.retunes == len(res.extras["retunes"])
    assert m.step_time_quantiles is not None
    assert m.compile_s + m.execute_s == pytest.approx(res.wall_s)
    assert m.gossip_rounds == res.trace.comms[-1]


def test_dense_adaptive_compressed_sets_the_wire_ratio():
    spec = _run_api_spec(compression={"kind": "topk",
                                      "params": {"keep": 0.25}})
    res = repro_torch.run(spec, device="cpu")
    block = res.extras["compression"]
    assert block["wire_ratio"] == res.predictions["wire_ratio"] < 1.0
    assert len(block["residual_norms"]) == len(res.trace.iters)
    assert all(v > 0 for v in block["residual_norms"])


@pytest.mark.parametrize("change,match", [
    (dict(backends=[{"kind": "dense", "params": {"loop": "segment"}}]),
     "leave the 'loop' param unset"),
    (dict(controller={"kind": "adaptive", "params": {}}),
     "needs a 'dense_adaptive' controller"),
    (dict(schedule={"kind": "periodic", "params": {"h": 2}}),
     "schedule kind 'adaptive'"),
])
def test_dense_controller_refusals(change, match):
    with pytest.raises(ValueError, match=match):
        repro_torch.run(_run_api_spec(**change), device="cpu")
