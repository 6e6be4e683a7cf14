"""The host-side modules the port copies agree bitwise with the reference:
graphs, schedules, tradeoff algebra, specs, registries and the obs layer."""

import json
import math
import pathlib

import numpy as np
import pytest

import repro.experiments as ref_exp
from repro.core import tradeoff as ref_tradeoff
from repro.experiments import components as ref_C
from repro.obs import RunMetrics as RefRunMetrics
from repro.obs import render_summary as ref_render_summary

import repro_torch
import repro_torch.experiments as port_exp
from repro_torch.core import tradeoff as port_tradeoff
from repro_torch.experiments import components as port_C
from repro_torch.obs import RunMetrics as PortRunMetrics
from repro_torch.obs import render_summary as port_render_summary

ROOT = pathlib.Path(__file__).resolve().parents[1]
MANIFESTS = sorted((ROOT / "benchmarks" / "manifests").glob("*.json"))

TOPOLOGIES = [
    ("complete", {}, 10),
    ("ring", {}, 9),
    ("torus", {}, 16),
    ("hypercube", {}, 16),
    ("expander", {"k": 4}, 16),
    ("expander", {"k": 6, "seed": 3}, 24),
    ("rregular", {"k": 4}, 12),
    ("expander_sequence", {"k": 4, "length": 3}, 12),
]

SCHEDULES = [
    ("every", {}),
    ("periodic", {"h": 1}),
    ("periodic", {"h": 3}),
    ("sparse", {"p": 0.1}),
    ("sparse", {"p": 0.3}),
    ("piecewise", {"h": 2}),
]


def _graphs_equal(a, b):
    assert a.name == b.name and a.n == b.n and a.degree == b.degree
    assert a.perms == b.perms
    assert a.self_weight == b.self_weight and a.edge_weight == b.edge_weight
    np.testing.assert_array_equal(a.mixing_matrix(), b.mixing_matrix())
    assert a.lambda2() == b.lambda2()


@pytest.mark.parametrize("kind,params,n", TOPOLOGIES,
                         ids=[f"{k}-{n}" for k, _, n in TOPOLOGIES])
def test_topologies_bitwise(kind, params, n):
    ref = ref_C.build_component(ref_C.topologies, kind, params, n=n)
    port = port_C.build_component(port_C.topologies, kind, params, n=n)
    assert type(ref).__name__ == type(port).__name__
    if kind == "expander_sequence":
        assert len(ref) == len(port)
        for i in range(len(ref)):
            _graphs_equal(ref.at(i), port.at(i))
        assert ref.lambda2_worst() == port.lambda2_worst()
    else:
        _graphs_equal(ref, port)


def _schedule_record(s, tradeoff, lam2=0.4):
    t = np.arange(1, 121)
    return {
        "mask0": s.comm_mask(0, 120).tolist(),
        "mask37": s.comm_mask(37, 50).tolist(),
        "is_comm": [bool(s.is_comm_step(int(i))) for i in t],
        "H": [int(s.H(int(i))) for i in t],
        "next": np.asarray(s.next_comm_step_batch(t)).tolist(),
        "constant": s.constant(1.0, 1.0, lam2),
        "tau": tradeoff.time_to_accuracy(0.1, 16, 4, 0.05, lam2,
                                         schedule=s),
    }


@pytest.mark.parametrize("kind,params", SCHEDULES,
                         ids=[f"{k}-{p}" for k, p in SCHEDULES])
def test_schedules_bitwise(kind, params):
    ref = ref_C.build_component(ref_C.schedules, kind, params)
    port = port_C.build_component(port_C.schedules, kind, params)
    if kind == "piecewise":
        for s in (ref, port):
            s.set_h(30, 5)
            s.set_h(70, 1)
    assert (_schedule_record(ref, ref_tradeoff)
            == _schedule_record(port, port_tradeoff))


def test_adaptive_schedule_is_not_ported():
    """Named for the refusal it used to pin: the adaptive schedule is now
    ported, and built from the registry it equals the reference's bit for
    bit, before and after the same retunes (eq. 21 re-solved and spliced
    in)."""
    params = {"h0": 2, "p": 0.1, "h_max": 16}
    ref = ref_C.build_component(ref_C.schedules, "adaptive", params)
    port = port_C.build_component(port_C.schedules, "adaptive", params)
    assert type(port).__name__ == type(ref).__name__ == "AdaptiveSchedule"
    assert (_schedule_record(ref, ref_tradeoff)
            == _schedule_record(port, port_tradeoff))
    for s in (ref, port):
        assert s.retune(30, 16, 4, 40.0, 0.6)
        s.retune(70, 16, 4, 0.01, 0.6)
    assert [(r.from_t, r.h, r.h_opt_raw) for r in port.retunes] == \
        [(r.from_t, r.h, r.h_opt_raw) for r in ref.retunes]
    assert port.h_current == ref.h_current
    assert (_schedule_record(ref, ref_tradeoff)
            == _schedule_record(port, port_tradeoff))


def test_tradeoff_functions_bitwise():
    args = [(16, 4, 0.05, 0.3), (256, 4, 0.01, 0.61), (10, 9, 0.00089, 0.0)]
    for n, k, r, lam2 in args:
        for c in (1.0, 0.25):
            assert (ref_tradeoff.iteration_cost(n, k, r, c)
                    == port_tradeoff.iteration_cost(n, k, r, c))
            assert (ref_tradeoff.n_opt_complete(r, c)
                    == port_tradeoff.n_opt_complete(r, c))
            assert ref_tradeoff.h_opt(n, k, r, lam2, c) == \
                port_tradeoff.h_opt(n, k, r, lam2, c)
            assert ref_tradeoff.h_opt_int(n, k, r, lam2, c) == \
                port_tradeoff.h_opt_int(n, k, r, lam2, c)
            assert ref_tradeoff.time_to_accuracy(0.1, n, k, r, lam2, c=c) \
                == port_tradeoff.time_to_accuracy(0.1, n, k, r, lam2, c=c)
        assert ref_tradeoff.predict_speedup(n, k, r, lam2) == \
            port_tradeoff.predict_speedup(n, k, r, lam2)
    assert ref_tradeoff.measure_r(0.85, 29.0) == \
        port_tradeoff.measure_r(0.85, 29.0)
    alpha = ref_tradeoff.ew_alpha(7.0)
    assert alpha == port_tradeoff.ew_alpha(7.0)
    for mean in (math.nan, 0.3):
        assert (ref_tradeoff.ew_update(mean, 0.5, 4, alpha)
                == port_tradeoff.ew_update(mean, 0.5, 4, alpha))
    P = np.full((5, 5), 0.2)
    assert ref_tradeoff.lambda2_fast(P) == port_tradeoff.lambda2_fast(P)
    assert not hasattr(port_tradeoff, "HardwareSpec")


@pytest.mark.parametrize("path", MANIFESTS, ids=[p.stem for p in MANIFESTS])
def test_manifest_round_trips_json_exact(path):
    raw = json.loads(path.read_text())
    port = port_exp.ExperimentSpec.from_file(path)
    ref = ref_exp.ExperimentSpec.from_file(path)
    assert port.to_dict() == ref.to_dict() == raw
    assert port.to_json() == ref.to_json()
    assert port_exp.ExperimentSpec.from_json(port.to_json()) == port


def test_registries_name_the_same_kinds():
    for name in ("problems", "topologies", "schedules", "stepsizes",
                 "backends"):
        assert (getattr(port_exp, name).names()
                == getattr(ref_exp, name).names()), name


def test_obs_layer_renders_a_result_identically():
    spec = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / "expander_sparse.json")
    d = repro_torch.run(spec, "dense", device="cpu").to_dict()
    assert port_render_summary(d) == ref_render_summary(d)
    m = d["metrics"]
    assert (PortRunMetrics.from_dict(m).to_dict()
            == RefRunMetrics.from_dict(m).to_dict() == m)
    assert (port_exp.RunResult.from_dict(d).to_dict()
            == ref_exp.RunResult.from_dict(d).to_dict() == d)
