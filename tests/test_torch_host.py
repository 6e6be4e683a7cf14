"""The host-side modules the port copies agree bitwise with the reference:
graphs, schedules, tradeoff algebra, specs, registries and the obs layer."""

import ast
import dataclasses
import importlib
import inspect
import json
import math
import pathlib

import numpy as np
import pytest

import repro
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


def test_adaptive_schedule_matches_reference_through_retunes():
    """The adaptive schedule built from the registry equals the reference's
    bit for bit, before and after the same retunes (eq. 21 re-solved and
    spliced in)."""
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
    # the reference's hardware model, with the card as the port's default
    assert ([f.name for f in dataclasses.fields(port_tradeoff.HardwareSpec)]
            == [f.name for f in dataclasses.fields(ref_tradeoff.HardwareSpec)])
    assert port_tradeoff.HardwareSpec() == port_tradeoff.H100_SXM
    hw = inspect.signature(port_tradeoff.derive_r_from_roofline).parameters[
        "hw"]
    assert hw.default is port_tradeoff.H100_SXM
    assert dataclasses.astuple(port_tradeoff.H100_SXM) == (
        989.4e12, 3.35e12, 25e9, 50e9, 80e9)
    doc = port_tradeoff.HardwareSpec.__doc__
    assert "H100 SXM5 80GB" in doc and "700 W" in doc and "data sheet" in doc


#: (message_bytes, local_step_flops, local_step_bytes, n, link_bw,
#: chips_per_node): compute-bound, memory-bound, an explicit link, a
#: multi-chip node
ROOFLINES = [
    (8.0, 2.6e9, 1.1e6, 16, None, 1),
    (4096.0 * 4, 1.0e6, 3.3e9, 256, None, 1),
    (1.6e7, 7.3e12, 2.1e10, 8, 50e9, 1),
    (3.2e9, 4.8e15, 1.9e12, 32, None, 4),
]


@pytest.mark.parametrize("args", ROOFLINES, ids=range(len(ROOFLINES)))
def test_derive_r_from_roofline_bitwise(args):
    """Given the reference's hardware fields, the port's r is the
    reference's to the bit (the defaults differ by design, so both sides
    are passed `hw`)."""
    msg, flops, nbytes, n, link_bw, chips = args
    ref_hw = ref_tradeoff.TPU_V5E
    port_hw = port_tradeoff.HardwareSpec(**dataclasses.asdict(ref_hw))
    kw = {"link_bw": link_bw, "chips_per_node": chips}
    theirs = ref_tradeoff.derive_r_from_roofline(msg, flops, nbytes, n,
                                                 ref_hw, **kw)
    ours = port_tradeoff.derive_r_from_roofline(msg, flops, nbytes, n,
                                                port_hw, **kw)
    assert type(ours) is type(theirs) is float
    assert ours == theirs


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


#: every public name of `repro` (defined in a module, or re-exported by a
#: package) that the port's same module lacks: its counterpart in the port,
#: or None where the name is jax's alone (ROADMAP.md, the name map)
NAME_MAP = {
    "compress/__init__.py:topk_mask_jax": "compress:topk_mask_torch",
    "compress/base.py:topk_mask_jax": "compress.base:topk_mask_torch",
    "core/__init__.py:TPU_V5E": "core:H100_SXM",
    "core/tradeoff.py:TPU_V5E": "core.tradeoff:H100_SXM",
    "core/consensus.py:PyTree": None,
    "core/dda.py:PyTree": None,
    "launch/train.py:PyTree": None,
    "kernels/flash_attention.py:NEG_INF": None,
    "kernels/ops.py:gossip_gather_mix": "kernels.ops:gossip_gather_mix_impl",
    "kernels/ops.py:compress_mix": "kernels.ops:compress_mix_impl",
    "launch/compat.py": None,
    "launch/dryrun.py:collective_bytes": "launch.dryrun:CollectiveBytes",
    "launch/specs.py:to_shardings": "launch.specs:placements",
    "netsim/__init__.py:jax_batch_grad": "netsim:torch_batch_grad",
    "netsim/engine.py:jax_batch_grad": "netsim.engine:torch_batch_grad",
    "runtime/__init__.py:tree_shardings": "runtime:tree_placements",
    "runtime/sharding.py:tree_shardings": "runtime.sharding:tree_placements",
}


def _public_names(path: pathlib.Path, package: str) -> set[str]:
    """A module's public top-level names: what it defines, what its
    `__all__` lists and, in a package's `__init__`, what it re-exports
    from its own package."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out.add(target.id)
                    if (target.id == "__all__"
                            and isinstance(node.value, ast.List)):
                        out |= {e.value for e in node.value.elts}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            out.add(node.target.id)
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and node.module and node.module.startswith(package)):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def test_every_public_name_of_the_reference_has_its_counterpart():
    """An AST walk over `src/repro/`: each public name is in the port's
    same module (imported, so lazy exports count), or in `NAME_MAP` with
    its counterpart, which must exist."""
    src = ROOT / "src"
    missing = set()
    for path in sorted((src / "repro").rglob("*.py")):
        rel = path.relative_to(src / "repro")
        port = src / "repro_torch" / rel
        if not port.exists():
            missing.add(str(rel))
            continue
        names = _public_names(path, "repro")
        if rel.name == "__main__.py":
            have = _public_names(port, "repro_torch")
        else:
            module = ".".join(("repro_torch",) + rel.with_suffix("").parts)
            module = importlib.import_module(
                module.removesuffix(".__init__"))
            have = {n for n in names if hasattr(module, n)}
        missing |= {f"{rel}:{n}" for n in names - have}
    assert missing == set(NAME_MAP)
    assert [n for n in repro.__all__ if not hasattr(repro_torch, n)] == []
    for counterpart in filter(None, NAME_MAP.values()):
        module, name = counterpart.split(":")
        assert hasattr(importlib.import_module(f"repro_torch.{module}"),
                       name), counterpart
