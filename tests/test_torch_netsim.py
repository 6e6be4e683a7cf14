"""The port's netsim backend (`repro_torch.run(spec, backend)` on a netsim
backend) against the reference's, on the CPU: every netsim backend of the
checked-in manifests and a short list of small specs that reach the other
mechanisms (loss with jitter and retries, stragglers, a time-varying
topology, push-sum, compression, straggler reweighting of the gossip, a
fault plan restoring from on-disk checkpoints), each on both engines.

Tolerance: none. The event loops are the reference's numpy copied, so
traces must be equal bit for bit, and extras, `r_measurement` and
predictions exactly; `assert_results_match` then holds the rest. Also
the netsim node: `NodeSpec`'s scale is the reference's ratio of peak
FLOP/s, the same float for every straggler factor; and
`torch_batch_grad`, `jax_batch_grad`'s twin (rtol 1e-6: both compute in
float32).
"""

import copy
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro
import repro.experiments  # before repro.netsim: the reference's import order
from repro.netsim import NodeSpec as RefNodeSpec

import repro_torch
from repro_torch.convert import assert_results_match
from repro_torch.core.tradeoff import HardwareSpec
from repro_torch.netsim import NodeSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]
MANIFESTS = ROOT / "benchmarks" / "manifests"
NETSIM_MANIFESTS = ("adaptive_adversarial", "churn_adversarial",
                    "complete_every", "compressed_expander",
                    "expander_periodic", "expander_sparse")


def _netsim_backends():
    out = []
    for name in NETSIM_MANIFESTS:
        spec = json.loads((MANIFESTS / f"{name}.json").read_text())
        for i, b in enumerate(spec["backends"]):
            if b["kind"] == "netsim":
                out.append((name, i, b["params"].get("engine", "auto")))
    return out


NETSIM_BACKENDS = _netsim_backends()


def _both(spec_dict, backend=None):
    ours = repro_torch.run(repro_torch.ExperimentSpec.from_dict(spec_dict),
                           backend, device="cpu")
    theirs = repro.run(repro.ExperimentSpec.from_dict(spec_dict), backend)
    return ours, theirs


def _assert_bitwise(ours, theirs):
    a, b = ours.to_dict(), theirs.to_dict()
    assert a["trace"] == b["trace"]
    assert a["extras"] == b["extras"]
    assert a["r_measurement"] == b["r_measurement"]
    assert a["predictions"] == b["predictions"]
    assert a["time_to_target"] == b["time_to_target"]
    assert_results_match(a, b)
    for key in ("msgs", "drops", "bytes_on_wire", "gossip_rounds", "retunes",
                "retune_history", "r_hat", "r_hat_trajectory", "faults",
                "compression", "step_time_quantiles"):
        assert a["metrics"].get(key) == b["metrics"].get(key), key
    return a


def test_every_manifest_netsim_backend_is_listed():
    assert len(NETSIM_BACKENDS) == 11
    assert {e for _, _, e in NETSIM_BACKENDS} == {"object", "vectorized"}


@pytest.mark.parametrize("name,index,engine", NETSIM_BACKENDS,
                         ids=[f"{n}-{e}" for n, _, e in NETSIM_BACKENDS])
def test_netsim_manifest_matches_reference(name, index, engine):
    spec = json.loads((MANIFESTS / f"{name}.json").read_text())
    ours, theirs = _both(spec, index)
    d = _assert_bitwise(ours, theirs)
    assert d["extras"]["engine"] == engine
    assert d["extras"]["sent"] > 0
    assert np.isfinite(d["trace"]["fvals"]).all()
    if name == "adaptive_adversarial":
        assert d["extras"]["retunes"], "the closed loop must retune"
        assert d["extras"]["drops"] > 0
    if name == "churn_adversarial":
        assert d["extras"]["faults"]["crashes"] > 0
        assert d["extras"]["drops"] > 0


def _small(backend_params, **fields):
    spec = {
        "name": "netsim_small",
        "problem": {"kind": "quadratic_consensus",
                    "params": {"n": 8, "d": 4, "seed": 0}},
        "topology": {"kind": "expander", "params": {"k": 4, "seed": 0}},
        "schedule": {"kind": "periodic", "params": {"h": 2}},
        "backends": [{"kind": "netsim", "params": backend_params}],
        "T": 80, "eval_every": 10, "seed": 3, "r": 0.05, "eps_frac": 0.2,
    }
    spec.update(fields)
    return spec


#: small specs, one for each mechanism the manifests leave out or touch
#: only in passing
SMALL = {
    "lossy_jitter_retries": _small({"scenario": "lossy", "loss": 0.2,
                                    "jitter": 0.01, "retries": 2,
                                    "retry_timeout": 0.05}),
    "straggler": _small({"scenario": "straggler", "slow_factor": 2.5,
                         "n_slow": 3}),
    # 197e12 / (197e12 / 5.35) is 5.3500000000000005, not 5.35: the
    # straggler's scale must be the reference's ratio, not the factor
    "straggler_factor_5_35": _small({"scenario": "straggler",
                                     "slow_factor": 5.35, "n_slow": 3}),
    "time_varying": _small(
        {"scenario": "time_varying", "rewire_every": 0.5, "loss": 0.1},
        topology={"kind": "expander_sequence",
                  "params": {"k": 4, "length": 3, "seed": 1}}),
    "pushsum": _small({"scenario": "lossy", "loss": 0.3,
                       "algorithm": "pushsum", "pushsum_inject": "scaled"}),
    "compression": _small({"scenario": "homogeneous"},
                          compression={"kind": "randk",
                                       "params": {"keep": 0.5, "seed": 2}}),
    "reweight_gossip": _small(
        {"scenario": "straggler", "slow_factor": 4.0, "n_slow": 2},
        topology={"kind": "expander", "params": {"k": 8, "seed": 0}},
        schedule={"kind": "adaptive", "params": {"h0": 1}},
        controller={"kind": "adaptive",
                    "params": {"update_every": 0.5, "warmup_messages": 4,
                               "warmup_steps": 4, "reweight_gossip": True}},
        stepsize={"kind": "inv_sqrt", "params": {"A": 0.5}}),
}


@pytest.mark.parametrize("engine", ["object", "vectorized"])
@pytest.mark.parametrize("case", sorted(SMALL))
def test_netsim_mechanism_matches_reference(case, engine):
    spec = copy.deepcopy(SMALL[case])
    spec["backends"][0]["params"]["engine"] = engine
    ours, theirs = _both(spec)
    d = _assert_bitwise(ours, theirs)
    assert d["extras"]["engine"] == engine
    if case in ("lossy_jitter_retries", "pushsum", "time_varying"):
        assert d["extras"]["drops"] > 0
    if case == "lossy_jitter_retries":
        assert d["metrics"]["faults"]["retransmits"] > 0
    if case == "time_varying":
        assert d["extras"]["rewires"] > 0
    if case == "compression":
        assert d["extras"]["compression"]["residual_norms"]
    if case == "reweight_gossip":
        assert d["extras"]["reweight_gossip"] is True
        assert d["extras"]["lam2_eff"] is not None


def _restore_spec(directory, engine):
    return _small(
        {"scenario": "homogeneous", "engine": engine},
        faults={"kind": "plan", "params": {
            "events": [{"time": 0.8, "action": "crash", "node": 2},
                       {"time": 1.5, "action": "restart", "node": 2}],
            "restore": "checkpoint", "checkpoint_every": 0.25,
            "checkpoint_dir": str(directory), "checkpoint_keep": 2,
            "seed": 1}})


@pytest.mark.parametrize("engine", ["object", "vectorized"])
def test_checkpoint_restore_plan_matches_reference(tmp_path, engine):
    """A crash restored from the periodic checkpoints, written to disk by
    each side's CheckpointManager: the same run, and the two directories
    hold the same committed steps with the same arrays."""
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours = repro_torch.run(repro_torch.ExperimentSpec.from_dict(
        _restore_spec(ours_dir, engine)), device="cpu")
    theirs = repro.run(repro.ExperimentSpec.from_dict(
        _restore_spec(ref_dir, engine)))
    a, b = ours.to_dict(), theirs.to_dict()
    # the specs differ only in where the checkpoints go
    a["spec"]["faults"]["params"]["checkpoint_dir"] = str(ref_dir)
    assert a["trace"] == b["trace"] and a["extras"] == b["extras"]
    assert_results_match(a, b)
    stats = a["extras"]["faults"]
    assert stats["checkpoints"] > 0 and stats["restarts"] == 1
    steps = sorted(p.name for p in ours_dir.glob("step_*"))
    assert steps and steps == sorted(p.name for p in ref_dir.glob("step_*"))
    for step in steps:
        with np.load(ours_dir / step / "arrays.npz") as x, \
                np.load(ref_dir / step / "arrays.npz") as y:
            assert sorted(x.files) == sorted(y.files) == [
                f"a{i}" for i in range(5)]
            for f in x.files:
                assert x[f].dtype == y[f].dtype
                np.testing.assert_array_equal(x[f], y[f])
        assert json.loads((ours_dir / step / "meta.json").read_text()) == \
            json.loads((ref_dir / step / "meta.json").read_text())


#: every straggler factor the scenarios and manifests use
SLOW_FACTORS = (1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0)


@pytest.mark.parametrize("factor", SLOW_FACTORS)
def test_nodespec_scale_is_the_references_ratio(factor):
    """Both packages derive a straggler's scale as the ratio of the nominal
    node's peak FLOP/s to the slowed node's, so for the factors the
    scenarios and manifests use the scales are the same float, and an
    explicit `compute_scale` is taken as given."""
    ours, theirs = NodeSpec.slowed(factor), RefNodeSpec.slowed(factor)
    assert ours.scale == theirs.scale
    assert type(ours.scale) is type(theirs.scale) is float
    assert NodeSpec().scale == RefNodeSpec().scale == 1.0
    assert NodeSpec(compute_scale=factor).scale == \
        RefNodeSpec(compute_scale=factor).scale


def _port_hw(ref_hw):
    return HardwareSpec(**dataclasses.asdict(ref_hw))


@settings(max_examples=200, deadline=None)
@given(factor=st.floats(0.1, 64.0), peak=st.floats(1e9, 1e16))
def test_nodespec_scale_is_the_references_float_for_every_factor(factor,
                                                                 peak):
    """For any factor the port's straggler scale is the reference's float
    (`197e12 / (197e12 / 5.35)` is 5.3500000000000005, not 5.35), and so is
    the scale of a node given as `hw` and `ref` with equal field values."""
    assert NodeSpec.slowed(factor).scale == RefNodeSpec.slowed(factor).scale
    ref_hw = dataclasses.replace(RefNodeSpec().hw, peak_flops=peak)
    ref_ref = dataclasses.replace(RefNodeSpec().ref, peak_flops=peak * factor)
    ours = NodeSpec(hw=_port_hw(ref_hw), ref=_port_hw(ref_ref))
    assert ours.scale == RefNodeSpec(hw=ref_hw, ref=ref_ref).scale
    assert NodeSpec.slowed(factor) == NodeSpec(
        hw=_port_hw(RefNodeSpec.slowed(factor).hw))


def test_torch_batch_grad_matches_jax_batch_grad():
    """The vmapped torch gradient against the reference's vmapped jax one
    on the same per-node function and inputs: both compute in float32, so
    within rtol 1e-6."""
    import jax.numpy as jnp

    from repro.netsim.engine import jax_batch_grad
    from repro_torch.netsim import torch_batch_grad

    rng = np.random.default_rng(0)
    n, d, b = 8, 6, 5
    centers = rng.normal(size=(n, d)) * 2.0 + 3.0
    c_j, c_t = jnp.asarray(centers), torch.as_tensor(centers,
                                                     dtype=torch.float32)

    def jax_grad(i, x, t):
        return 2.0 * (x - c_j[i]) / jnp.sqrt(1.0 + t)

    def torch_grad(i, x, t):
        return 2.0 * (x - c_t[i]) / torch.sqrt(1.0 + t)

    idx = np.array([0, 3, 3, 7, 1])
    x = rng.normal(size=(b, d))
    t = np.array([0, 1, 5, 9, 2])
    ours = torch_batch_grad(torch_grad, device="cpu")(idx, x, t)
    theirs = jax_batch_grad(jax_grad)(idx, x, t)
    assert ours.dtype == theirs.dtype == np.float64
    assert ours.shape == (b, d)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


def test_torch_batch_grad_drives_the_vectorized_engine():
    """A NetSimulator given the torch batch gradient runs to the end; its
    trace stays close to the numpy gradient's (float32 against float64)."""
    from repro_torch.netsim import NetSimulator, homogeneous
    from repro_torch.netsim import quadratic_consensus, torch_batch_grad

    n, d = 8, 4
    centers, grad_fn, eval_fn = quadratic_consensus(n, d, seed=0)
    c_t = torch.as_tensor(centers, dtype=torch.float32)
    batch = torch_batch_grad(lambda i, x, t: 2.0 * (x - c_t[i]),
                             device="cpu")
    runs = []
    for bg in (None, batch):
        sim = NetSimulator(homogeneous(n, 0.05, seed=1), grad_fn, eval_fn,
                           seed=0, engine="vectorized", batch_grad_fn=bg)
        runs.append(sim.run(np.zeros((n, d)), 60, eval_every=10))
    assert runs[0].iters == runs[1].iters
    np.testing.assert_allclose(runs[1].fvals, runs[0].fvals, rtol=1e-5)


def test_netsim_backend_keeps_the_device_rule(monkeypatch):
    spec = repro_torch.ExperimentSpec.from_file(
        MANIFESTS / "expander_periodic.json")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.run(spec, 1)
