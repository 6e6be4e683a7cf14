"""Per problem: the port's data tensors equal the reference's, its numpy
halves are the reference's bit for bit, and its torch halves
(`subgrad_stack`, `objective`, `projection`) agree with the jax halves on
seeded inputs."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import components as ref_C

from repro_torch.convert import problem_arrays
from repro_torch.experiments import components as port_C

CASES = [
    ("quadratic_consensus", {"n": 6, "d": 5}),
    ("quadratic_consensus", {"n": 5, "d": 7, "seed": 3, "batchable": True}),
    ("nonsmooth", {"n": 4, "M": 5, "d": 6}),
    ("least_squares", {"n": 5, "d": 8, "m_per_node": 20}),
    ("metric_learning", {"n": 4, "m_pairs": 200, "d_feat": 4}),
]
IDS = [f"{k}-{i}" for i, (k, _) in enumerate(CASES)]

#: float32 agreement of the device halves: the two libraries sum in
#: different orders, so agreement is to a few ulps of the summed terms
RTOL, ATOL = 1e-5, 1e-5


def _build(kind, params):
    ref = ref_C.build_component(ref_C.problems, kind, params)
    port = port_C.build_component(port_C.problems, kind, params,
                                  device=torch.device("cpu"))
    return ref, port


def _reference_arrays(problem):
    """The jax arrays the reference's device closures read, by name."""
    out = {}
    for fn in (problem.subgrad_stack, problem.objective, problem.projection):
        if fn is None:
            continue
        for name, value in inspect.getclosurevars(fn).nonlocals.items():
            if isinstance(value, jax.Array):
                out[name] = np.asarray(value)
    return out


def _x_stack(problem, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(problem.n, problem.d)).astype(np.float32)


@pytest.mark.parametrize("kind,params", CASES, ids=IDS)
def test_data_arrays_equal(kind, params):
    ref, port = _build(kind, params)
    ours, theirs = problem_arrays(port), _reference_arrays(ref)
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert ours[name].dtype == theirs[name].dtype == np.float32, name
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


@pytest.mark.parametrize("kind,params", CASES, ids=IDS)
def test_numpy_halves_bitwise(kind, params):
    ref, port = _build(kind, params)
    assert (port.n, port.d, port.name) == (ref.n, ref.d, ref.name)
    x = _x_stack(ref, 1).astype(np.float64)
    for i in range(ref.n):
        np.testing.assert_array_equal(port.grad_fn(i, x[i], 3),
                                      ref.grad_fn(i, x[i], 3))
    assert port.eval_fn(x[0]) == ref.eval_fn(x[0])
    if ref.fstar_fn is not None:
        assert port.fstar == ref.fstar
        assert port.eps_value(0.05) == ref.eps_value(0.05)
    else:
        assert port.fstar_fn is None


@pytest.mark.parametrize("kind,params", CASES, ids=IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_device_halves_agree(kind, params, seed):
    ref, port = _build(kind, params)
    x = _x_stack(ref, seed)
    if kind == "metric_learning":
        x *= 0.05  # keep the hinge margins away from their kink at 0
    g_ref = np.asarray(ref.subgrad_stack(jnp.asarray(x), 0.0, None))
    g_port = port.subgrad_stack(torch.from_numpy(x), torch.tensor(0.0), None)
    np.testing.assert_allclose(g_port.numpy(), g_ref, rtol=RTOL, atol=ATOL)

    f_ref = np.asarray(jax.vmap(ref.objective)(jnp.asarray(x)))
    f_port = torch.func.vmap(port.objective)(torch.from_numpy(x))
    np.testing.assert_allclose(f_port.numpy(), f_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        port.objective(torch.from_numpy(x[0])).item(),
        float(ref.objective(jnp.asarray(x[0]))), rtol=RTOL, atol=ATOL)

    assert (port.projection is None) == (ref.projection is None)
    if ref.projection is not None:
        # eigenvector signs and degenerate pairs differ between the two
        # eigh implementations; the projected (reconstructed) matrix and
        # the clamped offset are what must agree
        p_ref = np.asarray(ref.projection(jnp.asarray(x)))
        p_port = port.projection(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(p_port, p_ref, rtol=RTOL, atol=ATOL)
        A = p_port[:, :-1].reshape(ref.n, 4, 4)
        assert np.all(np.linalg.eigvalsh(A) > -1e-5)
        assert np.all(p_port[:, -1] >= 1.0)


def test_lm_problem_carries_the_references_fields():
    """The "lm" problem built from the registry carries the reference's
    fields."""
    params = {"arch": "llama3-8b", "batch_per_node": 2, "seq_len": 32}
    port = port_C.build_component(port_C.problems, "lm", params,
                                  device=torch.device("cpu"))
    ref = ref_C.build_component(ref_C.problems, "lm", params)
    assert type(port).__name__ == type(ref).__name__ == "LMProblem"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
