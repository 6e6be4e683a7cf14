"""Kernel K1 (the weighted gossip mix): its plain PyTorch version against the
reference's jnp oracle and its interpreted Pallas kernel, the CPU dispatch
and the wrapper's refusals. The CUDA kernel itself is tested on the card by
tests/test_torch_kernels_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core.graphs import kregular_expander
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref

from repro_torch.kernels import build, gossip_mix, ops, ref


def _inputs(n, m, k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, m)).astype(dtype)
    S_in = rng.integers(0, n, size=(n, k)).astype(np.int64)
    ws = rng.uniform(0.05, 0.9, size=(n,)).astype(np.float32)
    we = rng.uniform(0.0, 0.3, size=(n, k)).astype(np.float32)
    return z, S_in, ws, we


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@given(n8=st.integers(1, 5), m=st.integers(1, 3000), k=st.integers(1, 5))
@settings(max_examples=10)
def test_plain_matches_jax_ref_and_pallas_kernel(n8, m, k):
    """The shapes of tests/test_kernels.py: the port's plain version against
    the reference's oracle and its Pallas kernel run in interpret mode."""
    n = 8 * n8
    z, S_in, ws, we = _inputs(n, m, k, seed=m * 31 + k)
    ours = ref.gossip_gather_mix_ref(_t(z), _t(S_in), _t(ws), _t(we)).numpy()
    oracle = np.asarray(jref.gossip_gather_mix_ref(
        jnp.asarray(z), jnp.asarray(S_in), jnp.asarray(ws), jnp.asarray(we)))
    pallas = np.asarray(ref_ops.gossip_gather_mix(
        jnp.asarray(z), jnp.asarray(S_in), jnp.asarray(ws), jnp.asarray(we),
        interpret=True, use_kernel=True))
    np.testing.assert_allclose(ours, oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_msg", [False, True])
def test_uniform_weights_match_matmul(with_msg):
    """Uniform lazy weights on a k-regular expander == P @ z, with the
    reference's scalar-weight float order (sum of gathers, one multiply)."""
    g = kregular_expander(12, k=4, seed=0)
    S_in = np.stack([np.asarray(p) for p in g.perms], axis=1)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(12, 257)).astype(np.float32)
    msg = rng.normal(size=(12, 257)).astype(np.float32) if with_msg else None
    sw, ew = float(np.float32(g.self_weight)), float(np.float32(g.edge_weight))
    ours = ref.gossip_gather_mix_ref(
        _t(z), _t(S_in), sw, ew,
        msg=None if msg is None else _t(msg)).numpy()
    oracle = np.asarray(jref.gossip_gather_mix_ref(
        jnp.asarray(z), jnp.asarray(S_in), jnp.float32(sw), jnp.float32(ew),
        msg=None if msg is None else jnp.asarray(msg)))
    np.testing.assert_allclose(ours, oracle, rtol=1e-6, atol=1e-6)
    if msg is None:
        expect = g.mixing_matrix().astype(np.float32) @ z
        np.testing.assert_allclose(ours, expect, atol=1e-5, rtol=1e-5)
        pallas = np.asarray(ref_ops.gossip_gather_mix(
            jnp.asarray(z), jnp.asarray(S_in), jnp.float32(sw),
            jnp.float32(ew), interpret=True, use_kernel=True))
        np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)


def test_reweighted_matches_matmul():
    """An edge-supported reweighted W folded into per-slot vectors (slot
    weight W[i, src] / multiplicity) == W @ z."""
    g = kregular_expander(12, k=4, seed=0)
    n = g.n
    rng = np.random.default_rng(3)
    S_in = np.stack([np.asarray(p) for p in g.perms], axis=1)
    W = np.diag(rng.uniform(0.2, 0.6, n))
    for i in range(n):
        for src in set(S_in[i]):
            W[i, src] = rng.uniform(0.05, 0.2)
    mult = np.zeros_like(S_in)
    for j in range(S_in.shape[1]):
        mult[:, j] = (S_in == S_in[:, j][:, None]).sum(axis=1)
    we = (W[np.arange(n)[:, None], S_in] / mult).astype(np.float32)
    ws = np.diag(W).astype(np.float32)
    z = rng.normal(size=(n, 130)).astype(np.float32)
    ours = ref.gossip_gather_mix_ref(_t(z), _t(S_in), _t(ws), _t(we)).numpy()
    np.testing.assert_allclose(ours, W.astype(np.float32) @ z, atol=1e-5,
                               rtol=1e-5)
    oracle = np.asarray(jref.gossip_gather_mix_ref(
        jnp.asarray(z), jnp.asarray(S_in), jnp.asarray(ws), jnp.asarray(we)))
    np.testing.assert_allclose(ours, oracle, rtol=1e-6, atol=1e-6)


def test_pregathered_plain_version_matches_jax():
    z, S_in, ws, we = _inputs(16, 300, 3, seed=5)
    nbr = np.moveaxis(z[S_in], 1, 0)  # (k, n, M), the TPU kernel's input
    ours = ref.gossip_mix_weighted_ref(_t(z), _t(nbr), _t(ws), _t(we))
    oracle = jref.gossip_mix_weighted_ref(jnp.asarray(z), jnp.asarray(nbr),
                                          jnp.asarray(ws), jnp.asarray(we))
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-6)
    gathered = ref.gossip_gather_mix_ref(_t(z), _t(S_in), _t(ws), _t(we))
    np.testing.assert_allclose(ours.numpy(), gathered.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_plain_version_bf16_matches_jax():
    z, S_in, ws, we = _inputs(8, 200, 4, seed=7)
    zb = torch.from_numpy(z).to(torch.bfloat16)
    ours = ref.gossip_gather_mix_ref(zb, _t(S_in), _t(ws), _t(we))
    assert ours.dtype == torch.bfloat16
    oracle = jref.gossip_gather_mix_ref(
        jnp.asarray(zb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(S_in), jnp.asarray(ws), jnp.asarray(we))
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(oracle.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_cpu_dispatch_is_the_plain_version():
    """A CPU tensor goes to the plain version, bit for bit, with scalar
    weights given as floats or as 0-d tensors."""
    z, S_in, ws, we = _inputs(10, 33, 3, seed=2)
    z3 = _t(z).reshape(10, 3, 11)
    np.testing.assert_array_equal(
        ops.gossip_gather_mix_impl(z3, _t(S_in), _t(ws), _t(we)).numpy(),
        ref.gossip_gather_mix_ref(z3, _t(S_in), _t(ws), _t(we)).numpy())
    for sw, ew in ((0.4, 0.2), (torch.tensor(0.4), torch.tensor(0.2))):
        np.testing.assert_array_equal(
            ops.gossip_gather_mix_impl(z3, _t(S_in), sw, ew).numpy(),
            ref.gossip_gather_mix_ref(z3, _t(S_in), sw, ew).numpy())


def test_wrapper_refuses_cpu_tensors():
    """No fallback inside the kernel wrapper: it takes CUDA tensors only."""
    z, S_in, ws, we = _inputs(8, 16, 2, seed=0)
    count = gossip_mix.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        gossip_mix.gossip_mix_weighted(_t(z), _t(S_in), _t(ws), _t(we))
    assert gossip_mix.LAUNCHES == count


def test_scalar_weights_become_vectors():
    w = ops._weight_vector(0.25, (3, 2), torch.device("cpu"))
    assert w.shape == (3, 2) and w.dtype == torch.float32
    assert torch.all(w == 0.25) and w.is_contiguous()
    w = ops._weight_vector(torch.tensor(0.5, dtype=torch.float64), (4,),
                           torch.device("cpu"))
    assert w.shape == (4,) and w.dtype == torch.float32 and w.is_contiguous()
    v = torch.ones(4)
    assert ops._weight_vector(v, (4,), torch.device("cpu")) is v


def test_library_is_keyed_by_source_hash():
    path = build.library_path("gossip_mix")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("gossip_mix-") and path.suffix == ".so"
    assert path == build.library_path("gossip_mix")
    assert (build.CSRC / "gossip_mix.cu").exists()
    assert build.SOURCES == ("gossip_mix",)
