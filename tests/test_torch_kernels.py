"""Kernels K1 (the weighted gossip mix) and K2 (the compress-mix): their
plain PyTorch versions against the reference's jnp oracles and its
interpreted Pallas kernels, the CPU dispatch and the wrappers' refusals. The
CUDA kernels themselves are tested on the card by
tests/test_torch_kernels_card.py.

Tolerances: against the jnp oracle rtol 1e-6, atol 1e-6 (same float order;
the oracle runs under XLA, which may contract a multiply-add into an FMA);
against the Pallas kernel rtol 1e-5, atol 1e-5 (it takes weight vectors and
accumulates slot by slot)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core.graphs import kregular_expander
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.compress_mix import compress_mix_weighted as pallas_k2

from repro_torch.kernels import build, compress_mix, gossip_mix, ops, ref


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


def test_reference_contracts_the_uniform_mix_into_an_fma():
    """A known difference (ROADMAP queue 3): under jit, XLA's CPU backend
    contracts the reference's `w_self * z + w_edge * acc` into
    `fma(w_self, z, w_edge * acc)`, while the port's plain version rounds
    each product. The float64 sum of an exact float32 product and a
    float32 value, rounded once to float32, stands in for the FMA."""
    rng = np.random.default_rng(0)
    z = (rng.normal(size=(16, 64)) * 50).astype(np.float32)
    S_in = rng.integers(0, 16, size=(16, 4))
    sw = ew = np.float32(0.2)
    acc = z[S_in[:, 0]] + z[S_in[:, 1]] + z[S_in[:, 2]] + z[S_in[:, 3]]
    fused = (np.float64(sw) * z + (ew * acc).astype(np.float64)).astype(
        np.float32)
    rounded = sw * z + ew * acc
    assert (fused != rounded).any()
    theirs = np.asarray(jax.jit(jref.gossip_gather_mix_ref)(
        jnp.asarray(z), jnp.asarray(S_in), sw, ew))
    np.testing.assert_array_equal(theirs, fused)
    ours = ref.gossip_gather_mix_ref(_t(z), _t(S_in), float(sw),
                                     float(ew)).numpy()
    np.testing.assert_array_equal(ours, rounded)


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
    assert build.SOURCES == ("gossip_mix", "compress_mix", "flash_attention",
                             "flash_attention_sm90", "ssd_scan",
                             "selective_scan")
    paths = set()
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert path == build.library_path(name)
        assert (build.CSRC / f"{name}.cu").exists()
        paths.add(path)
    assert len(paths) == len(build.SOURCES)


@pytest.mark.parametrize("edit", ["header", "nested header", "source"])
def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch,
                                                  edit):
    """An edited header under csrc/, included directly or through another
    header, names a new library, as an edited source does; a header that
    is not included does not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    '#define A B\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    (tmp_path / "other.cuh").write_text("#define C 1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    (tmp_path / "other.cuh").write_text("#define C 2\n")
    assert build.library_path("k") == before
    target = {"header": "a.cuh", "nested header": "b.cuh",
              "source": "k.cu"}[edit]
    (tmp_path / target).write_text((tmp_path / target).read_text() + "\n")
    after = build.library_path("k")
    assert after != before and after.parent == build.BUILD_DIR
    assert after.name.startswith("k-") and after.suffix == ".so"


# ---------------------------------------------------------------------------
# K2, the compress-mix
# ---------------------------------------------------------------------------


def _compress_inputs(n, m, k, seed, density=0.5):
    z, S_in, ws, we = _inputs(n, m, k, seed)
    rng = np.random.default_rng(seed + 1)
    msg = rng.normal(size=(n, m)).astype(np.float32)
    mask = (rng.random(size=(n, m)) < density).astype(np.float32)
    return z, msg, mask, S_in, ws, we


@given(n8=st.integers(1, 4), m=st.integers(1, 2100), k=st.integers(1, 5),
       density=st.sampled_from([0.0, 0.125, 0.5, 1.0]))
@settings(max_examples=8)
def test_compress_plain_matches_jax_ref_and_pallas_kernel(n8, m, k, density):
    """The port's plain version against the reference's oracle and its
    Pallas kernel in interpret mode, as tests/test_compress.py runs it."""
    n = 8 * n8
    z, msg, mask, S_in, ws, we = _compress_inputs(n, m, k, m * 7 + k,
                                                  density)
    ours = ref.compress_mix_ref(_t(z), _t(msg), _t(mask), _t(S_in), _t(ws),
                                _t(we)).numpy()
    jargs = [jnp.asarray(a) for a in (z, msg, mask, S_in, ws, we)]
    oracle = np.asarray(jref.compress_mix_ref(*jargs))
    pallas = np.asarray(ref_ops.compress_mix_impl(*jargs, interpret=True,
                                                  use_kernel=True))
    np.testing.assert_allclose(ours, oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)


def test_compress_uniform_weights_match_jax_and_matmul():
    """Scalar weights on a k-regular expander: the reference's float order
    (sent formed in float32, the gathers summed, one multiply), and the
    dense oracle diag(P) z + P_off (msg * mask)."""
    g = kregular_expander(12, k=4, seed=0)
    S_in = np.stack([np.asarray(p) for p in g.perms], axis=1)
    z, msg, mask, _, _, _ = _compress_inputs(12, 257, 4, seed=3)
    sw, ew = float(np.float32(g.self_weight)), float(np.float32(g.edge_weight))
    ours = ref.compress_mix_ref(_t(z), _t(msg), _t(mask), _t(S_in), sw,
                                ew).numpy()
    oracle = np.asarray(jref.compress_mix_ref(
        jnp.asarray(z), jnp.asarray(msg), jnp.asarray(mask),
        jnp.asarray(S_in), jnp.float32(sw), jnp.float32(ew)))
    np.testing.assert_allclose(ours, oracle, rtol=1e-6, atol=1e-6)
    P = g.mixing_matrix().astype(np.float32)
    expect = np.diag(P)[:, None] * z + (P - np.diag(np.diag(P))) @ (msg * mask)
    np.testing.assert_allclose(ours, expect, rtol=1e-5, atol=1e-5)


def test_compress_pregathered_plain_version_matches_pallas():
    """The (k, n, M) form the TPU kernel takes, against that kernel run in
    interpret mode on its own (8, 1024)-tiled shapes."""
    z, msg, mask, S_in, ws, we = _compress_inputs(16, 2048, 3, seed=9)
    nbr = np.moveaxis(msg[S_in], 1, 0)
    nmask = np.moveaxis(mask[S_in], 1, 0)
    ours = ref.compress_mix_weighted_ref(_t(z), _t(nbr), _t(nmask), _t(ws),
                                         _t(we)).numpy()
    pallas = np.asarray(pallas_k2(jnp.asarray(z), jnp.asarray(nbr),
                                  jnp.asarray(nmask), jnp.asarray(ws),
                                  jnp.asarray(we), interpret=True))
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)
    gathered = ref.compress_mix_ref(_t(z), _t(msg), _t(mask), _t(S_in),
                                    _t(ws), _t(we)).numpy()
    np.testing.assert_allclose(ours, gathered, rtol=1e-5, atol=1e-6)


def test_all_ones_mask_is_the_gossip_mix():
    """msg * 1 is exact: with an all-ones mask K2's function is K1's with
    msg, bit for bit, on either weight path."""
    z, msg, _, S_in, ws, we = _compress_inputs(10, 65, 3, seed=4)
    ones = np.ones_like(msg)
    for sw, ew in ((0.4, 0.2), (_t(ws), _t(we))):
        np.testing.assert_array_equal(
            ref.compress_mix_ref(_t(z), _t(msg), _t(ones), _t(S_in), sw,
                                 ew).numpy(),
            ref.gossip_gather_mix_ref(_t(z), _t(S_in), sw, ew,
                                      msg=_t(msg)).numpy())


def test_compress_cpu_dispatch_is_the_plain_version():
    z, msg, mask, S_in, ws, we = _compress_inputs(10, 33, 3, seed=2)
    shape = (10, 3, 11)
    z3, m3, k3 = (_t(a).reshape(shape) for a in (z, msg, mask))
    for sw, ew in ((_t(ws), _t(we)), (0.4, 0.2),
                   (torch.tensor(0.4), torch.tensor(0.2))):
        out = ops.compress_mix_impl(z3, m3, k3, _t(S_in), sw, ew)
        assert out.shape == shape
        np.testing.assert_array_equal(
            out.numpy(),
            ref.compress_mix_ref(z3, m3, k3, _t(S_in), sw, ew).numpy())


def test_compress_wrapper_refuses_cpu_tensors():
    z, msg, mask, S_in, ws, we = _compress_inputs(8, 16, 2, seed=0)
    count = compress_mix.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        compress_mix.compress_mix_weighted(_t(z), _t(msg), _t(mask),
                                           _t(S_in), _t(ws), _t(we))
    assert compress_mix.LAUNCHES == count
