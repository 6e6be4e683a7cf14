"""`repro_torch.compress` against `repro.compress`: jax's threefry bits, the
registry, the byte model, the numpy halves and the torch halves, all bit
for bit on the CPU.

Tolerance: none. Every comparison here is exact (float32 bit patterns),
because the compressors are discontinuous (a top-k support or an int8 code
that differs by one entry is a different message) and the port reproduces
the reference's arithmetic exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as rc
from repro.compress import base as rbase

from repro_torch import compress as pc
from repro_torch.compress import prng

SEEDS = [0, 1, 2 ** 31 - 1]
TS = [0.0, 1.0, 299.0]
#: odd and even element counts (threefry pairs its counters)
SHAPES = [(7,), (3, 5), (16, 64), (2, 3, 4), (256, 33)]

KINDS = [
    ("none", {}),
    ("topk", {"keep": 0.25}),
    ("topk", {"keep": 0.1, "error_feedback": False}),
    ("randk", {"keep": 0.25, "seed": 3}),
    ("randk", {"keep": 0.5}),
    ("int8", {}),
    ("int8", {"stochastic": True, "seed": 7}),
]
KIND_IDS = [f"{k}-{'-'.join(f'{a}={b}' for a, b in p.items())}"
            for k, p in KINDS]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(
        np.int32)


def _rows(seed: int) -> list[np.ndarray]:
    """(n, d) float32 inputs, the last with built-in magnitude ties: equal
    values, opposite signs, zero rows and a row of one repeated value."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=s).astype(np.float32)
           for s in ((16, 64), (5, 7), (8, 40), (3, 1))]
    ties = np.round(rng.normal(size=(6, 32)) * 2).astype(np.float32)
    ties[0] = 0.0
    ties[1] = -1.5
    ties[2, ::2] = -ties[2, 1::2]
    out.append(ties)
    return out


def test_jax_threefry_is_partitionable():
    """The port reproduces the partitionable threefry path; a jax that
    changes the default shows up here, by name."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_fold_in_bits_uniform_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.key(seed)
    assert [int(w) for w in ours] == [int(w) for w in np.asarray(key)]
    for t in TS:
        folded = jax.random.fold_in(key, jnp.float32(t).astype(jnp.int32))
        ours_f = prng.fold_in(ours, torch.tensor(t, dtype=torch.float32))
        assert [int(w) for w in ours_f] == [int(w) for w in
                                            np.asarray(folded)]
        for shape in SHAPES:
            bits = np.asarray(jax.random.bits(folded, shape))
            np.testing.assert_array_equal(
                prng.random_bits(ours_f, shape).numpy(),
                bits.astype(np.int64))
            uni = prng.uniform(ours_f, shape)
            assert uni.dtype == torch.float32 and tuple(uni.shape) == shape
            np.testing.assert_array_equal(
                _bits(uni.numpy()),
                _bits(jax.random.uniform(folded, shape)))


def test_key_refuses_seeds_outside_int32():
    assert [int(w) for w in prng.key(-1)] == [
        int(w) for w in np.asarray(jax.random.PRNGKey(-1))]
    with pytest.raises(ValueError, match="int32"):
        prng.key(2 ** 31)


def test_registry_and_errors_match_reference():
    assert sorted(pc.COMPRESSORS) == sorted(rc.COMPRESSORS)
    assert pc.compressors.names() == rc.compressors.names()
    for kind, params in KINDS:
        ours, theirs = (pc.build_compressor(kind, params),
                        rc.build_compressor(kind, params))
        assert ours.params_dict() == theirs.params_dict()
        assert pc.build_compressor(kind, ours.params_dict()) == ours
        assert pc.compressors.build(kind, **params) == ours
        assert (ours.kind, ours.is_sparsifier, ours.error_feedback) == (
            theirs.kind, theirs.is_sparsifier, theirs.error_feedback)
        assert ([f.name for f in dataclasses.fields(ours)]
                == [f.name for f in dataclasses.fields(theirs)])
    for kind, params in (("zstd", {}), ("topk", {"k": 3}),
                         ("topk", {"keep": 1.5})):
        with pytest.raises(ValueError) as e_ours:
            pc.build_compressor(kind, params)
        with pytest.raises(ValueError) as e_ref:
            rc.build_compressor(kind, params)
        assert str(e_ours.value) == str(e_ref.value)


def test_experiments_exports_the_registry():
    from repro_torch import experiments
    from repro_torch.faults import plan

    assert experiments.compressors is pc.compressors
    assert experiments.Compressor is pc.Compressor
    # the fault plans resolve lazily too, as in the reference
    assert experiments.faultplans is plan.faultplans
    assert experiments.FaultPlan is plan.FaultPlan
    with pytest.raises(AttributeError):
        experiments.NoSuchName


@pytest.mark.parametrize("kind,params", KINDS, ids=KIND_IDS)
def test_wire_ratio_and_keep_count_are_exact(kind, params):
    ours, theirs = (pc.build_compressor(kind, params),
                    rc.build_compressor(kind, params))
    for d in (1, 7, 16, 64, 100, 4096):
        assert ours.wire_ratio(d) == theirs.wire_ratio(d)
    for d, keep in ((64, 0.125), (7, 0.1), (4096, 0.25), (3, 1.0)):
        assert pc.keep_count(d, keep) == rc.keep_count(d, keep)
    assert (pc.VALUE_BYTES, pc.INDEX_BYTES) == (rc.VALUE_BYTES,
                                                rc.INDEX_BYTES)


@pytest.mark.parametrize("kind,params", KINDS, ids=KIND_IDS)
def test_numpy_halves_are_the_reference(kind, params):
    ours, theirs = (pc.build_compressor(kind, params),
                    rc.build_compressor(kind, params))
    for row_set in _rows(11):
        for node, row in enumerate(row_set):
            for stamp in (0, 5):
                np.testing.assert_array_equal(
                    ours.compress_np(row, node, stamp),
                    theirs.compress_np(row, node, stamp))
        np.testing.assert_array_equal(pc.topk_mask_np(row_set[0], 3),
                                      rc.topk_mask_np(row_set[0], 3))


@pytest.mark.parametrize("kind,params", KINDS, ids=KIND_IDS)
def test_torch_half_matches_jax_bit_for_bit(kind, params):
    """compress_torch against compress_jax run under jit, as the reference
    runs it inside DDASimulator's scan. Outside jit the reference's int8
    scale divides by 127 where jit multiplies by float32(1/127), one ulp
    apart on some rows; every other kind agrees with both."""
    ours, theirs = (pc.build_compressor(kind, params),
                    rc.build_compressor(kind, params))
    jitted = jax.jit(theirs.compress_jax)
    for x in _rows(5):
        for t in TS:
            got = ours.compress_torch(torch.from_numpy(x),
                                      torch.tensor(t, dtype=torch.float32))
            assert got.dtype == torch.float32 and got.shape == x.shape
            want = jitted(jnp.asarray(x), jnp.float32(t))
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
            if kind != "int8":
                np.testing.assert_array_equal(
                    _bits(got.numpy()),
                    _bits(theirs.compress_jax(jnp.asarray(x),
                                              jnp.float32(t))))
            if kind == "int8":
                q, scale = ours.codes_torch(torch.from_numpy(x),
                                            torch.tensor(t))
                assert torch.equal(q, torch.round(q))
                assert float(q.abs().max()) <= ours.LEVELS
                assert torch.equal(q * scale, got)
            if ours.is_sparsifier:
                np.testing.assert_array_equal(
                    ours.support_mask_torch(torch.from_numpy(x),
                                            torch.tensor(t)).numpy(),
                    np.asarray(theirs.support_mask_jax(jnp.asarray(x),
                                                       jnp.float32(t))))


def test_topk_breaks_ties_toward_the_lower_index():
    for x in _rows(3):
        for k in (1, 3, x.shape[-1]):
            if k > x.shape[-1]:
                continue
            mask = pc.topk_mask_torch(torch.from_numpy(x), k).numpy()
            np.testing.assert_array_equal(
                mask, np.asarray(rbase.topk_mask_jax(jnp.asarray(x), k)))
            assert (mask.sum(axis=-1) == k).all()
        flat = x.reshape(-1)
        for k in (1, min(5, flat.size)):
            np.testing.assert_array_equal(
                pc.topk_indices_flat(torch.from_numpy(flat), k).numpy(),
                np.asarray(rc.topk_indices_flat(jnp.asarray(flat), k)))
    # a row of one repeated magnitude keeps its first k entries
    row = torch.full((1, 9), -2.0)
    assert pc.topk_mask_torch(row, 4).tolist() == [[1.0] * 4 + [0.0] * 5]


def test_randk_scores_tie_and_the_tie_order_is_kept():
    """4096 float32 uniforms in a row collide (they take 2**23 values); the
    support must still be the reference's, tie order included."""
    comp = pc.RandK(keep=0.25, seed=0)
    x = torch.ones((8, 4096))
    for t in (3.0, 299.0):
        k = prng.fold_in(prng.key(0), torch.tensor(t))
        scores = prng.uniform(k, (8, 4096)).numpy()
        assert any(len(np.unique(r)) < r.size for r in scores)
        np.testing.assert_array_equal(
            comp.support_mask_torch(x, torch.tensor(t)).numpy(),
            np.asarray(rc.RandK(keep=0.25, seed=0).support_mask_jax(
                jnp.ones((8, 4096)), jnp.float32(t))))
