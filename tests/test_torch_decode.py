"""The port's one-token decode against the JAX package's, on the CPU: each
block's decode with its cache (`gqa_decode`, `mla_decode`, `_conv_step`,
`mamba1_decode`, `mamba2_decode`, `_cross_decode`, `_shared_attn_decode`)
from a non-zero cache at a position past 0, on the reference's parameters
perturbed by seeded noise (so that the zero-initialised cross-attention
gate and LoRA factors are not zero); the cache written in place; the
cache trees (`init_cache`, `cache_axes`) and their carry through
`convert` both ways; and `decode_step` of all ten smoke archs over
several steps against the reference's jitted one, logits and the whole
returned cache. The reference runs jitted, as its callers run it.

Standards (ROADMAP queue 3 gives the residues):
  * float32 (parameters and cache): every output and cache leaf within
    `F32_TOL` = 1e-5 of its largest magnitude (observed at most 6.7e-7 a
    block, 1.6e-6 in the whole models' logits; fp32 sums in another
    order).
  * a block in bf16, and bf16 weights over a float32 cache (the
    reference's decode gate, where mixed dtypes promote as jax promotes
    them): within `BF16_TOL` = 2e-2 of the largest magnitude, about five
    bf16 roundings (2^-8 each). Observed: 0 (bit for bit) for GQA, the
    cross-attention and the shared attention; 6.7e-3 (GQA with QKV
    biases), 6.6e-3 (Mamba-1), 5.1e-3 (Mamba-2), 6.4e-5 (MLA): XLA keeps
    some bf16 intermediates (the bias add, the gate) in float32.
  * `_conv_step`: the float32 sum over the taps rounded once, bit for bit
    the reference's in bf16; in float32 within 3e-7 (the four products
    summed in another order: 1 ulp at 20 of 192 elements). In bf16 it is
    not `_causal_conv`'s tap-by-tap rounding (pinned below: the
    reference's own decode and forward differ at 47 of 192 elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import registry as ref_registry
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.common import split_axes

from repro_torch.convert import lm_params_to_reference
from repro_torch.models import attention as port_attn
from repro_torch.models import registry as port_registry
from repro_torch.models import ssm as port_ssm
from repro_torch.models import transformer as port_tf

from _decode import one_torch_thread  # noqa: F401 (autouse)
from _decode import (B, CPU, MODES, assert_trees_close, carry,
                     configs, perturbed, random_cache, rel)

#: a block's tolerances by mode (module docstring)
F32_TOL = 1e-5
BF16_TOL = 2e-2
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL, "mixed": BF16_TOL}
MAX_SEQ, POS = 8, 5


# ---------------------------------------------------------------------------
# each block's decode
# ---------------------------------------------------------------------------

#: case -> (arch, block kind): GQA with and without QKV biases, MLA, both
#: mixers, cross-attention and zamba2's shared attention
BLOCKS = {"gqa": ("llama3-8b", "attn"),
          "gqa_bias": ("codeqwen1.5-7b", "attn"),
          "mla": ("deepseek-v2-236b", "mla"),
          "mamba1": ("falcon-mamba-7b", "mamba1"),
          "mamba2": ("zamba2-2.7b", "mamba2"),
          "cross": ("llama-3.2-vision-90b", "cross_attn"),
          "shared": ("zamba2-2.7b", "shared_attn")}


def _block_setup(case, mode, seed=3):
    arch, kind = BLOCKS[case]
    (jdt, tdt), cdt = MODES[mode]
    cfg_r, cfg_t = configs(arch, jdt, tdt)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    prm, _ = split_axes(ref_tf._block_init(kind, k1, cfg_r))
    shared = (split_axes(ref_attn.gqa_init(k2, cfg_r))[0]
              if kind == "shared_attn" else None)
    prm, shared = perturbed((prm, shared), seed)
    cache = random_cache(ref_tf._block_init_cache(
        kind, cfg_r, B, MAX_SEQ, cdt), seed + 1)
    x = np.random.default_rng(seed + 2).normal(
        size=(B, 1, cfg_r.d_model)).astype(np.float32)
    return kind, cfg_r, cfg_t, prm, shared, cache, x


def _ref_block(kind, prm, x, cache, cfg, pos, shared):
    if kind == "attn":
        return ref_attn.gqa_decode(prm["attn"], x, cache, cfg, pos)
    if kind == "mla":
        return ref_attn.mla_decode(prm["attn"], x, cache, cfg, pos)
    if kind == "mamba1":
        return ref_ssm.mamba1_decode(prm["mamba"], x, cache, cfg, pos)
    if kind == "mamba2":
        return ref_ssm.mamba2_decode(prm["mamba"], x, cache, cfg, pos)
    if kind == "cross_attn":
        return ref_tf._cross_decode(prm["attn"], x, cache, cfg)
    return ref_tf._shared_attn_decode(prm, shared, x, cache, cfg, pos)


def _port_block(kind, prm, x, cache, cfg, pos, shared):
    if kind == "attn":
        return port_attn.gqa_decode(prm["attn"], x, cache, cfg, pos)
    if kind == "mla":
        return port_attn.mla_decode(prm["attn"], x, cache, cfg, pos)
    if kind == "mamba1":
        return port_ssm.mamba1_decode(prm["mamba"], x, cache, cfg, pos)
    if kind == "mamba2":
        return port_ssm.mamba2_decode(prm["mamba"], x, cache, cfg, pos)
    if kind == "cross_attn":
        return port_tf._cross_decode(prm["attn"], x, cache, cfg)
    return port_tf._shared_attn_decode(prm, shared, x, cache, cfg, pos)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_decode_matches_reference(case, mode):
    kind, cfg_r, cfg_t, prm, shared, cache, x = _block_setup(case, mode)
    jdt = MODES[mode][0][0]
    out_r, cache_r = jax.jit(
        lambda p_, s_, x_, c_, pos: _ref_block(kind, p_, x_, c_, cfg_r, pos,
                                               s_))(
        prm, shared, jnp.asarray(x, jdt), cache, jnp.int32(POS))
    prm_t, shared_t, cache_t = carry((prm, shared, cache))
    before = {k: v.clone() for k, v in cache_t.items()}
    x_t = torch.from_numpy(x).to(MODES[mode][0][1])
    # an int position and a 0-d tensor position are the same call
    pos = POS if case != "gqa_bias" else torch.tensor(POS)
    with torch.no_grad():
        out_t, cache_out = _port_block(kind, prm_t, x_t, cache_t, cfg_t, pos,
                                       shared_t)
    assert out_t.dtype == {jnp.float32: torch.float32,
                           jnp.bfloat16: torch.bfloat16}[out_r.dtype.type]
    assert rel(out_r, out_t) <= TOL[mode], (rel(out_r, out_t))
    assert_trees_close(cache_r, cache_out, TOL[mode], "cache")
    # the cache is written in place: the same tensors come back
    assert all(cache_out[k] is cache_t[k] for k in cache_t)
    if kind in ("attn", "mla", "shared_attn"):
        for k, v in cache_t.items():
            changed = (v != before[k]).flatten(2).any(-1).any(0)
            assert changed.nonzero().flatten().tolist() == [POS], k
    if kind == "cross_attn":
        assert all(torch.equal(v, before[k]) for k, v in cache_t.items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_step_is_the_references_bit_for_bit(dtype):
    jdt, tdt = MODES[dtype][0]
    rng = np.random.default_rng(5)
    C, K = 96, 4
    x_t = rng.normal(size=(B, C)).astype(np.float32)
    state = rng.normal(size=(B, K - 1, C)).astype(np.float32)
    w = rng.normal(size=(C, K)).astype(np.float32) * 0.5
    b = rng.normal(size=(C,)).astype(np.float32)
    ref = jax.jit(ref_ssm._conv_step)(*(jnp.asarray(a, jdt)
                                        for a in (x_t, state, w, b)))
    port = port_ssm._conv_step(*(torch.from_numpy(a).to(tdt)
                                 for a in (x_t, state, w, b)))
    for a, t in zip(ref, port):
        a = np.asarray(a)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                          a.view(np.uint16))
        else:
            # four float32 products summed in XLA's order, not torch's:
            # 1 ulp apart at 20 of 192 elements
            np.testing.assert_allclose(t.numpy(), a, rtol=3e-7, atol=0)


def test_conv_step_is_not_the_forwards_tap_loop_in_bf16():
    """The reference's own decode and forward round the conv differently:
    in bf16 the einsum's one rounding against `_causal_conv`'s rounding
    after each tap. Both packages show it on the same inputs, at the same
    elements (47 of 192 here)."""
    rng = np.random.default_rng(6)
    C, K = 96, 4
    x = rng.normal(size=(B, K, C)).astype(np.float32)
    w = rng.normal(size=(C, K)).astype(np.float32) * 0.5
    b = rng.normal(size=(C,)).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    ref_step = np.asarray(ref_ssm._conv_step(jx[:, -1], jx[:, :-1], jw,
                                             jb)[0]).view(np.uint16)
    ref_loop = np.asarray(ref_ssm._causal_conv(jx, jw, jb)[:, -1]).view(
        np.uint16)
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    port_step = port_ssm._conv_step(tx[:, -1], tx[:, :-1], tw, tb)[0]
    port_loop = port_ssm._causal_conv(tx, tw, tb)[:, -1]
    ref_diff = ref_step != ref_loop
    port_diff = (port_step.view(torch.uint16)
                 != port_loop.view(torch.uint16)).numpy()
    np.testing.assert_array_equal(port_diff, ref_diff)
    assert int(ref_diff.sum()) == 47


# ---------------------------------------------------------------------------
# the cache trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_init_cache_and_cache_axes_are_the_references(arch):
    cfg_r, cfg_t = configs(arch, jnp.bfloat16, torch.bfloat16)
    ref = ref_tf.init_cache(cfg_r, B, MAX_SEQ)
    port = port_tf.init_cache(cfg_t, B, MAX_SEQ, device=CPU)
    ref_leaves, ref_def = jax.tree.flatten(ref)
    port_np = lm_params_to_reference(port)
    port_leaves, port_def = jax.tree.flatten(port_np)
    assert ref_def == port_def
    for a, b in zip(ref_leaves, port_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert not np.asarray(b, np.float32).any()
    # the stacked leaves are real tensors, one allocation each (written in
    # place), not expanded views
    for t in torch.utils._pytree.tree_leaves(port["stack"]):
        assert t.is_contiguous() and 0 not in t.stride()
    assert port_tf.cache_axes(cfg_t) == ref_tf.cache_axes(cfg_r)


def test_init_cache_runs_on_the_card_unless_asked(monkeypatch):
    cfg = port_registry.get_config("llama3-8b", "smoke")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tf.init_cache(cfg, B, MAX_SEQ)


@pytest.mark.parametrize("arch,dtypes", [
    ("deepseek-v2-236b", {"bfloat16"}),
    ("zamba2-2.7b", {"bfloat16", "float32"})])
def test_convert_carries_a_cache_both_ways(arch, dtypes):
    """A cache tree (dicts, the prologue's list, float32 `h` beside bf16
    `k`/`v`/`conv`) from the reference to the port and back, bits equal."""
    cfg_r, _ = configs(arch, jnp.bfloat16, torch.bfloat16)
    ref = random_cache(ref_tf.init_cache(cfg_r, B, MAX_SEQ), 9)
    port = carry(ref)
    if cfg_r.prologue:
        assert isinstance(port["prologue"], list)
    back = lm_params_to_reference(port)
    ref_leaves, ref_def = jax.tree.flatten(ref)
    back_leaves, back_def = jax.tree.flatten(back)
    assert ref_def == back_def
    seen = set()
    for a, b in zip(ref_leaves, back_leaves):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        seen.add(a.dtype.name)
    assert seen == dtypes
