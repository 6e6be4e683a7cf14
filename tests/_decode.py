"""Helpers shared by the tests of the port's LM inference
(`tests/test_torch_decode*.py`, `tests/test_torch_cross_attn.py`): both
packages' configs at a dtype, seeded parameter noise and caches, trees
carried to the port, relative errors, and the reference's
`_prefill_cross_cache` on either side."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as ref_registry

from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.compress import prng
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread while a module of these tests runs
    (restored after): the decode loops launch thousands of tiny ops, which
    spin on contended cores when several test workers share the machine,
    each with a pool of its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
#: (parameters, cache) dtypes: float32, bf16, and bf16 weights over a
#: float32 cache (the reference's `test_decode_matches_forward`)
MODES = {"float32": ((jnp.float32, torch.float32), jnp.float32),
         "bfloat16": ((jnp.bfloat16, torch.bfloat16), jnp.bfloat16),
         "mixed": ((jnp.bfloat16, torch.bfloat16), jnp.float32)}
#: the decode batch
B = 2


def rel(a, b) -> float:
    """The largest |b - a| over the largest |a| (a the reference's)."""
    a = np.asarray(np.asarray(a), dtype=np.float32)
    b = (b.detach().float().numpy() if torch.is_tensor(b)
         else np.asarray(b, dtype=np.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))


def configs(arch, jdt, tdt, **changes):
    """The smoke config of `arch` in both packages at the given dtypes."""
    return (dataclasses.replace(ref_registry.get_config(arch, "smoke"),
                                dtype=jdt, **changes),
            dataclasses.replace(port_registry.get_config(arch, "smoke"),
                                dtype=tdt, **changes))


def perturbed(tree, seed: int):
    """`tree` plus seeded noise of a fifth of each leaf's spread (0.2 where
    a leaf is constant: zero gates and LoRA factors), in its dtype."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        f = a.astype(np.float32)
        spread = float(f.std()) or 1.0
        noise = rng.normal(size=a.shape).astype(np.float32) * 0.2 * spread
        return jnp.asarray(f + noise, a.dtype)
    return jax.tree.map(one, tree)


def random_cache(cache, seed: int):
    """The cache's leaves filled with seeded normals in their dtypes: a
    state left by earlier tokens (and garbage past `pos`, which the mask
    must hide)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32), a.dtype), cache)


def carry(tree):
    """A reference tree as the port's tensors on the CPU."""
    return lm_params_from_reference(jax.tree.map(np.asarray, tree),
                                    device=CPU)


def assert_trees_close(ref, port, tol: float, what: str) -> float:
    """Every leaf of the reference's tree against the port's: the same
    structure, shapes and dtypes, each within `tol` of its largest
    magnitude. Returns the largest relative error."""
    ref_leaves, ref_def = jax.tree.flatten(ref)
    port_leaves, port_def = jax.tree.flatten(lm_params_to_reference(port))
    assert ref_def == port_def, (what, ref_def, port_def)
    worst = 0.0
    for a, b in zip(ref_leaves, port_leaves):
        assert np.asarray(a).dtype == b.dtype, (what, a.dtype, b.dtype)
        worst = max(worst, rel(a, b))
    assert worst <= tol, (what, worst)
    return worst


def model(arch, mode, seed=0, **changes):
    """Both configs, the init from `seed` (the port's, which draws the
    reference's bits) perturbed by seeded noise (non-zero cross-attention
    gates and LoRA factors), as the reference's tree and the port's."""
    (jdt, tdt), _ = MODES[mode]
    cfg_r, cfg_t = configs(arch, jdt, tdt, **changes)
    params = perturbed(jax.tree.map(jnp.asarray, lm_params_to_reference(
        port_tf.init(prng.key(seed, CPU), cfg_t)[0])), seed)
    return cfg_r, cfg_t, params, carry(params)


def fill_cross_reference(cache, params, cfg, enc):
    """The reference's `_prefill_cross_cache` (tests/test_models.py): each
    cross-attention slot's encoder K and V, in the cache's dtype."""
    stack = dict(cache["stack"])
    for i, kind in enumerate(cfg.superblock):
        if kind == "cross_attn":
            prm = params["stack"][f"slot{i}"]["attn"]
            c = stack[f"slot{i}"]
            stack[f"slot{i}"] = {
                "ek": jnp.einsum("lehk,bne->lbnhk", prm["wk"],
                                 enc).astype(c["ek"].dtype),
                "ev": jnp.einsum("lehk,bne->lbnhk", prm["wv"],
                                 enc).astype(c["ev"].dtype)}
    return {**cache, "stack": stack}


def fill_cross_port(cache, params, cfg, enc):
    """The same on the port's cache, in place: each repetition's encoder K
    and V (`torch.einsum` of the bf16 or float32 encoder states), written
    into the stacked slot."""
    for i, kind in enumerate(cfg.superblock):
        if kind == "cross_attn":
            prm = params["stack"][f"slot{i}"]["attn"]
            c = cache["stack"][f"slot{i}"]
            for j in range(cfg.n_super):
                c["ek"][j].copy_(torch.einsum("bne,ehk->bnhk", enc,
                                              prm["wk"][j]))
                c["ev"][j].copy_(torch.einsum("bne,ehk->bnhk", enc,
                                              prm["wv"][j]))
    return cache
