"""The port's optimizers and LR schedules against `repro.optim`, on the CPU:
sgd (with momentum and weight decay), adamw (fp32 and bf16 moments) and
dual_averaging a few steps each on a small tree of fp32 and bf16 leaves
from the same seeded numpy gradients, and the four LR schedules over the
first steps. The in-place update (`Optimizer.update_`, the launcher's) is
the functional one bit for bit.

Standards: the schedules within one float32 ulp (rtol 2e-7); the
optimizer states within rtol 1e-6, atol 1e-7 after 4 steps (XLA fuses
the multiply-adds, torch rounds each product: float32 ulps), bf16
parameters within one bf16 ulp (rtol 8e-3) where such a difference
crosses a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim

from repro_torch import optim as port_optim
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)

CPU = torch.device("cpu")
STEPS = 4


def _params(rng):
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32),
                  "d": rng.normal(size=(4, 2)).astype(np.float32)}}


def _to_jax(tree, bf16_keys=("d",)):
    def conv(path, a):
        key = path[-1].key
        return jnp.asarray(a, jnp.bfloat16 if key in bf16_keys else
                           jnp.float32)
    return jax.tree_util.tree_map_with_path(conv, tree)


def _sorted_port(tree):
    return lm_params_from_reference(jax.tree.map(np.asarray, tree),
                                    device=CPU)


def _run_both(make_ref, make_port):
    rng = np.random.default_rng(0)
    p_ref = _to_jax(_params(rng))
    grads = [_to_jax(_params(rng)) for _ in range(STEPS)]
    opt_ref, opt_port = make_ref(), make_port()
    s_ref = opt_ref.init(p_ref)
    p_port = _sorted_port(p_ref)
    s_port = opt_port.init(p_port)
    # the in-place path on copies of the same start
    p_in = jax.tree.map(torch.clone, p_port)
    s_in = jax.tree.map(torch.clone, s_port)
    for g in grads:
        p_ref, s_ref = opt_ref.update(g, s_ref, p_ref)
        g_port = _sorted_port(g)
        p_port, s_port = opt_port.update(g_port, s_port, p_port)
        opt_port.update_(g_port, s_in, p_in)
    for a, b in zip(jax.tree.leaves((p_port, s_port)),
                    jax.tree.leaves((p_in, s_in))):
        assert torch.equal(a, b)
    return (p_ref, s_ref), (p_port, s_port)


def _assert_close(ref_tree, port_tree):
    ours = lm_params_to_reference(port_tree, ref_optim.OptState)
    ref_leaves = jax.tree.leaves(ref_tree)
    our_leaves = jax.tree.leaves(ours)
    assert len(ref_leaves) == len(our_leaves)
    for r, o in zip(ref_leaves, our_leaves):
        r = np.asarray(r)
        assert r.dtype == o.dtype and r.shape == o.shape
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(o, r)
        elif r.dtype.name == "bfloat16":
            np.testing.assert_allclose(o.astype(np.float32),
                                       r.astype(np.float32), rtol=8e-3,
                                       atol=1e-7)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-7)


OPTIMIZERS = {
    "sgd": (lambda: ref_optim.sgd(ref_optim.constant_lr(0.1)),
            lambda: port_optim.sgd(port_optim.constant_lr(0.1))),
    "sgd_momentum_wd": (
        lambda: ref_optim.sgd(ref_optim.rsqrt_lr(0.3), momentum=0.9,
                              weight_decay=0.01),
        lambda: port_optim.sgd(port_optim.rsqrt_lr(0.3), momentum=0.9,
                               weight_decay=0.01)),
    "adamw": (lambda: ref_optim.adamw(ref_optim.cosine_lr(3e-3, 10)),
              lambda: port_optim.adamw(port_optim.cosine_lr(3e-3, 10))),
    "adamw_bf16_moments": (
        lambda: ref_optim.adamw(ref_optim.warmup_cosine(1e-2, 2, 10),
                                moment_dtype=jnp.bfloat16),
        lambda: port_optim.adamw(port_optim.warmup_cosine(1e-2, 2, 10),
                                 moment_dtype=torch.bfloat16)),
    "dual_averaging": (
        lambda: ref_optim.dual_averaging(ref_optim.rsqrt_lr(0.5, q=0.7)),
        lambda: port_optim.dual_averaging(port_optim.rsqrt_lr(0.5, q=0.7))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    make_ref, make_port = OPTIMIZERS[name]
    ref, port = _run_both(make_ref, make_port)
    _assert_close(ref, port)
    assert int(port[1].step) == STEPS


SCHEDULES = {
    "constant": (lambda m: m.constant_lr(0.1)),
    "rsqrt": (lambda m: m.rsqrt_lr(0.7, q=0.6)),
    "cosine": (lambda m: m.cosine_lr(3e-4, 7, floor=1e-5)),
    "warmup_cosine": (lambda m: m.warmup_cosine(1e-3, 3, 9, floor=2e-5)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_reference(name):
    ref_fn, port_fn = SCHEDULES[name](ref_optim), SCHEDULES[name](port_optim)
    for t in range(0, 12):
        ref = np.float32(ref_fn(jnp.asarray(t, jnp.int32)))
        ours = port_fn(torch.tensor(t, dtype=torch.int32))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), ref, rtol=2e-7, atol=0)
