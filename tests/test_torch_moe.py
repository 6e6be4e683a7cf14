"""The port's Mixture-of-Experts FFN and its two model families against the
JAX package's, on the CPU: the sort-based slotting (`_dispatch_indices`),
the router's top-K, `moe_apply` forward and gradient (top-2 deepseek-v2
and top-1 llama4-maverick smoke widths, float32 and bf16, with and without
capacity drops, one and two dispatch groups), `moe_aux_loss`, and the two
whole models' init, forward, loss and gradient on the reference's
parameters.

Standards (ROADMAP queue 3 gives the observed errors):
  * `_dispatch_indices` and the router's choices on exact ties: bits equal.
  * `moe_apply` in float32: output and every gradient within 1e-5 of its
    largest magnitude; in bf16 within 3e-2 (one bf16 rounding at the
    largest magnitude, as the dense FFN). At top-1 the renormalized gate is
    g / g = 1, so the router's gradient is zero in exact arithmetic and
    rounding noise on both sides (about 1e-9): held below 1e-6 of the
    largest gradient instead.
  * the init: every leaf's bits equal but the float32 router's, where
    XLA's `log1p` residue (ROADMAP queue 3, "LM init residue") leaves at
    most 3 ulps on under 2% of elements.
  * a whole model in float32: loss rtol 1e-5, every gradient leaf within
    1e-5 of its largest magnitude (observed 3.0e-6).
  * a whole model in bf16: the port's activations differ from XLA's by a
    bf16 rounding here and there, and a router choice near a tie flips
    (observed 0-6 of 256 choices a layer in deepseek-v2, 0-2 of 128 in
    maverick, seeds 1-3). Loss rtol 2e-3 (observed up to 1.07e-3); the
    flips held under 5% of the choices a layer. With the reference's own
    choices substituted for the port's, each gradient leaf is within
    5e-2 of its largest magnitude (observed 2.6e-2 to 3.6e-2) and the loss
    within rtol 1e-3 (observed up to 4.2e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as ref_mlp
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro.models.common import split_axes

from repro_torch.compress import prng
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.launch import steps as port_steps
from repro_torch.models import mlp as port_mlp
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf
from repro_torch.models.common import split_axes as split_axes_t

from _moe_routing import record_port_choices, record_reference_choices

CPU = torch.device("cpu")
DEEPSEEK = "deepseek-v2-236b"
MAVERICK = "llama4-maverick-400b-a17b"
MOE_ARCHS = (DEEPSEEK, MAVERICK)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy().view(np.uint32)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return tree


def _configs(arch, dtype, **changes):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(ref_registry.get_config(arch, "smoke"),
                                dtype=jdt, **changes),
            dataclasses.replace(port_registry.get_config(arch, "smoke"),
                                dtype=tdt, **changes))


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    return float(np.abs(b.float().numpy() - a).max()
                 / max(np.abs(a).max(), 1e-30))


# ---------------------------------------------------------------------------
# dispatch and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ties", "overflow", "spread", "one_slot"])
def test_dispatch_indices_are_the_reference_bits(case):
    """Ties (every assignment to two experts), overflow (one expert takes
    most), a spread and capacity 1: each row's destinations equal the
    reference's bit for bit, and a (G, A) batch equals its rows."""
    rng = np.random.default_rng({"ties": 0, "overflow": 1, "spread": 2,
                                 "one_slot": 3}[case])
    E, A = 8, 96
    ids = {"ties": rng.integers(0, 2, (3, A)),
           "overflow": np.where(rng.random((3, A)) < 0.8, 5,
                                rng.integers(0, E, (3, A))),
           "spread": rng.integers(0, E, (3, A)),
           "one_slot": rng.integers(0, E, (3, A))}[case].astype(np.int32)
    C = {"ties": 12, "overflow": 15, "spread": 13, "one_slot": 1}[case]
    want = np.stack([np.asarray(ref_mlp._dispatch_indices(
        jnp.asarray(row), E, C)) for row in ids])
    got = port_mlp._dispatch_indices(torch.from_numpy(ids), E, C)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port_mlp._dispatch_indices(torch.from_numpy(ids[1]), E, C).numpy(),
        want[1])
    # every real slot is taken at most once, and the drops go to E * C
    for row in want:
        real = row[row < E * C]
        assert len(set(real.tolist())) == len(real)
    if case in ("ties", "overflow", "one_slot"):
        assert (want == E * C).any()


def test_router_ties_go_to_the_lower_expert():
    """A router whose columns repeat gives exactly tied probabilities; the
    top K are then the lower experts, as `lax.top_k` picks them."""
    rng = np.random.default_rng(4)
    cols = rng.normal(size=(16, 3)).astype(np.float32)
    router = np.concatenate([cols, cols, cols[:, :2]], axis=1)   # E = 8
    tokens = rng.normal(size=(2, 10, 16)).astype(np.float32)
    logits = jnp.einsum("gnd,de->gne", jnp.asarray(tokens),
                        jnp.asarray(router))
    for K in (1, 2, 3):
        want = np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), K)[1])
        _, got = port_mlp._route(torch.from_numpy(tokens),
                                 torch.from_numpy(router), K)
        np.testing.assert_array_equal(got.numpy(), want)
        # the best column's first copy ranks first, then its second
        assert (got.numpy()[..., 0] < 3).all()
        if K > 1:
            assert (got.numpy()[..., 1] == got.numpy()[..., 0] + 3).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_is_the_reference_arithmetic(arch):
    cfg = port_registry.get_config(arch, "smoke")
    full = port_registry.get_config(arch, "full")
    for c, n in ((cfg, 64), (cfg, 128), (full, 4096)):
        for cf in (c.moe_capacity_factor, 0.05, 1.0, 2.0):
            cc = dataclasses.replace(c, moe_capacity_factor=cf)
            E, K = cc.moe_experts, cc.moe_top_k
            assert port_mlp.moe_capacity(cc, n) == max(
                1, int(-(-K * n * cf // E)))
    assert port_mlp.moe_capacity(full, 4096) == (
        192 if arch == DEEPSEEK else 40)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _moe_case(arch, dtype, cf, groups, seed=3):
    changes = {} if cf is None else {"moe_capacity_factor": cf}
    cfg_r, cfg_t = _configs(arch, dtype, **changes)
    prm_r, _ = split_axes(ref_mlp.moe_init(jax.random.PRNGKey(seed), cfg_r))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 32, cfg_r.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    def fwd_bwd(p, xx, gg):
        out, vjp = jax.vjp(
            lambda p_, x_: ref_mlp.moe_apply(p_, x_, cfg_r, groups=groups),
            p, xx)
        return (out,) + vjp(gg)
    out_r, dprm_r, dx_r = jax.jit(fwd_bwd)(prm_r, jnp.asarray(x, jdt),
                                           jnp.asarray(g, jdt))
    prm_t = lm_params_from_reference(jax.tree.map(np.asarray, prm_r),
                                     device=CPU)
    leaves = jax.tree_util.tree_leaves(prm_t)
    for t in leaves:
        t.requires_grad_()
    x_t = torch.from_numpy(x).to(tdt).requires_grad_()
    out_t = port_mlp.moe_apply(prm_t, x_t, cfg_t, groups=groups)
    grads = torch.autograd.grad(out_t, leaves + [x_t],
                                torch.from_numpy(g).to(tdt))
    return cfg_t, out_r, out_t, dprm_r, dx_r, prm_t, dict(
        zip(map(id, leaves), grads[:-1])), grads[-1]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,cf,groups", [
    (DEEPSEEK, None, 1), (DEEPSEEK, 0.05, 1), (DEEPSEEK, None, 2),
    (MAVERICK, None, 1), (MAVERICK, 0.05, 2)])
def test_moe_apply_matches_reference(arch, cf, groups, dtype):
    """Forward and the gradients of every parameter and of x, top-2
    (deepseek-v2 smoke, with a shared expert) and top-1 (maverick), at the
    default capacity and with drops forced (capacity factor 0.05, as
    tests/test_models.py forces them), in one and two dispatch groups."""
    cfg, out_r, out_t, dprm_r, dx_r, prm_t, grads, dx_t = _moe_case(
        arch, dtype, cf, groups)
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert out_t.dtype == DTYPES[dtype][1]
    assert _rel(out_r, out_t.detach()) <= tol
    assert _rel(dx_r, dx_t) <= tol
    largest = max(float(np.abs(np.asarray(a, np.float32)).max())
                  for a in jax.tree.leaves(dprm_r))
    for path, a in jax.tree_util.tree_leaves_with_path(dprm_r):
        mine = grads[id(_leaf(prm_t, path))]
        name = jax.tree_util.keystr(path)
        if name == "['router']" and cfg.moe_top_k == 1:
            # g / g = 1: zero in exact arithmetic, rounding noise on both
            assert np.abs(np.asarray(a, np.float32)).max() < 1e-6 * largest
            assert mine.abs().max().item() < 1e-6 * largest
            continue
        assert _rel(a, mine) <= tol, (name, _rel(a, mine))


def test_forced_drops_zero_the_dropped_tokens():
    """At capacity factor 0.05 most assignments land in the overflow slot;
    without a shared expert a token all of whose assignments dropped gets
    exactly 0, and the output stays finite."""
    _, cfg = _configs(MAVERICK, "float32", moe_capacity_factor=0.05,
                      moe_shared=0)
    prm, _ = split_axes_t(port_mlp.moe_init(prng.key(0), cfg))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32))
    out = port_mlp.moe_apply(prm, x, cfg)
    assert torch.isfinite(out).all()
    C = port_mlp.moe_capacity(cfg, 64)
    kept = (out.abs().sum(-1) > 0).sum().item()
    assert C == 1 and 0 < kept <= cfg.moe_experts * C


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_loss_matches_reference(arch):
    cfg_r, cfg_t = _configs(arch, "float32")
    prm_r, _ = split_axes(ref_mlp.moe_init(jax.random.PRNGKey(5), cfg_r))
    x = np.random.default_rng(5).normal(
        size=(2, 24, cfg_r.d_model)).astype(np.float32)
    want = float(ref_mlp.moe_aux_loss(prm_r, jnp.asarray(x), cfg_r))
    prm_t = lm_params_from_reference(jax.tree.map(np.asarray, prm_r),
                                     device=CPU)
    got = port_mlp.moe_aux_loss(prm_t, torch.from_numpy(x), cfg_t)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the two models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_matches_reference_but_the_router_residue(arch):
    cfg_r = ref_registry.get_config(arch, "smoke")
    cfg_t = port_registry.get_config(arch, "smoke")
    ref = jax.jit(lambda k: ref_tf.init(k, cfg_r)[0])(jax.random.PRNGKey(0))
    got, _ = port_tf.init(prng.key(0), cfg_t)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    routers = 0
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        mine = _leaf(got, path)
        assert mine.dtype == {jnp.bfloat16: torch.bfloat16,
                              jnp.float32: torch.float32}[leaf.dtype.type]
        if "router" in name:
            routers += 1
            ulps = np.abs(_tbits(mine).astype(np.int64)
                          - _bits(leaf).astype(np.int64))
            assert ulps.max() <= 3 and (ulps > 0).mean() < 0.02, name
        else:
            np.testing.assert_array_equal(_tbits(mine), _bits(leaf),
                                          err_msg=name)
    assert routers == cfg_t.superblock.count("attn_moe") + \
        cfg_t.superblock.count("mla_moe")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_carries_the_moe_and_mla_trees_both_ways(arch):
    """The reference's parameter tree (3-D expert leaves, the float32
    router, MLA's latent leaves, deepseek-v2's prologue list) into the
    port's tensors and back: every leaf's dtype, shape and bits."""
    cfg_r = ref_registry.get_config(arch, "smoke")
    ref = jax.tree.map(np.asarray, ref_tf.init(jax.random.PRNGKey(2),
                                               cfg_r)[0])
    ours = lm_params_from_reference(ref, device=CPU)
    if arch == DEEPSEEK:
        assert isinstance(ours["prologue"], list)
        assert ours["prologue"][0]["attn"]["wkv_a"].dtype == torch.bfloat16
    moe = ours["stack"]["slot0" if arch == DEEPSEEK else "slot1"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w_up"].dim() == 4
    back = lm_params_to_reference(ours)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(back)):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=jax.tree_util.keystr(path))


def _whole_model(arch, dtype, monkeypatch, seed, pin=False):
    """(loss_r, loss_t, gradient errors by leaf, flipped choices a MoE
    call, choices a call) on the reference's parameters. With `pin` the
    port routes each token as the reference did (its layers run without
    recompute, so each MoE call is made once, in order)."""
    cfg_r, cfg_t = _configs(arch, dtype)
    if pin:
        cfg_t = dataclasses.replace(cfg_t, remat=False)
    params_r, _ = ref_tf.init(jax.random.PRNGKey(seed), cfg_r)
    toks = np.random.default_rng(seed).integers(
        0, cfg_r.vocab_size, (2, 65)).astype(np.int32)
    batch_r = {"tokens": jnp.asarray(toks[:, :-1]),
               "labels": jnp.asarray(toks[:, 1:])}
    ref_calls = record_reference_choices(monkeypatch)
    loss_r, grads_r = jax.jit(jax.value_and_grad(ref_tf.loss_fn),
                              static_argnums=2)(params_r, batch_r, cfg_r)
    jax.effects_barrier()
    n_moe = len(ref_calls) // 2        # the forward's, then the recompute's
    ref_ids = ref_calls[:n_moe]
    port_calls = record_port_choices(monkeypatch,
                                     substitute=ref_ids if pin else None)
    params_t = lm_params_from_reference(jax.tree.map(np.asarray, params_r),
                                        device=CPU)
    batch_t = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
               "labels": torch.from_numpy(toks[:, 1:].copy())}
    loss_t, grads_t = port_steps.grad_fn(params_t, batch_t, cfg_t)
    errs = {}
    for path, g in jax.tree_util.tree_leaves_with_path(grads_r):
        name = jax.tree_util.keystr(path)
        if "router" in name and cfg_t.moe_top_k == 1:
            continue   # zero in exact arithmetic (see the module docstring)
        errs[name] = _rel(g, _leaf(grads_t, path))
    flips = [int((a != b).sum()) for a, b in zip(ref_ids, port_calls)]
    return (float(loss_r), float(loss_t), errs, flips, ref_ids[0].size,
            len(port_calls), n_moe)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_whole_model_float32(arch, monkeypatch):
    loss_r, loss_t, errs, flips, _, calls, n_moe = _whole_model(
        arch, "float32", monkeypatch, seed=1)
    assert n_moe == 2 and calls == 2 * n_moe   # forward and recompute
    assert flips == [0, 0]
    assert loss_t == pytest.approx(loss_r, rel=1e-5)
    assert max(errs.values()) < 1e-5, errs


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_whole_model_bf16_counts_its_flipped_choices(arch, monkeypatch):
    loss_r, loss_t, _, flips, choices, _, _ = _whole_model(
        arch, "bfloat16", monkeypatch, seed=1)
    assert loss_t == pytest.approx(loss_r, rel=2e-3)
    assert max(flips) <= 0.05 * choices, flips


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_whole_model_bf16_on_the_reference_choices(arch, monkeypatch):
    loss_r, loss_t, errs, _, _, calls, n_moe = _whole_model(
        arch, "bfloat16", monkeypatch, seed=1, pin=True)
    assert calls == n_moe
    assert loss_t == pytest.approx(loss_r, rel=1e-3)
    assert max(errs.values()) < 5e-2, errs
