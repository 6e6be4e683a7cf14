"""The port's state-space blocks and zamba2's shared attention against the
JAX package's, on the CPU: `_causal_conv`, softplus, `_m1_scan_chunk`,
`mamba1_mix`, `mamba1_apply`, `_ssd_chunk`, `mamba2_mix`, `mamba2_apply`
and `_shared_attn_apply` (outputs and the gradients of every input and
parameter, on the reference's parameters perturbed by seeded noise, so
that the zero-initialised LoRA deltas and conv biases are not zero); the
mixers over several chunks (the inter-chunk carry) and over a sequence
that is not a multiple of the chunk (one chunk); the init; the trees
through `convert` both ways; both whole models (falcon-mamba-7b and
zamba2-2.7b smoke widths) in float32 and bf16; and the chunk checkpoints
inside the layer checkpoints.

Standards (ROADMAP queue 3 gives the observed errors):
  * float32: every output and gradient within `F32_TOL` = 1e-5 of its
    largest magnitude (observed at most 8.6e-6, zamba2 over two 256-token
    chunks; 5.0e-6 elsewhere); whole-model losses rtol 1e-5 (observed
    1.5e-7 and 0).
  * bf16: every output and gradient within `BF16_TOL` = 5e-2 of its
    largest magnitude, the MoE family's bf16 standard: the port rounds
    the conv's running sum, each product and the gate to bf16 where XLA
    keeps some of them in float32, and a few bf16 roundings (2^-8 each)
    pile up in the gradients that sum over the sequence (observed up to
    4.1e-2, zamba2's `D_skip` gradient; 2.9e-2 in a Mamba-1 mixer);
    whole-model losses rtol 5e-4 (observed 4.3e-5 and 2.0e-5).
  * softplus (jax's `logaddexp(x, 0)`): XLA's `exp` and `log1p` are not
    torch's; values at most 2 ulps apart, at under 10% of the elements
    (observed 4.9%; `F.softplus`, another formula, 6.2%), gradients
    within rtol 1e-6.
  * the init: every leaf's bits but two residues, both counted: XLA's
    `log1p` inside `truncated_normal` (ROADMAP queue 3, "LM init
    residue"; at the smoke widths one bf16 element of an `in_proj`, 1
    ulp), and `A_log`'s `log`, which XLA does not round correctly (0 of
    Mamba-1's 16 values and of zamba2 smoke's 8 heads; 4 of zamba2's 80
    heads, 1 ulp). Mamba-2's `A` (`jnp.linspace` under jit) is bit for
    bit.
  * `_ssd_chunk` where a chunk's decay passes exp's range: the
    reference's gradient is NaN, the port's finite (ROADMAP queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as ref_registry
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.common import split_axes

from repro_torch.compress import prng
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.launch import steps as port_steps
from repro_torch.models import registry as port_registry
from repro_torch.models import ssm as port_ssm
from repro_torch.models import transformer as port_tf
from repro_torch.models.common import split_axes as split_axes_t

CPU = torch.device("cpu")
FALCON = "falcon-mamba-7b"
ZAMBA = "zamba2-2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-5
BF16_TOL = 5e-2
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
#: (S, chunk): four chunks with their carry; S not a multiple of the
#: chunk (the whole sequence one chunk). S below the default 256-token
#: chunk is the blocks' and the whole models' case below
CHUNKINGS = [(64, 16), (60, 16)]


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


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = b.detach().float().numpy()
    assert a.shape == b.shape
    return float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))


def _configs(arch, dtype, **changes):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(ref_registry.get_config(arch, "smoke"),
                                dtype=jdt, **changes),
            dataclasses.replace(port_registry.get_config(arch, "smoke"),
                                dtype=tdt, **changes))


def _perturbed(prm, seed: int):
    """The reference's parameters plus seeded noise of a fifth of each
    leaf's spread (0.2 where a leaf is constant), in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        f = a.astype(np.float32)
        spread = float(f.std()) or 1.0
        noise = rng.normal(size=a.shape).astype(np.float32) * 0.2 * spread
        return jnp.asarray(f + noise, a.dtype)
    return jax.tree.map(one, prm)


def _compare(ref_fn, port_fn, prm_r, inputs, dtype, seed=0):
    """Run `ref_fn(prm, *inputs)` (jitted, as the reference runs) and
    `port_fn(prm, *inputs)` on the same (float32 numpy) inputs cast to
    `dtype` and the same parameters, then the VJP of one seeded cotangent
    per output. Returns {name: relative
    error} over the outputs, the inputs' gradients and every parameter's,
    and {name: the reference's largest magnitude}."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed + 100)
    xs_r = [jnp.asarray(x, jdt) if x.dtype == np.float32 else jnp.asarray(x)
            for x in inputs]
    shapes = jax.eval_shape(ref_fn, prm_r, *xs_r)
    single = not isinstance(shapes, tuple)
    shapes = (shapes,) if single else shapes
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in shapes]
    cots_r = [jnp.asarray(c, o.dtype) for c, o in zip(cots, shapes)]

    def fwd_bwd(p_, xs, cs):
        outs, vjp = jax.vjp(ref_fn, p_, *xs)
        return outs, vjp(cs[0] if single else tuple(cs))
    outs_r, grads_r = jax.jit(fwd_bwd)(prm_r, xs_r, cots_r)
    outs_r = (outs_r,) if single else outs_r

    prm_t = lm_params_from_reference(jax.tree.map(np.asarray, prm_r),
                                     device=CPU)
    leaves = jax.tree_util.tree_leaves(prm_t)
    for t in leaves:
        t.requires_grad_()
    xs_t = [torch.from_numpy(x).to(tdt).requires_grad_()
            if x.dtype == np.float32 else torch.from_numpy(x)
            for x in inputs]
    outs_t = port_fn(prm_t, *xs_t)
    outs_t = (outs_t,) if single else outs_t
    cots_t = [torch.from_numpy(c).to(o.dtype) for c, o in zip(cots, outs_t)]
    wrt = leaves + [x for x in xs_t if x.requires_grad]
    grads_t = torch.autograd.grad(outs_t, wrt, cots_t, allow_unused=True)
    grads_t = [torch.zeros_like(w) if g is None else g
               for g, w in zip(grads_t, wrt)]

    errs, mags = {}, {}

    def put(name, a, b):
        errs[name] = _rel(a, b)
        mags[name] = float(np.abs(np.asarray(a, np.float32)).max())

    for i, (a, b) in enumerate(zip(outs_r, outs_t)):
        assert b.dtype == {jnp.float32: torch.float32,
                           jnp.bfloat16: torch.bfloat16}[a.dtype.type]
        put(f"out{i}", a, b)
    by_id = dict(zip(map(id, leaves), grads_t[:len(leaves)]))
    for path, g in jax.tree_util.tree_leaves_with_path(grads_r[0]):
        put(jax.tree_util.keystr(path), g, by_id[id(_leaf(prm_t, path))])
    dx_t = iter(grads_t[len(leaves):])
    for i, (x, g) in enumerate(zip(inputs, grads_r[1:])):
        if x.dtype == np.float32:
            put(f"d_input{i}", g, next(dx_t))
    return errs, mags


def _mixer_params(arch, dtype, seed):
    cfg_r, cfg_t = _configs(arch, dtype)
    init = ref_ssm.mamba1_init if arch == FALCON else ref_ssm.mamba2_init
    prm, _ = split_axes(init(jax.random.PRNGKey(seed), cfg_r))
    return cfg_r, cfg_t, _perturbed(prm, seed)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 37, 24)).astype(np.float32)
    w = rng.normal(size=(24, 4)).astype(np.float32) * 0.5
    b = rng.normal(size=(24,)).astype(np.float32)
    jdt = DTYPES[dtype][0]
    prm = {"w": jnp.asarray(w, jdt), "b": jnp.asarray(b, jdt)}
    errs, mags = _compare(lambda p_, x_: ref_ssm._causal_conv(x_, p_["w"], p_["b"]),
                    lambda p_, x_: port_ssm._causal_conv(x_, p_["w"],
                                                         p_["b"]),
                    prm, [x], dtype)
    assert set(errs) == {"out0", "['b']", "['w']", "d_input0"}
    assert max(errs.values()) <= TOL[dtype], errs
    if dtype == "float32":
        # the taps' order is the reference's: the forward is bit for bit
        with torch.no_grad():
            out = port_ssm._causal_conv(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        torch.from_numpy(b))
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(ref_ssm._causal_conv(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))))


def test_softplus_residue_is_pinned():
    """jax's softplus formula; XLA's exp and log1p against torch's: at
    most 2 ulps, at under 10% of elements, over the range dt meets."""
    x = np.random.default_rng(1).normal(size=(1 << 16,)).astype(
        np.float32) * 4 - 4.6
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = port_ssm.softplus(torch.from_numpy(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2 and (ulps > 0).mean() < 0.10, (
        ulps.max(), (ulps > 0).mean())
    # the derivative is jax's, exp(x - softplus(x))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(port_ssm.softplus(xt).sum(), xt)
    want_g = np.asarray(jax.grad(lambda v: jax.nn.softplus(v).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=0)


def test_m1_scan_chunk_matches_reference():
    rng = np.random.default_rng(2)
    B, Q, d, N = 2, 24, 16, 8
    h0 = rng.normal(size=(B, d, N)).astype(np.float32)
    dA = np.exp(-rng.random((B, Q, d, N)).astype(np.float32))
    dBx = rng.normal(size=(B, Q, d, N)).astype(np.float32) * 0.3
    C = rng.normal(size=(B, Q, N)).astype(np.float32)
    errs, mags = _compare(lambda _, *a: ref_ssm._m1_scan_chunk(*a),
                    lambda _, *a: port_ssm._m1_scan_chunk(*a),
                    {}, [h0, dA, dBx, C], "float32")
    assert len(errs) == 6 and max(errs.values()) <= F32_TOL, errs


def test_ssd_chunk_matches_reference():
    rng = np.random.default_rng(3)
    B, Q, H, P, N = 2, 32, 4, 8, 6
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, Q, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(B, Q, H)) - 1.0)).astype(
        np.float32)
    Bc = rng.normal(size=(B, Q, N)).astype(np.float32) * 0.5
    Cc = rng.normal(size=(B, Q, N)).astype(np.float32) * 0.5
    A = -np.exp(rng.normal(size=(H,)) * 0.3).astype(np.float32)
    errs, mags = _compare(lambda _, *a: ref_ssm._ssd_chunk(*a),
                    lambda _, *a: port_ssm._ssd_chunk(*a),
                    {}, [h0, x, dt, Bc, Cc, A], "float32")
    assert len(errs) == 8 and max(errs.values()) <= F32_TOL, errs


def test_ssd_chunk_gradient_stays_finite_where_the_reference_overflows():
    """A chunk whose decay passes exp's range (cum below -88.7): above the
    diagonal the reference's exp(cum_s - cum_t) is inf, masked to 0 in
    the forward, and its gradient 0 * inf = NaN. The port takes exp of
    -inf there: the same output, and finite gradients that equal the
    reference's where it has any (those of h0 and x, which reach no
    masked entry, within F32_TOL)."""
    rng = np.random.default_rng(10)
    B, Q, H, P, N = 1, 64, 2, 4, 3
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, Q, H, P)).astype(np.float32)
    dt = np.full((B, Q, H), 0.2, np.float32)
    Bc, Cc = (rng.normal(size=(B, Q, N)).astype(np.float32)
              for _ in range(2))
    A = np.array([-1.0, -16.0], np.float32)       # head 1: cum to -204.8
    out_r, vjp = jax.vjp(ref_ssm._ssd_chunk, *map(jnp.asarray,
                                                  (h0, x, dt, Bc, Cc, A)))
    g = [np.ones(o.shape, np.float32) for o in out_r]
    grads_r = vjp(tuple(map(jnp.asarray, g)))
    assert not np.isfinite(np.asarray(grads_r[2])).all()   # d dt: NaN
    ins = [torch.from_numpy(a).requires_grad_() for a in
           (h0, x, dt, Bc, Cc, A)]
    out_t = port_ssm._ssd_chunk(*ins)
    grads_t = torch.autograd.grad(out_t, ins, [torch.from_numpy(a)
                                              for a in g])
    for a, b in zip(out_r, out_t):
        assert _rel(a, b) <= F32_TOL
    assert all(torch.isfinite(t).all() for t in grads_t)
    for i in (0, 1):
        assert np.isfinite(np.asarray(grads_r[i])).all()
        assert _rel(grads_r[i], grads_t[i]) <= F32_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,chunk", CHUNKINGS)
@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_mixer_matches_reference(arch, S, chunk, dtype):
    """`mamba1_mix` (falcon-mamba smoke) and `mamba2_mix` (zamba2 smoke)
    with their chunk checkpoints, on perturbed parameters: the output and
    the gradients of the projected input and of every parameter the
    mixer reads."""
    cfg_r, cfg_t, prm = _mixer_params(arch, dtype, seed=4)
    if arch == FALCON:
        d_in, _ = ref_ssm._m1_dims(cfg_r)
        width = 2 * d_in
        ref_mix, port_mix = ref_ssm.mamba1_mix, port_ssm.mamba1_mix
    else:
        d_in, H = ref_ssm._m2_dims(cfg_r)
        width = 2 * d_in + 2 * cfg_r.ssm_state + H
        ref_mix, port_mix = ref_ssm.mamba2_mix, port_ssm.mamba2_mix
    xz = np.random.default_rng(5).normal(size=(2, S, width)).astype(
        np.float32)
    errs, mags = _compare(lambda p_, x_: ref_mix(p_, x_, cfg_r, chunk=chunk),
                    lambda p_, x_: port_mix(p_, x_, cfg_t, chunk=chunk),
                    prm, [xz], dtype)
    unread = {"['norm']", "['in_proj']", "['out_proj']"}
    assert all(errs[k] == mags[k] == 0.0 for k in unread), errs
    assert max(errs.values()) <= TOL[dtype], errs


def test_mixer_chunks_carry_the_state():
    """Four chunks with their carry give the one-chunk result to float32
    rounding, and a carry dropped between chunks would not."""
    _, cfg, prm = _mixer_params(ZAMBA, "float32", seed=6)
    prm_t = lm_params_from_reference(jax.tree.map(np.asarray, prm),
                                     device=CPU)
    d_in, H = port_ssm._m2_dims(cfg)
    xz = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 64, 2 * d_in + 2 * cfg.ssm_state + H)).astype(np.float32))
    with torch.no_grad():
        whole = port_ssm.mamba2_mix(prm_t, xz, cfg, chunk=64)
        four = port_ssm.mamba2_mix(prm_t, xz, cfg, chunk=16)
        restart = torch.cat([port_ssm.mamba2_mix(prm_t, xz[:, i:i + 16],
                                                 cfg, chunk=16)
                             for i in range(0, 64, 16)], dim=1)
    assert torch.allclose(four, whole, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(restart, whole, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_mamba_apply_matches_reference(arch, dtype):
    cfg_r, cfg_t, prm = _mixer_params(arch, dtype, seed=7)
    ref_apply = ref_ssm.mamba1_apply if arch == FALCON else \
        ref_ssm.mamba2_apply
    port_apply = port_ssm.mamba1_apply if arch == FALCON else \
        port_ssm.mamba2_apply
    x = np.random.default_rng(7).normal(
        size=(2, 48, cfg_r.d_model)).astype(np.float32)
    errs, mags = _compare(lambda p_, x_: ref_apply(p_, x_, cfg_r),
                    lambda p_, x_: port_apply(p_, x_, cfg_t),
                    prm, [x], dtype)
    assert max(errs.values()) <= TOL[dtype], errs


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shared_attn_apply_with_nonzero_lora_matches_reference(dtype):
    """The shared attention plus its LoRA delta, every LoRA leaf non-zero
    (the deltas `lora_q_b` and `lora_o_b` start at zero, where the delta
    and every LoRA gradient are exactly 0)."""
    cfg_r, cfg_t = _configs(ZAMBA, dtype)
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    lora, _ = split_axes(ref_tf._block_init("shared_attn", k1, cfg_r))
    shared, _ = split_axes(ref_tf.attn.gqa_init(k2, cfg_r))
    assert not np.asarray(lora["lora_q_b"], np.float32).any()
    prm = _perturbed({"lora": lora, "shared": shared}, seed=8)
    for name in ("lora_q_b", "lora_o_b"):
        assert np.abs(np.asarray(prm["lora"][name], np.float32)).min() > 0
    S = 40
    x = np.random.default_rng(8).normal(
        size=(2, S, cfg_r.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    errs, mags = _compare(
        lambda p_, x_, q_: ref_tf._shared_attn_apply(
            p_["lora"], p_["shared"], x_, cfg_r, q_),
        lambda p_, x_, q_: port_tf._shared_attn_apply(
            p_["lora"], p_["shared"], x_, cfg_t, q_),
        prm, [x, pos], dtype)
    assert len(errs) == 1 + 4 + 5 + 1
    for k in ("lora_q_a", "lora_q_b", "lora_o_a", "lora_o_b"):
        assert mags[f"['lora']['{k}']"] > 0, k
    assert max(errs.values()) <= TOL[dtype], errs


# ---------------------------------------------------------------------------
# init and convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num", [2, 8, 37, 80, 128, 200])
def test_linspace_is_jnp_linspace_under_jit(num):
    want = np.asarray(jax.jit(lambda: jnp.linspace(1.0, 16.0, num))())
    got = port_ssm._linspace(1.0, 16.0, num)
    np.testing.assert_array_equal(_tbits(got), _bits(want))


def _ulps(t: torch.Tensor, a) -> np.ndarray:
    return np.abs(_tbits(t).astype(np.int64) - _bits(a).astype(np.int64))


@pytest.mark.parametrize("arch,heads,a_log_diffs", [
    (FALCON, None, 0), (ZAMBA, 8, 0), (ZAMBA, 80, 4)])
def test_mixer_init_a_log_residue_is_pinned(arch, heads, a_log_diffs):
    """A mixer's init against the reference's jitted one: every leaf bit
    for bit but `A_log`, whose differing elements are counted (1 ulp).
    Falcon-mamba-7b's A (its N = 16) and zamba2's at 8 (smoke) and 80
    heads (its published count; d_model cut to 160 with heads of 4)."""
    changes = {} if heads in (None, 8) else {"d_model": 160,
                                             "ssm_head_dim": 4}
    if arch == FALCON:
        changes["ssm_state"] = port_registry.get_config(FALCON).ssm_state
    cfg_r, cfg_t = _configs(arch, "bfloat16", **changes)
    r_init = ref_ssm.mamba1_init if arch == FALCON else ref_ssm.mamba2_init
    t_init = port_ssm.mamba1_init if arch == FALCON else port_ssm.mamba2_init
    ref = jax.jit(lambda k: split_axes(r_init(k, cfg_r))[0])(
        jax.random.PRNGKey(9))
    got, axes = split_axes_t(t_init(prng.key(9), cfg_t))
    ref_axes = split_axes(r_init(jax.random.PRNGKey(9), cfg_r))[1]
    assert axes == ref_axes and sorted(got) == sorted(ref)
    if heads:
        assert got["A_log"].shape == (heads,)
    for name, leaf in ref.items():
        ulps = _ulps(got[name], leaf)
        if name == "A_log":
            assert int((ulps > 0).sum()) == a_log_diffs, ulps
            assert ulps.max() <= 1
        else:
            assert got[name].dtype == {jnp.bfloat16: torch.bfloat16,
                                       jnp.float32: torch.float32}[
                                           leaf.dtype.type]
            assert not ulps.any(), name


@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_init_matches_reference_but_the_truncated_normal_residue(arch):
    """The whole smoke model's init: every leaf's bits but one bf16
    element of one `in_proj` (XLA's `log1p` inside `truncated_normal`),
    1 ulp off; zamba2's shared attention and FFN at the top level."""
    cfg_r = ref_registry.get_config(arch, "smoke")
    cfg_t = port_registry.get_config(arch, "smoke")
    ref = jax.jit(lambda k: ref_tf.init(k, cfg_r)[0])(jax.random.PRNGKey(0))
    got, axes = port_tf.init(prng.key(0), cfg_t)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got)) == (
        13 if arch == FALCON else 33)
    assert ("shared_attn" in got and "shared_mlp" in got) == (arch == ZAMBA)
    residue = {}
    for path, leaf in leaves:
        ulps = _ulps(_leaf(got, path), leaf)
        if ulps.any():
            residue[jax.tree_util.keystr(path)] = (int((ulps > 0).sum()),
                                                   int(ulps.max()))
    assert residue == {"['stack']['slot0']['mamba']['in_proj']": (1, 1)}
    ref_axes = ref_tf.init(jax.random.PRNGKey(0), cfg_r)[1]
    for path, ax in jax.tree_util.tree_leaves_with_path(
            ref_axes, is_leaf=lambda a: isinstance(a, tuple)):
        assert _leaf(axes, path) == ax


@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_convert_carries_the_ssm_trees_both_ways(arch):
    """The stacked mamba slots, the stacked LoRA slot and the top-level
    shared attention and FFN into the port's tensors and back: every
    leaf's dtype, shape and bits."""
    cfg_r = ref_registry.get_config(arch, "smoke")
    ref = jax.tree.map(np.asarray, ref_tf.init(jax.random.PRNGKey(2),
                                               cfg_r)[0])
    ours = lm_params_from_reference(ref, device=CPU)
    slot0 = ours["stack"]["slot0"]["mamba"]
    assert slot0["A_log"].dtype == torch.float32
    assert slot0["in_proj"].dtype == torch.bfloat16
    assert slot0["in_proj"].shape[0] == cfg_r.n_super
    if arch == ZAMBA:
        lora = ours["stack"]["slot2"]
        assert lora["lora_o_a"].shape == (cfg_r.n_super, cfg_r.num_heads,
                                          cfg_r.hd, cfg_r.shared_attn_lora)
        assert ours["shared_attn"]["wq"].dim() == 3
        assert ours["shared_mlp"]["w_up"].dim() == 2
    back = lm_params_to_reference(ours)
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(ref))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(back)):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the whole models
# ---------------------------------------------------------------------------


def _whole_model(arch, dtype, seed=1, S=64):
    cfg_r, cfg_t = _configs(arch, dtype)
    params_r, _ = ref_tf.init(jax.random.PRNGKey(seed), cfg_r)
    if arch == ZAMBA:
        # non-zero LoRA deltas, so that the LoRA path adds something
        params_r["stack"]["slot2"] = _perturbed(params_r["stack"]["slot2"],
                                                seed)
    toks = np.random.default_rng(seed).integers(
        0, cfg_r.vocab_size, (2, S + 1)).astype(np.int32)
    batch_r = {"tokens": jnp.asarray(toks[:, :-1]),
               "labels": jnp.asarray(toks[:, 1:])}
    loss_r, grads_r = jax.jit(jax.value_and_grad(ref_tf.loss_fn),
                              static_argnums=2)(params_r, batch_r, cfg_r)
    params_t = lm_params_from_reference(jax.tree.map(np.asarray, params_r),
                                        device=CPU)
    batch_t = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
               "labels": torch.from_numpy(toks[:, 1:].copy())}
    loss_t, grads_t = port_steps.grad_fn(params_t, batch_t, cfg_t)
    errs = {jax.tree_util.keystr(path): _rel(g, _leaf(grads_t, path))
            for path, g in jax.tree_util.tree_leaves_with_path(grads_r)}
    return float(loss_r), float(loss_t), errs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_whole_model_matches_reference(arch, dtype):
    loss_r, loss_t, errs = _whole_model(arch, dtype)
    assert loss_t == pytest.approx(loss_r, rel=F32_TOL if dtype ==
                                   "float32" else 5e-4)
    assert max(errs.values()) <= TOL[dtype], errs
    if arch == ZAMBA:
        assert len(errs) == 33 and "['shared_mlp']['w_up']" in errs


def test_whole_model_over_two_chunks_matches_reference():
    """S = 512: two 256-token chunks in every mixer, each checkpointed
    inside its layer's checkpoint (zamba2 smoke, float32)."""
    loss_r, loss_t, errs = _whole_model(ZAMBA, "float32", seed=1, S=512)
    assert loss_t == pytest.approx(loss_r, rel=F32_TOL)
    assert max(errs.values()) <= F32_TOL, errs


@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_nested_checkpoints_change_nothing(arch):
    """The chunk checkpoints inside the layer checkpoints, against no
    checkpoint at all: loss and every gradient bit for bit, over two
    chunks (S = 512)."""
    cfg = port_registry.get_config(arch, "smoke")
    params, _ = port_tf.init(prng.key(3), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 513),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_a, g_a = port_steps.grad_fn(params, batch, cfg)
    loss_b, g_b = port_steps.grad_fn(
        params, batch, dataclasses.replace(cfg, remat=False))
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(jax.tree_util.tree_leaves(g_a),
                    jax.tree_util.tree_leaves(g_b)):
        assert torch.equal(a, b)
