"""The port's cross-attention (the VLM family, llama-3.2-vision) against the
JAX package's, on the CPU: `cross_attn_apply` over one encoder chunk and
streamed over `_ENC_CHUNK`-token chunks (N = 3200, a narrow encoder
width), `forward(enc=)` with its loss and gradients, the smoke model's
init, and `_cross_decode`'s division in the scores' dtype. The
reference's parameters are perturbed by seeded noise, so the tanh gate
(a zero scalar at init, where the block adds exactly 0) is not zero.

Standards (ROADMAP queue 3 gives the residues):
  * float32: outputs, the loss and every gradient within `F32_TOL` = 1e-5
    of their largest magnitude (observed at most 1.5e-6 in
    `cross_attn_apply`, 2.9e-6 in the whole model), but the streamed
    form's encoder gradient, a sum of softmax gradients over 3200 keys
    with cancellation: `STREAMED_ENC_TOL` = 5e-5 (observed 2.1e-5).
  * bf16: `cross_attn_apply`'s output and gradients within `BF16_TOL` =
    2e-2, about five bf16 roundings (observed at most 3.3e-4); the whole
    model's loss within rtol 5e-4 (observed 1.4e-4) and its gradients
    within 3e-2, the dense family's bf16 standard (observed 1.9e-2).
  * the gate's gradient in bf16, a sum of B S D bf16 products, which XLA
    accumulates in bf16 and torch in float32: held, on both sides,
    against the reference's float32 program on the same values, where the
    port must come nearer than the reference (observed 3.6e-3 against
    8.3e-2 in one chunk, 2.0e-4 against 3.9e-3 streamed, 2.1e-2 against
    1.0e-1 in the whole model).
  * the init: every leaf's bits (0 differences at the smoke width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro.launch.specs import params_and_axes
from repro.models.common import cross_entropy_loss, split_axes

from repro_torch.compress import prng
from repro_torch.launch import steps as port_steps
from repro_torch.models import attention as port_attn
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf

from _decode import one_torch_thread  # noqa: F401 (autouse)
from _decode import MODES, carry, configs, model, perturbed, rel

VISION = "llama-3.2-vision-90b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
#: the streamed form's encoder gradient in float32 (observed 2.1e-5)
STREAMED_ENC_TOL = 5e-5


def _grads(tree, leaves, grads):
    by_id = dict(zip(map(id, leaves), grads))
    return jax.tree.map(lambda t: by_id[id(t)], tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,E", [(16, 96), (3200, 8)])
def test_cross_attn_apply_matches_reference(N, E, dtype):
    """One chunk (N = 16) and the streamed form (N = 3200: two chunks of
    1600): the output, and the gradients of x, enc and every parameter."""
    (jdt, tdt), _ = MODES[dtype]
    cfg_r, cfg_t = configs(VISION, jdt, tdt, num_encoder_tokens=N,
                           encoder_dim=E)
    prm, _ = split_axes(ref_attn.cross_attn_init(jax.random.PRNGKey(1),
                                                 cfg_r))
    prm = perturbed(prm, 1)
    assert float(prm["gate"]) != 0.0
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, cfg_r.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, N, E)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def fwd_bwd(p_, x_, e_, c_):
        out, vjp = jax.vjp(lambda a, b, c: ref_attn.cross_attn_apply(
            a, b, c, cfg_r), p_, x_, e_)
        return out, vjp(c_)
    out_r, (g_prm, g_x, g_enc) = jax.jit(fwd_bwd)(
        prm, jnp.asarray(x, jdt), jnp.asarray(enc, jdt),
        jnp.asarray(cot, jdt))

    prm_t = carry(prm)
    leaves = jax.tree.leaves(prm_t)
    x_t = torch.from_numpy(x).to(tdt).requires_grad_()
    enc_t = torch.from_numpy(enc).to(tdt).requires_grad_()
    for t in leaves:
        t.requires_grad_()
    out_t = port_attn.cross_attn_apply(prm_t, x_t, enc_t, cfg_t)
    grads = torch.autograd.grad(out_t, leaves + [x_t, enc_t],
                                torch.from_numpy(cot).to(tdt))
    errs = {"out": rel(out_r, out_t), "x": rel(g_x, grads[-2]),
            "enc": rel(g_enc, grads[-1])}
    g_prm_t = _grads(prm_t, leaves, grads[:-2])
    for name, g in g_prm_t.items():
        errs[name] = rel(g_prm[name], g)
    if dtype == "float32":
        if N > 1600:
            # the streamed form's encoder gradient: softmax gradients over
            # 3200 keys, with cancellation, summed in another order
            assert errs.pop("enc") <= STREAMED_ENC_TOL
        assert max(errs.values()) <= F32_TOL, errs
        return
    # bf16: the gate's gradient is a sum of B S D bf16 products, which
    # XLA accumulates in bf16 and torch in float32: held against the same
    # sum in float32 (the reference's float32 program on these values)
    gate_err = errs.pop("gate")
    assert max(errs.values()) <= BF16_TOL, errs
    up = lambda a: jnp.asarray(a, jnp.float32)
    cfg32, _ = configs(VISION, jnp.float32, torch.float32,
                       num_encoder_tokens=N, encoder_dim=E)
    g32 = jax.jit(lambda p_, x_, e_, c_: jax.vjp(
        lambda a: ref_attn.cross_attn_apply(a, x_, e_, cfg32), p_)[1](c_))(
        jax.tree.map(up, prm), up(jnp.asarray(x, jdt)),
        up(jnp.asarray(enc, jdt)), up(jnp.asarray(cot, jdt)))[0]["gate"]
    ours_err = rel(g32, g_prm_t["gate"])
    theirs_err = rel(g32, g_prm["gate"])
    assert ours_err < theirs_err and ours_err <= BF16_TOL, (
        ours_err, theirs_err, gate_err)


GATE = "['stack']['slot2']['attn']['gate']"


def _ref_loss_and_grads(params, batch, cfg_r):
    """The reference's loss (with the forward's logits) and gradients, in
    one jitted program."""
    def loss(p_, b_):
        logits = ref_tf.forward(p_, b_["tokens"], cfg_r, enc=b_["enc"])
        return cross_entropy_loss(logits, b_["labels"]), logits
    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch)


def _loss_and_grads(mode, seed=5):
    cfg_r, cfg_t, params, params_t = model(VISION, mode, seed=seed)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg_r.vocab_size, (2, 12)).astype(np.int32)
    enc = rng.normal(size=(2, cfg_r.num_encoder_tokens,
                           cfg_r.encoder_dim)).astype(np.float32)
    jdt = cfg_r.dtype
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens),
             "enc": jnp.asarray(enc, jdt)}
    (loss, logits), grads = _ref_loss_and_grads(params, batch, cfg_r)
    batch_t = {"tokens": torch.from_numpy(tokens),
               "labels": torch.from_numpy(tokens),
               "enc": torch.from_numpy(enc).to(cfg_t.dtype)}
    with torch.no_grad():
        logits_t = port_tf.forward(params_t, batch_t["tokens"], cfg_t,
                                   enc=batch_t["enc"])
    loss_t, grads_t = port_steps.grad_fn(params_t, batch_t, cfg_t)
    errs = {"logits": rel(logits, logits_t)}
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        mine = grads_t
        for k in path:
            mine = mine[k.key]
        errs[jax.tree_util.keystr(path)] = rel(g, mine)
    if mode == "bfloat16":
        # the gates' gradients against the reference's float32 program on
        # the same (bf16) values: XLA sums the bf16 products in bf16
        cfg32, _ = configs(VISION, jnp.float32, torch.float32)
        up = lambda a: jnp.asarray(a, jnp.float32)
        g32 = _ref_loss_and_grads(jax.tree.map(up, params),
                                  jax.tree.map(up, batch) | {
                                      "tokens": batch["tokens"],
                                      "labels": batch["labels"]},
                                  cfg32)[1]
        gate32 = g32["stack"]["slot2"]["attn"]["gate"]
        errs["gate_vs_f32"] = (
            rel(gate32, grads_t["stack"]["slot2"]["attn"]["gate"]),
            rel(gate32, grads["stack"]["slot2"]["attn"]["gate"]))
    return float(loss), float(loss_t), errs


def test_forward_with_enc_matches_reference_float32():
    """Logits, loss and every gradient, the gates' included (not zero)."""
    loss_r, loss_t, errs = _loss_and_grads("float32")
    assert loss_t == pytest.approx(loss_r, rel=1e-5)
    assert max(errs.values()) <= F32_TOL, errs


def test_forward_with_enc_matches_reference_bf16():
    """Logits and every gradient but the gates' within the dense family's
    bf16 standard; the gates' gradient nearer the float32 program's than
    the reference's is."""
    loss_r, loss_t, errs = _loss_and_grads("bfloat16")
    assert loss_t == pytest.approx(loss_r, rel=5e-4)
    ours, theirs = errs.pop("gate_vs_f32")
    errs.pop(GATE)
    assert max(errs.values()) <= 3e-2, errs
    assert ours < theirs and ours <= 3e-2, (ours, theirs)


def test_init_matches_reference_bit_for_bit():
    """llama-3.2-vision smoke's init: every leaf's bits (the truncated-normal
    residue of ROADMAP queue 3 shows at none of them at this width), the
    cross-attention gate a float32 zero, and the reference's axes."""
    cfg_r = ref_registry.get_config(VISION, "smoke")
    cfg_t = port_registry.get_config(VISION, "smoke")
    ref = jax.jit(lambda k: ref_tf.init(k, cfg_r)[0])(jax.random.PRNGKey(0))
    got, axes = port_tf.init(prng.key(0), cfg_t)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(jax.tree.leaves(got)) == 31
    differ = []
    for path, leaf in leaves:
        mine = got
        for k in path:
            mine = mine[k.key]
        a = np.asarray(leaf)
        assert tuple(mine.shape) == a.shape
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        ours = (mine.view(torch.uint16) if mine.dtype == torch.bfloat16
                else mine).numpy().view(bits)
        if (ours != a.view(bits)).any():
            differ.append(jax.tree_util.keystr(path))
    assert differ == []
    gate = got["stack"]["slot2"]["attn"]["gate"]
    assert gate.dtype == torch.float32 and gate.shape == (cfg_t.n_super,)
    assert not gate.any()
    assert axes == params_and_axes(cfg_r)[1]


def test_cross_decode_divides_by_the_root_in_the_scores_dtype():
    """`_cross_decode` divides its bf16 scores by `jnp.sqrt(hd)`, weakly
    typed, so rounded to bf16 (5.65625 for hd = 32), before the cast to
    float32; jitted, XLA divides in float32 and keeps the quotient
    unrounded. The port does the same, bit for bit. The eager reference
    (the quotient rounded to bf16) and the float32 root after the cast
    (`cross_attn_apply`'s scaling) each change the output at some
    elements: 136 and 34 of 256 here."""
    # a head dim whose square root is not a power of two
    cfg_r, cfg_t = configs(VISION, jnp.bfloat16, torch.bfloat16,
                           head_dim=32)
    prm, _ = split_axes(ref_attn.cross_attn_init(jax.random.PRNGKey(3),
                                                 cfg_r))
    prm = perturbed(prm, 3)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(2, 1, cfg_r.d_model)), jnp.bfloat16)
    K, hd, N = cfg_r.num_kv_heads, cfg_r.hd, cfg_r.num_encoder_tokens
    cache = {k: jnp.asarray(rng.normal(size=(2, N, K, hd)), jnp.bfloat16)
             for k in ("ek", "ev")}

    def decode(p_, x_, c_):
        return ref_tf._cross_decode(p_, x_, c_, cfg_r)[0]
    ref = np.asarray(jax.jit(decode)(prm, x, cache)).view(np.uint16)
    ours = port_tf._cross_decode(carry(prm), carry(x), carry(cache),
                                 cfg_t)[0]
    np.testing.assert_array_equal(ours.view(torch.uint16).numpy(), ref)

    def scaled_after_cast(p_, x_, c_):
        q = jnp.einsum("bsd,dhk->bshk", ref_tf.rms_norm(x_, p_["norm"]),
                       p_["wq"]).reshape(2, 1, K, -1, hd)
        s = jnp.einsum("bskgh,bnkh->bkgsn", q, c_["ek"]).astype(jnp.float32)
        w = jax.nn.softmax(s / jnp.sqrt(hd).astype(jnp.float32),
                           axis=-1).astype(x_.dtype)
        out = jnp.einsum("bkgsn,bnkh->bskgh", w, c_["ev"]).reshape(
            2, 1, -1, hd)
        out = jnp.einsum("bshk,hkd->bsd", out, p_["wo"])
        return jnp.tanh(p_["gate"]).astype(x_.dtype) * out
    eager = np.asarray(decode(prm, x, cache)).view(np.uint16)
    after = np.asarray(jax.jit(scaled_after_cast)(prm, x, cache)).view(
        np.uint16)
    assert (int((eager != ref).sum()), int((after != ref).sum())) == (136, 34)
