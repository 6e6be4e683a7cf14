"""The port's multi-head latent attention (DeepSeek-V2's MLA) against the JAX
package's, on the CPU: `mla_init`'s bits, `mla_apply` forward and the
gradients of every parameter and of x at deepseek-v2's smoke width in
float32 and bf16, the latent and rope halves (`_mla_q`, `_mla_kv_latent`),
and the streamed attention with a value head narrower than q and k, which
MLA's full-width cell takes (S = 4096 > one 1024-key chunk).

Standards:
  * `mla_init`: bits equal (no float32 leaf is drawn).
  * `_mla_q`, `_mla_kv_latent` and `mla_apply` in float32: within 1e-5 of
    each largest magnitude (`mla_apply` observed 8.3e-7); in bf16 within
    3e-2, one bf16 rounding at the largest magnitude, as GQA's (observed
    4.4e-3).
  * the streamed attention at T = 2048, q/k head 24 and v head 16: float32
    within 2e-6 and bf16 within 4e-3 of each largest magnitude, the
    standard `tests/test_torch_models.py` holds GQA's streamed form to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import registry as ref_registry
from repro.models.common import split_axes

from repro_torch.compress import prng
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import attention as port_attn
from repro_torch.models import registry as port_registry
from repro_torch.models.common import split_axes as split_axes_t

CPU = torch.device("cpu")
ARCH = "deepseek-v2-236b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
STREAMED_RTOL = {"float32": 2e-6, "bfloat16": 4e-3}


def _configs(dtype):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(ref_registry.get_config(ARCH, "smoke"),
                                dtype=jdt),
            dataclasses.replace(port_registry.get_config(ARCH, "smoke"),
                                dtype=tdt))


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    return float(np.abs(b.float().numpy() - a).max()
                 / max(np.abs(a).max(), 1e-30))


def _case(dtype, seed=2, S=48):
    cfg_r, cfg_t = _configs(dtype)
    prm_r, _ = split_axes(ref_attn.mla_init(jax.random.PRNGKey(seed), cfg_r))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, cfg_r.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S), (2, S))
    prm_t = lm_params_from_reference(jax.tree.map(np.asarray, prm_r),
                                     device=CPU)
    return cfg_r, cfg_t, prm_r, prm_t, x, positions, rng


def test_mla_init_is_the_reference_bits():
    cfg_r, cfg_t = _configs("bfloat16")
    for seed in (0, 5):
        ref, ref_axes = split_axes(ref_attn.mla_init(
            jax.random.PRNGKey(seed), cfg_r))
        got, axes = split_axes_t(port_attn.mla_init(prng.key(seed), cfg_t))
        assert sorted(got) == sorted(ref)
        for name, leaf in ref.items():
            a = np.asarray(leaf)
            mine = got[name]
            assert tuple(mine.shape) == a.shape and axes[name] == \
                ref_axes[name]
            if a.dtype == np.float32:
                np.testing.assert_array_equal(mine.numpy(), a)
            else:
                np.testing.assert_array_equal(
                    mine.view(torch.uint16).numpy(), a.view(np.uint16))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_latent_and_rope_halves_match_reference(dtype):
    cfg_r, cfg_t, prm_r, prm_t, x, positions, _ = _case(dtype)
    jdt, tdt = DTYPES[dtype]
    xr, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    pr, pt = jnp.asarray(positions), torch.from_numpy(positions.copy())
    want = (*ref_attn._mla_q(prm_r, xr, cfg_r, pr),
            *ref_attn._mla_kv_latent(prm_r, xr, cfg_r, pr))
    got = (*port_attn._mla_q(prm_t, xt, cfg_t, pt),
           *port_attn._mla_kv_latent(prm_t, xt, cfg_t, pt))
    for name, a, b in zip(("q_nope", "q_rope", "c_kv", "k_rope"), want,
                          got):
        assert tuple(b.shape) == a.shape and b.dtype == tdt, name
        assert _rel(a, b) <= TOL[dtype], (name, _rel(a, b))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_apply_matches_reference(dtype):
    """Forward and the gradients of every parameter and of x. The scores
    take the scale 1/sqrt(nope + rope) (1/sqrt(24) at the smoke width);
    1/sqrt(16) puts the output 7.5e-2 of its magnitude off."""
    cfg_r, cfg_t, prm_r, prm_t, x, positions, rng = _case(dtype)
    jdt, tdt = DTYPES[dtype]
    g = rng.normal(size=x.shape).astype(np.float32)

    def fwd_bwd(p, xx, gg):
        out, vjp = jax.vjp(lambda p_, x_: ref_attn.mla_apply(
            p_, x_, cfg_r, jnp.asarray(positions)), p, xx)
        return (out,) + vjp(gg)
    out_r, dprm_r, dx_r = jax.jit(fwd_bwd)(prm_r, jnp.asarray(x, jdt),
                                           jnp.asarray(g, jdt))
    leaves = list(prm_t.values())
    for t in leaves:
        t.requires_grad_()
    x_t = torch.from_numpy(x).to(tdt).requires_grad_()
    out_t = port_attn.mla_apply(prm_t, x_t, cfg_t,
                                torch.from_numpy(positions.copy()))
    grads = torch.autograd.grad(out_t, leaves + [x_t],
                                torch.from_numpy(g).to(tdt))
    assert out_t.dtype == tdt and tuple(out_t.shape) == x.shape
    assert _rel(out_r, out_t.detach()) <= TOL[dtype]
    assert _rel(dx_r, grads[-1]) <= TOL[dtype]
    for name, mine in zip(prm_t, grads[:-1]):
        assert _rel(dprm_r[name], mine) <= TOL[dtype], (
            name, _rel(dprm_r[name], mine))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_streamed_attention_with_a_narrower_value_head(dtype):
    """`_sdpa_causal_streamed` at T = 2048 (two KV chunks) with q, k of
    head 24 and v of head 16, MLA's shape of heads (nope + rope against
    v): the output and the q, k, v gradients against the reference's."""
    B, S, H, hd, v_hd = 1, 2048, 2, 24, 16
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32)
                  for shape in ((B, S, H, hd), (B, S, H, hd),
                                (B, S, H, v_hd), (B, S, H, v_hd)))
    jdt, tdt = DTYPES[dtype]
    out_r, vjp = jax.vjp(ref_attn._sdpa_causal_streamed,
                         *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = [out_r, *vjp(jnp.asarray(g, jdt))]
    qkv = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out_t = port_attn._sdpa_causal(*qkv)
    got = [out_t.detach(), *torch.autograd.grad(
        out_t, qkv, torch.from_numpy(g).to(tdt))]
    for name, a, b in zip(("out", "dq", "dk", "dv"), want, got):
        assert b.dtype == tdt and tuple(b.shape) == a.shape
        assert _rel(a, b) <= STREAMED_RTOL[dtype], (name, _rel(a, b))
