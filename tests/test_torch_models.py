"""The port's LM model stack against the JAX package's, on the CPU:
jax's random bits (`split`, `uniform` with bounds, `truncated_normal`), the
model init from a seed, the registry's configs, one forward, loss and
gradient in float32 and in bf16 (the dense family; the MoE and MLA
families are `tests/test_torch_moe.py` and `tests/test_torch_mla.py`),
and the refusal of block kinds that are not ported yet.

Standards (PERF.md and ROADMAP queue 3 give the observed errors):
  * `split` and bounded `uniform`: bits equal.
  * `truncated_normal`: XLA's CPU `log1p` (inside `erf_inv`) is not
    torch's; the float32 draws differ at 0.94% of elements, by at most 3
    ulps (2.4e-7), and after the bf16 cast of a weight init at 1 element
    of 4,194,304 (seed 7), 0 at seed 0: pinned below.
  * the smoke init: bits equal (0 differences), seeds 0 and 1.
  * one forward/loss/gradient in float32: loss within rtol 1e-5, each
    gradient leaf within 1e-5 of its largest magnitude (observed 0 and
    1e-6).
  * in bf16: loss within rtol 1e-4, each gradient leaf within 3e-2 of its
    largest magnitude (observed 1.7e-6 and 1.13e-2: XLA keeps some
    intermediates in float32 where the port rounds to bf16).
  * the streamed attention (online softmax over 1024-key chunks, which
    the full-width cell's S = 4096 takes) at T = 2048 against the
    reference's: the output and the gradients of q, k and v each within
    `STREAMED_RTOL` of its largest magnitude, float32 2e-6 (observed
    1.5e-7 to 8.2e-7) and bf16 4e-3, one bf16 rounding at the largest
    magnitude (observed 9.0e-5 to 6.9e-4); a mask one key off or a
    dropped rescale is 0.17-1.1.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.specs import params_and_axes
from repro.models import attention as ref_attn
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf

from repro_torch.compress import prng
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import steps as port_steps
from repro_torch.models import attention as port_attn
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf

CPU = torch.device("cpu")
#: the dense family's activations and options: SwiGLU, squared ReLU,
#: SwiGLU with QKV biases, GELU (tanh-approximate, musicgen's) and the
#: three-superblock qwen1.5-110b smoke
DENSE_ARCHS = ("llama3-8b", "nemotron-4-15b", "codeqwen1.5-7b",
               "musicgen-medium", "qwen1.5-110b")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy().view(np.uint32)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("seed", [0, 3])
def test_split_and_bounded_uniform_are_jax_bits(seed):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.split(key, 7))
    got = prng.split(prng.key(seed), 7)
    assert [(int(a), int(b)) for a, b in got] == [tuple(r) for r in ref]
    shape = (3, 1000)
    ref_u = np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                          -0.9545, 0.9545))
    port_u = prng.uniform(prng.key(seed), shape, -0.9545, 0.9545)
    np.testing.assert_array_equal(_tbits(port_u), _bits(ref_u))
    np.testing.assert_array_equal(
        _tbits(prng.uniform(prng.key(seed), shape)),
        _bits(jax.random.uniform(key, shape, jnp.float32)))
    k2 = prng.fold_in(prng.key(seed), 1003)
    ref_k2 = np.asarray(jax.random.fold_in(key, 1003))
    assert (int(k2[0]), int(k2[1])) == tuple(ref_k2)


@pytest.mark.parametrize("seed,bf16_diffs", [(0, 0), (7, 1)])
def test_truncated_normal_residue_is_pinned(seed, bf16_diffs):
    n = 1 << 22
    scale = 1.0 / math.sqrt(128)
    ref = jax.jit(lambda k: jax.random.truncated_normal(
        k, -2.0, 2.0, (n,), jnp.float32))(jax.random.PRNGKey(seed))
    got = prng.truncated_normal(prng.key(seed), -2.0, 2.0, (n,))
    ulps = np.abs(_tbits(got).astype(np.int64)
                  - _bits(ref).astype(np.int64))
    assert ulps.max() <= 3
    assert 0.009 < (ulps > 0).mean() < 0.0096
    ref_bf16 = np.asarray((scale * ref).astype(jnp.bfloat16))
    got_bf16 = prng.truncated_normal(prng.key(seed), -2.0, 2.0, (n,),
                                     scale=scale, out_dtype=torch.bfloat16)
    assert int((_tbits(got_bf16) != _bits(ref_bf16)).sum()) == bf16_diffs


@pytest.mark.parametrize("seed", [0, 1])
def test_init_matches_reference_bit_for_bit(seed):
    cfg_r = ref_registry.get_config("llama3-8b", "smoke")
    cfg_t = port_registry.get_config("llama3-8b", "smoke")
    ref = jax.jit(lambda k: ref_tf.init(k, cfg_r)[0])(
        jax.random.PRNGKey(seed))
    ref_axes = params_and_axes(cfg_r)[1]
    got, axes = port_tf.init(prng.key(seed), cfg_t)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in leaves:
        mine = _leaf(got, path)
        assert mine.dtype == {jnp.bfloat16: torch.bfloat16,
                              jnp.float32: torch.float32}[leaf.dtype.type]
        np.testing.assert_array_equal(_tbits(mine), _bits(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    flat_axes = jax.tree_util.tree_leaves_with_path(
        ref_axes, is_leaf=lambda x: isinstance(x, tuple))
    for path, ax in flat_axes:
        assert _leaf(axes, path) == ax


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_registry_configs_are_the_reference_data(arch):
    assert port_registry.ARCH_IDS == ref_registry.ARCH_IDS
    for variant in ("full", "smoke"):
        ref = dataclasses.asdict(ref_registry.get_config(arch, variant))
        port = dataclasses.asdict(port_registry.get_config(arch, variant))
        assert str(ref.pop("dtype")) == "<class 'jax.numpy.bfloat16'>"
        assert port.pop("dtype") == torch.bfloat16
        assert port == ref
    shapes = {k: dataclasses.asdict(v)
              for k, v in port_registry.get_shapes(arch).items()}
    assert shapes == {k: dataclasses.asdict(v)
                      for k, v in ref_registry.get_shapes(arch).items()}


def _loss_and_grads(arch, dtype_r, dtype_t, seed=1):
    cfg_r = dataclasses.replace(ref_registry.get_config(arch, "smoke"),
                                dtype=dtype_r)
    cfg_t = dataclasses.replace(port_registry.get_config(arch, "smoke"),
                                dtype=dtype_t)
    params_r, _ = ref_tf.init(jax.random.PRNGKey(seed), cfg_r)
    toks = np.random.default_rng(seed).integers(
        0, cfg_r.vocab_size, (2, 65)).astype(np.int32)
    batch_r = {"tokens": jnp.asarray(toks[:, :-1]),
               "labels": jnp.asarray(toks[:, 1:])}
    loss_r, grads_r = jax.jit(jax.value_and_grad(ref_tf.loss_fn),
                              static_argnums=2)(params_r, batch_r, cfg_r)
    params_t = lm_params_from_reference(jax.tree.map(np.asarray, params_r),
                                        device=CPU)
    batch_t = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
               "labels": torch.from_numpy(toks[:, 1:].copy())}
    loss_t, grads_t = port_steps.grad_fn(params_t, batch_t, cfg_t)
    errs = {}
    for path, g in jax.tree_util.tree_leaves_with_path(grads_r):
        mine = _leaf(grads_t, path)
        g = np.asarray(g, dtype=np.float32)
        errs[jax.tree_util.keystr(path)] = float(
            np.abs(mine.float().numpy() - g).max() / np.abs(g).max())
    return float(loss_r), float(loss_t), errs


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_loss_grad_float32(arch):
    loss_r, loss_t, errs = _loss_and_grads(arch, jnp.float32, torch.float32)
    assert loss_t == pytest.approx(loss_r, rel=1e-5)
    assert max(errs.values()) < 1e-5, errs


def test_forward_loss_grad_bf16():
    loss_r, loss_t, errs = _loss_and_grads("llama3-8b", jnp.bfloat16,
                                           torch.bfloat16)
    assert loss_t == pytest.approx(loss_r, rel=1e-4)
    assert max(errs.values()) < 3e-2, errs


def test_forward_loss_grad_bf16_gelu():
    """musicgen-medium's tanh-approximate GELU, the dense family's one
    GELU path, in bf16 (observed loss 2.8e-5, gradients 1.0e-2 of their
    max), at llama3's bf16 standard."""
    loss_r, loss_t, errs = _loss_and_grads("musicgen-medium", jnp.bfloat16,
                                           torch.bfloat16)
    assert loss_t == pytest.approx(loss_r, rel=1e-4)
    assert max(errs.values()) < 3e-2, errs


def test_forward_matches_without_remat():
    """Checkpointing each repetition changes nothing computed."""
    cfg = port_registry.get_config("llama3-8b", "smoke")
    params, _ = port_tf.init(prng.key(2), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_a, g_a = port_steps.grad_fn(params, batch, cfg)
    loss_b, g_b = port_steps.grad_fn(
        params, batch, dataclasses.replace(cfg, remat=False))
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(jax.tree_util.tree_leaves(g_a),
                    jax.tree_util.tree_leaves(g_b)):
        assert torch.equal(a, b)


#: the streamed attention against the reference's (module docstring)
STREAMED_RTOL = {"float32": 2e-6, "bfloat16": 4e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_attention_matches_reference(dtype):
    """`_sdpa_causal_streamed` against the reference's at T = 2048 (two
    KV chunks, 4 heads over 2 KV heads): the output, and the gradients of
    q, k and v for one output cotangent. `_sdpa_causal` takes the streamed
    form there and the whole score matrix at T = 1024."""
    B, S, H, K, hd = 1, 2048, 4, 2, 16
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32)
                  for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                                (B, S, H, hd)))
    jdt = getattr(jnp, dtype)
    out_r, vjp = jax.vjp(ref_attn._sdpa_causal_streamed,
                         *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = [out_r, *vjp(jnp.asarray(g, jdt))]
    tdt = getattr(torch, dtype)
    qkv = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out_t = port_attn._sdpa_causal_streamed(*qkv)
    got = [out_t.detach(), *torch.autograd.grad(
        out_t, qkv, torch.from_numpy(g).to(tdt))]
    for name, a, b in zip(("out", "dq", "dk", "dv"), want, got):
        a = np.asarray(a, dtype=np.float32)
        assert b.dtype == tdt and tuple(b.shape) == a.shape
        rel = np.abs(b.float().numpy() - a).max() / np.abs(a).max()
        assert rel <= STREAMED_RTOL[dtype], (name, rel)
    with torch.no_grad():
        assert torch.equal(port_attn._sdpa_causal(*qkv), out_t)
        short = [t[:, :1024] for t in qkv]
        assert torch.equal(port_attn._sdpa_causal(*short),
                           port_attn._sdpa_causal_whole(*short))


@pytest.mark.parametrize("arch,kind", [
    ("falcon-mamba-7b", "mamba1"),
    ("zamba2-2.7b", "mamba2"),
    ("llama-3.2-vision-90b", "cross_attn"),
])
def test_unported_block_kind_raises_naming_it(arch, kind):
    cfg = port_registry.get_config(arch, "smoke")
    with pytest.raises(NotImplementedError, match=f"'{kind}'.*later slice"):
        port_tf.init(prng.key(0), cfg)
