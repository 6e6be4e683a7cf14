"""The port's whole-model inference against the JAX package's, on the CPU:
`decode_step` of all ten smoke archs over several steps (logits and the
whole returned cache) against the reference's jitted one; the
reference's own decode gate, `tests/test_models.py::
test_decode_matches_forward`, run on the port; `make_prefill_step` and
`make_serve_step` against the reference's; and a greedy decode as
`tests/test_system.py` runs it, with the cache donated.

Standards (ROADMAP queue 3 gives the residues):
  * `decode_step` in float32 from a cache the reference left, carried
    across: logits and every cache leaf within `F32_TOL` = 1e-5 of its
    largest magnitude (observed at most 1.6e-6, deepseek-v2's logits).
    The MoE archs route a decode step's B tokens with the capacity those
    B tokens give on both sides.
  * the reference's gate (bf16 weights, a float32 cache; decode against
    the teacher-forced forward): its own tolerance, atol 0.13 and rtol
    0.1 (observed at most 0.065, deepseek-v2), and its drop-free MoE
    capacity. In float32 the same comparison within `F32_TOL` of the
    logits' largest magnitude (observed at most 1.1e-6).
  * the prefill and serve steps in float32: within `F32_TOL`; the greedy
    decode's tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as ref_steps
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf

from repro_torch.compress import prng
from repro_torch.launch import steps as port_steps
from repro_torch.models import transformer as port_tf

from _decode import one_torch_thread  # noqa: F401 (autouse)
from _decode import (B, CPU, assert_trees_close, carry, configs,
                     fill_cross_port, fill_cross_reference, model, rel)

F32_TOL = 1e-5
MAX_SEQ = 8


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_decode_step_matches_reference(arch):
    """T = 5 float32 steps from a cache the reference left after two steps,
    carried across: logits and the whole cache after each step."""
    cfg_r, cfg_t, params, params_t = model(arch, "float32")
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg_r.vocab_size, (B, 7)).astype(np.int32)
    cache = ref_tf.init_cache(cfg_r, B, MAX_SEQ, jnp.float32)
    if cfg_r.family == "vlm":
        enc = rng.normal(size=(B, cfg_r.num_encoder_tokens,
                               cfg_r.encoder_dim)).astype(np.float32)
        cache = fill_cross_reference(cache, params, cfg_r, jnp.asarray(enc))
    step = jax.jit(lambda p_, c_, t_, pos: ref_tf.decode_step(p_, c_, t_,
                                                              pos, cfg_r))
    for pos in range(2):
        _, cache = step(params, cache, jnp.asarray(tokens[:, pos:pos + 1]),
                        jnp.int32(pos))
    cache_t = carry(cache)
    worst = 0.0
    for pos in range(2, 7):
        tok = tokens[:, pos:pos + 1]
        logits, cache = step(params, cache, jnp.asarray(tok), jnp.int32(pos))
        with torch.no_grad():
            logits_t, out = port_tf.decode_step(
                params_t, cache_t, torch.from_numpy(tok), pos, cfg_t)
        assert out is cache_t
        worst = max(worst, rel(logits, logits_t),
                    assert_trees_close(cache, cache_t, F32_TOL, arch))
    assert worst <= F32_TOL, worst


GATE_ARCHS = ["llama3-8b", "deepseek-v2-236b", "falcon-mamba-7b",
              "zamba2-2.7b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", GATE_ARCHS)
def test_decode_matches_forward(arch, dtype):
    """The reference's gate on the port: token-by-token decode reproduces
    the teacher-forced forward's logits, over every cache kind (GQA, MLA,
    conv and SSM states, cross-attention, shared attention). The
    reference's parameters (the port's init draws the same bits), tokens
    and encoder states; a float32 cache; the cross-attention cache filled
    by the reference's helper. bf16 is the reference's case and
    tolerance; float32 is held tight."""
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float32": (jnp.float32, torch.float32)}[dtype]
    cfg_r, cfg = configs(arch, jdt, tdt)
    if cfg.moe_experts:
        # capacity-dropping differs between batch prefill and per-token
        # decode by design; a drop-free capacity for the equivalence
        _, cfg = configs(arch, jdt, tdt,
                         moe_capacity_factor=float(cfg.moe_experts))
    key = jax.random.PRNGKey(0)
    params, _ = port_tf.init(prng.key(0, CPU), cfg)
    S = 8
    tokens = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(7), (B, S), 0, cfg.vocab_size)))
    enc = None
    if cfg.family == "vlm":
        enc = carry(jax.random.normal(
            key, (B, cfg.num_encoder_tokens, cfg.encoder_dim)).astype(jdt))
    with torch.no_grad():
        full = port_tf.forward(params, tokens, cfg, enc=enc).float()
        cache = port_tf.init_cache(cfg, B, S, torch.float32, device=CPU)
        if enc is not None:
            fill_cross_port(cache, params, cfg, enc)
        outs = []
        for pos in range(S):
            logits, cache = port_tf.decode_step(
                params, cache, tokens[:, pos:pos + 1], pos, cfg)
            outs.append(logits[:, 0].float())
    dec = torch.stack(outs, dim=1)
    if dtype == "bfloat16":
        np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=0.13,
                                   rtol=0.1)
    else:
        assert rel(full, dec) <= F32_TOL


def _vision_batch(cfg_r, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg_r.vocab_size, (B, S)).astype(np.int32)
    enc = rng.normal(size=(B, cfg_r.num_encoder_tokens,
                           cfg_r.encoder_dim)).astype(np.float32)
    return tokens, enc


@pytest.mark.parametrize("arch,moe_groups", [
    ("llama-3.2-vision-90b", 1), ("llama4-maverick-400b-a17b", 2)])
def test_prefill_and_serve_steps_match_reference(arch, moe_groups):
    """`make_prefill_step` (the last position's logits, with `enc` in the
    batch for the VLM) and `make_serve_step` (one decode step, the cache
    overwritten and returned), each against the reference's jitted step,
    in float32 with `moe_groups` threaded through."""
    cfg_r, cfg_t, params, params_t = model(arch, "float32", seed=2)
    tokens, enc = _vision_batch(cfg_r, 8, 12)
    batch = {"tokens": tokens}
    if cfg_r.family == "vlm":
        batch["enc"] = enc
    ref = jax.jit(ref_steps.make_prefill_step(cfg_r, moe_groups))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ours = port_steps.make_prefill_step(cfg_t, moe_groups)(
        params_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(ours.shape) == (B, cfg_r.vocab_size)
    assert not ours.requires_grad
    assert rel(ref, ours) <= F32_TOL

    cache = ref_tf.init_cache(cfg_r, B, MAX_SEQ, jnp.float32)
    if cfg_r.family == "vlm":
        cache = fill_cross_reference(cache, params, cfg_r, jnp.asarray(enc))
    cache_t = carry(cache)
    serve = jax.jit(ref_steps.make_serve_step(cfg_r, moe_groups))
    serve_t = port_steps.make_serve_step(cfg_t, moe_groups)
    for pos in range(3):
        tok = tokens[:, pos:pos + 1]
        logits, cache = serve(params, cache, jnp.asarray(tok),
                              jnp.int32(pos))
        logits_t, out = serve_t(params_t, cache_t, torch.from_numpy(tok),
                                torch.tensor(pos, dtype=torch.int32))
        assert out is cache_t
        assert rel(logits, logits_t) <= F32_TOL
        assert_trees_close(cache, cache_t, F32_TOL, arch)


def test_greedy_decode_matches_reference():
    """`tests/test_system.py`'s greedy decode (llama3-8b smoke, 8 steps, the
    reference's serve step jitted with its cache donated) against the
    port's serve step, in float32: each step's argmax tokens equal."""
    cfg_r, cfg_t, params, params_t = model("llama3-8b", "float32", seed=4)
    serve = jax.jit(ref_steps.make_serve_step(cfg_r), donate_argnums=(1,))
    serve_t = port_steps.make_serve_step(cfg_t)
    cache = ref_tf.init_cache(cfg_r, B, 8, jnp.float32)
    cache_t = port_tf.init_cache(cfg_t, B, 8, torch.float32, device=CPU)
    tok = jnp.zeros((B, 1), jnp.int32)
    tok_t = torch.zeros((B, 1), dtype=torch.int32)
    picked = []
    for pos in range(8):
        logits, cache = serve(params, cache, tok, jnp.int32(pos))
        logits_t, cache_t = serve_t(params_t, cache_t, tok_t, pos)
        assert rel(logits, logits_t) <= F32_TOL
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
            jnp.int32)
        tok_t = torch.argmax(logits_t[:, -1, :], dim=-1)[:, None].to(
            torch.int32)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok))
        picked.append(np.asarray(tok)[:, 0].tolist())
    assert tuple(logits_t.shape) == (B, 1, cfg_r.vocab_size)
    # the decode is not stuck on one token
    assert len({t for step in picked for t in step}) > 1
