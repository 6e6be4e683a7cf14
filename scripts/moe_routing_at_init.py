"""How deepseek-v2's router spreads tokens over its experts at random init,
in the JAX package and in the port, on the CPU.

    PYTHONPATH=src python3 scripts/moe_routing_at_init.py [--seq 1024]

Builds deepseek-v2 at its published widths up to its first MoE router
(d_model 5120, 128 heads, MLA, the dense prologue layer, 160 routed experts
at top-6, bf16) with `n_super` cut to 1, the vocabulary to 4,096 rows and
the expert FFN to 16 columns: neither reaches the router's input (every
embedding row is drawn from the same N(0, 1)), and they keep the CPU's
memory small. Draws the reference's parameters from seed 0, carries them
into the port (`convert.lm_params_from_reference`), runs one forward of
each package on the same `--seq` random tokens, and prints one JSON line a
package: the ten largest expert loads of the first MoE call, the capacity
C = ceil(6 seq 1.25 / 160), the assignments past it (dropped), and the
mean cosine similarity between the router's input tokens. It imports both
packages, as the tests do; it is not part of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import mlp as ref_mlp
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf

from repro_torch.convert import lm_params_from_reference
from repro_torch.models import mlp as port_mlp
from repro_torch.models import registry as port_registry
from repro_torch.models import transformer as port_tf

CUT = dict(n_super=1, vocab_size=4096, moe_d_ff=16)


def _report(package: str, ids: np.ndarray, tokens: np.ndarray, cfg) -> dict:
    counts = np.bincount(ids.reshape(-1), minlength=cfg.moe_experts)
    n = tokens.shape[0]
    cap = max(1, int(-(-cfg.moe_top_k * n * cfg.moe_capacity_factor
                       // cfg.moe_experts)))
    unit = tokens / np.linalg.norm(tokens, axis=-1, keepdims=True)
    return {"package": package, "seq": n, "capacity": cap,
            "largest_loads": sorted(counts.tolist(), reverse=True)[:10],
            "dropped": int(np.clip(counts - cap, 0, None).sum()),
            "assignments": int(ids.size),
            "mean_token_cosine": float((unit @ unit.T).mean())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()
    cfg_r = dataclasses.replace(
        ref_registry.get_config("deepseek-v2-236b", "full"), **CUT)
    cfg_t = dataclasses.replace(
        port_registry.get_config("deepseek-v2-236b", "full"), **CUT)
    params_r = jax.jit(lambda k: ref_tf.init(k, cfg_r)[0])(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg_r.vocab_size, (1, args.seq)).astype(np.int32)

    seen = {}
    real_ref = ref_mlp._moe_grouped

    def ref_grouped(toks, router, *a, **kw):
        logits = jnp.einsum("gnd,de->gne", toks.astype(jnp.float32), router)
        ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                            cfg_r.moe_top_k)[1]
        jax.debug.callback(lambda i, t: seen.setdefault(
            "reference", (np.asarray(i), np.asarray(t))), ids,
            toks.astype(jnp.float32))
        return real_ref(toks, router, *a, **kw)
    ref_mlp._moe_grouped = ref_grouped
    jax.jit(ref_tf.forward, static_argnums=2)(params_r, jnp.asarray(tokens),
                                             cfg_r)
    jax.effects_barrier()

    real_port = port_mlp._moe_grouped

    def port_grouped(toks, router, *a, **kw):
        _, ids = port_mlp._route(toks, router, cfg_t.moe_top_k)
        seen.setdefault("port", (ids.numpy(), toks.float().numpy()))
        return real_port(toks, router, *a, **kw)
    port_mlp._moe_grouped = port_grouped
    params_t = lm_params_from_reference(jax.tree.map(np.asarray, params_r),
                                        device="cpu")
    del params_r
    with torch.no_grad():
        port_tf.forward(params_t, torch.from_numpy(tokens), cfg_t)
    for package in ("reference", "port"):
        ids, toks = seen[package]
        print(json.dumps(_report(package, ids, toks[0], cfg_t)), flush=True)


if __name__ == "__main__":
    main()
