"""Recording the router's top-K choices of both packages' MoE calls, for the
tests that count the choices that differ between them.

The reference's choices are reported from inside its jitted program by a
debug callback around `repro.models.mlp._moe_grouped`; the port's are read
where `repro_torch.models.mlp._route` takes them, `_top_indices`, which a
test may also have return given choices in place of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import mlp as ref_mlp

from repro_torch.models import mlp as port_mlp


def record_reference_choices(monkeypatch) -> list:
    """A list that gets each reference MoE call's (G, Nl, K) choices, in
    call order (a remat's recompute calls again)."""
    calls = []
    real = ref_mlp._moe_grouped

    def wrapped(tokens, router, *args, **kw):
        logits = jnp.einsum("gnd,de->gne", tokens.astype(jnp.float32),
                            router)
        ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                            args[3].moe_top_k)[1]
        jax.debug.callback(lambda i: calls.append(np.asarray(i)), ids,
                           ordered=True)
        return real(tokens, router, *args, **kw)
    monkeypatch.setattr(ref_mlp, "_moe_grouped", wrapped)
    return calls


def record_port_choices(monkeypatch, substitute=None) -> list:
    """A list that gets each port MoE call's own choices, in call order.
    With `substitute` (a list of arrays), call i routes by substitute[i]
    instead."""
    calls = []
    real = port_mlp._top_indices

    def top(probs, k):
        ids = real(probs, k)
        calls.append(ids.cpu().numpy())
        if substitute is None:
            return ids
        return torch.from_numpy(substitute[len(calls) - 1].astype(np.int64))
    monkeypatch.setattr(port_mlp, "_top_indices", top)
    return calls
