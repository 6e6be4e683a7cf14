"""The dense feed-forward block (SwiGLU / squared-ReLU / GELU), the port of
`repro.models.mlp`'s `mlp_init`, `_ffn` and `mlp_apply`. The reference's
sequence-parallel and Megatron TP splits (`cfg.mlp_tp`) are sharding
choices of one function; on one card both are this. The Mixture-of-Experts
FFN comes with a later slice.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.compress import prng
from repro_torch.models.common import ModelConfig, p, pz, rms_norm

PyTree = Any


def mlp_init(key: prng.Key, cfg: ModelConfig, d_ff: int | None = None
             ) -> PyTree:
    ks = prng.split(key, 4)
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    prm = {
        "norm": pz((D,), ("embed",), torch.float32, device=key[0].device),
        "w_up": p(ks[0], (D, F), ("embed", "mlp"), cfg.dtype),
        "w_down": p(ks[1], (F, D), ("mlp", "embed"), cfg.dtype),
    }
    if cfg.mlp_act == "swiglu":
        prm["w_gate"] = p(ks[2], (D, F), ("embed", "mlp"), cfg.dtype)
    return prm


def _ffn(prm, h, cfg: ModelConfig):
    up = torch.einsum("bsd,df->bsf", h, prm["w_up"])
    if cfg.mlp_act == "swiglu":
        gate = torch.einsum("bsd,df->bsf", h, prm["w_gate"])
        act = torch.nn.functional.silu(gate) * up
    elif cfg.mlp_act == "squared_relu":
        r = torch.clamp(up, min=0.0)
        act = r * r
    else:
        act = torch.nn.functional.gelu(up, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", act, prm["w_down"])


def mlp_apply(prm, x, cfg: ModelConfig, d_ff: int | None = None
              ) -> torch.Tensor:
    h = rms_norm(x, prm["norm"])
    return _ffn(prm, h, cfg)
