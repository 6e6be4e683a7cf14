"""Feed-forward blocks, the port of `repro.models.mlp`: the dense FFN
(SwiGLU / squared-ReLU / GELU; `mlp_init`, `_ffn`, `mlp_apply`) and the
Mixture-of-Experts FFN with shared experts and top-k token-choice routing
(`moe_init`, `_dispatch_indices`, `_moe_grouped`, `moe_apply`,
`moe_aux_loss`). The reference's sequence-parallel and Megatron TP splits
(`cfg.mlp_tp`) and its expert and data sharding constraints are sharding
choices of one function; on one card each is this.

MoE dispatch is the reference's sort-based fixed-capacity scheme: flatten
the token assignments (token-major, `n * K + k`), sort them stably by
expert id, give each its slot inside its expert's segment, and send those
past the capacity to one overflow slot `E * C`, which is dropped. An
inverse slot map gathers each expert's (C, D) input; the combine gathers
each assignment's output back and sums them in float32, one k at a time,
in order. The router runs in float32 and picks its top K by a stable sort,
so ties go to the lower expert, as `lax.top_k` does. The expert einsums
are plain torch matmuls (batched over experts), as the reference computes
them outside any Pallas kernel.

On the card the dispatch gather's backward adds a token's gradients from
its K slots with atomics, in an order that may vary from run to run (the
reference's XLA scatter-add has its own order); the combine is a gather
whose backward does the same for the expert outputs.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.compress import prng
from repro_torch.compress.base import _top_indices
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


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def moe_init(key: prng.Key, cfg: ModelConfig) -> PyTree:
    ks = prng.split(key, 6)
    D, E = cfg.d_model, cfg.moe_experts
    F = cfg.moe_d_ff or cfg.d_ff
    prm = {
        "norm": pz((D,), ("embed",), torch.float32, device=key[0].device),
        "router": p(ks[0], (D, E), ("embed", "experts"), torch.float32),
        "w_up": p(ks[1], (E, D, F), ("experts", "embed", "expert_mlp"),
                  cfg.dtype),
        "w_gate": p(ks[2], (E, D, F), ("experts", "embed", "expert_mlp"),
                    cfg.dtype),
        "w_down": p(ks[3], (E, F, D), ("experts", "expert_mlp", "embed"),
                    cfg.dtype),
    }
    if cfg.moe_shared > 0:
        prm["shared"] = mlp_init(ks[4], cfg,
                                 d_ff=(cfg.moe_d_ff or cfg.d_ff)
                                 * cfg.moe_shared)
        del prm["shared"]["norm"]  # shares the block norm
    return prm


def _dispatch_indices(expert_ids: torch.Tensor, num_experts: int,
                      capacity: int) -> torch.Tensor:
    """Sort-based slotting of the flat assignments `expert_ids` (..., A),
    each row on its own (the reference's is one row, vmapped over groups).

    Returns each assignment's destination in [0, E*C]: its expert's slot
    `id * C + position in the expert's segment`, or the overflow slot
    E*C past the capacity. The sort is stable, so within an expert the
    earlier assignments take the slots and the later ones are dropped."""
    A = expert_ids.shape[-1]
    ids = expert_ids.long()
    sort_idx = torch.argsort(ids, dim=-1, stable=True)
    sorted_ids = torch.gather(ids, -1, sort_idx)
    experts = torch.arange(num_experts, device=ids.device).expand(
        ids.shape[:-1] + (num_experts,)).contiguous()
    seg_starts = torch.searchsorted(sorted_ids, experts)       # left side
    pos = (torch.arange(A, device=ids.device)
           - torch.gather(seg_starts, -1, sorted_ids))
    dest_sorted = torch.where(pos < capacity, sorted_ids * capacity + pos,
                              num_experts * capacity)
    return torch.empty_like(dest_sorted).scatter_(-1, sort_idx, dest_sorted)


def _route(tokens: torch.Tensor, router: torch.Tensor, top_k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates, ids), each (G, Nl, K): the router in float32, its softmax,
    the top K by a stable descending sort (ties to the lower expert, as
    `lax.top_k`), the picked probabilities renormalized to sum to 1."""
    logits = torch.einsum("gnd,de->gne", tokens.float(), router)
    probs = torch.softmax(logits, dim=-1)
    ids = _top_indices(probs.detach(), top_k)
    gates = torch.gather(probs, -1, ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids


def _moe_grouped(tokens, router, w_up, w_gate, w_down, cfg: ModelConfig,
                 capacity: int):
    """Route and run experts for G dispatch groups. tokens: (G, Nl, D).

    Dispatch is a gather: a 1-D index scatter per group builds the inverse
    map slot -> source assignment (every real slot is written exactly
    once; the drops all land in the overflow slot, which is sliced away),
    then the (G, E, C, D) expert inputs are gathered from the tokens."""
    G, Nl, D = tokens.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    C = capacity
    A = Nl * K
    gates, ids = _route(tokens, router, K)
    dest = _dispatch_indices(ids.reshape(G, A), E, C)          # (G, A)
    # inverse map per group: which assignment fills expert slot s
    slot_src = torch.full((G, E * C + 1), A, dtype=torch.int64,
                          device=tokens.device)
    slot_src.scatter_(1, dest, torch.arange(A, device=tokens.device)
                      .expand(G, A))
    slot_src = slot_src[:, :E * C]                             # (G, E*C)
    slot_valid = slot_src < A
    token_src = torch.where(slot_valid, slot_src // K, 0)
    expert_in = torch.gather(tokens, 1,
                             token_src[..., None].expand(G, E * C, D))
    expert_in = expert_in.masked_fill(~slot_valid[..., None], 0)
    expert_in = expert_in.reshape(G, E, C, D)

    up = torch.einsum("gecd,edf->gecf", expert_in, w_up)
    gate = torch.einsum("gecd,edf->gecf", expert_in, w_gate)
    act = torch.nn.functional.silu(gate) * up
    expert_out = torch.einsum("gecf,efd->gecd", act, w_down)

    flat_out = torch.cat([expert_out.reshape(G, E * C, D),
                          expert_out.new_zeros((G, 1, D))], dim=1)
    slots = dest.reshape(G, Nl, K)
    out = torch.zeros((G, Nl, D), dtype=torch.float32, device=tokens.device)
    for k in range(K):  # accumulate per assignment; no (G,Nl,K,D) tensor
        picked = torch.gather(flat_out, 1,
                              slots[:, :, k, None].expand(G, Nl, D))
        out = out + picked.float() * gates[:, :, k:k + 1]
    return out.to(tokens.dtype)


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """C = max(1, ceil(top_k * tokens_per_group * cf / E)), in the
    reference's arithmetic: `-(-K * Nl * cf // E)` on a Python float."""
    E, K = cfg.moe_experts, cfg.moe_top_k
    return max(1, int(-(-K * tokens_per_group * cfg.moe_capacity_factor
                        // E)))


def moe_apply(prm, x, cfg: ModelConfig, groups: int = 1) -> torch.Tensor:
    """Token-choice top-k MoE with fixed capacity and optional shared
    experts. x: (B,S,D). `groups` partitions the tokens into independent
    dispatch groups, each with its own capacity buffer (the reference's
    launcher sets it to the data-axis size; 1 when the tokens do not
    divide evenly)."""
    B, S, D = x.shape
    h = rms_norm(x, prm["norm"])
    N = B * S
    G = groups if N % groups == 0 else 1
    Nl = N // G
    combined = _moe_grouped(h.reshape(G, Nl, D), prm["router"], prm["w_up"],
                            prm["w_gate"], prm["w_down"], cfg,
                            moe_capacity(cfg, Nl))
    out = combined.reshape(B, S, D)
    if "shared" in prm:
        out = out + _ffn(prm["shared"], h, cfg)
    return out


def moe_aux_loss(prm, x, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e,
    f_e the share of tokens whose top-1 expert is e (argmax: the first of
    ties) and p_e the mean router probability."""
    B, S, D = x.shape
    h = rms_norm(x, prm["norm"]).reshape(B * S, D)
    logits = torch.einsum("nd,de->ne", h.float(), prm["router"])
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(torch.nn.functional.one_hot(
        top1, cfg.moe_experts).float(), dim=0)
    prob = torch.mean(probs, dim=0)
    return cfg.moe_experts * torch.sum(frac * prob)
