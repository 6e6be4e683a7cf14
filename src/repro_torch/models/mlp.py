"""Feed-forward blocks, the port of `repro.models.mlp`: the dense FFN
(SwiGLU / squared-ReLU / GELU; `mlp_init`, `_ffn`, `mlp_apply`) and the
Mixture-of-Experts FFN with shared experts and top-k token-choice routing
(`moe_init`, `_dispatch_indices`, `_moe_grouped`, `moe_apply`,
`moe_aux_loss`). The dense FFN takes the reference's sequence-parallel
and Megatron TP layouts (`cfg.mlp_tp`) through `runtime.sharding.constrain`
when its tensors are DTensors (a sharded pod), its products on local
shards (`runtime.sharding.project`), and is unchanged on one device. So
does the MoE: its dispatch groups go over 'data' and its
experts over 'model' (the reference's constraints), the integer routing
and each rank's experts run on local shards (`_moe_grouped_sharded`), and
the output goes back to ("batch", "seq", "embed_act"). Inference's one
dispatch group (a decode step's) lies whole on every data rank; there the
experts' weights stay where they lie, their products' partial sums
all-reduced over 'data' (`_moe_one_group`).

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
reference's XLA scatter-add has its own order), unless torch's
deterministic algorithms are on; the combine is a gather whose backward
does the same for the expert outputs.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.compress import prng
from repro_torch.compress.base import _top_indices
from repro_torch.models.common import ModelConfig, p, pz, rms_norm
from repro_torch.runtime.sharding import (constrain, gather_axis, is_dtensor,
                                          project)

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


def _ffn(prm, h, cfg: ModelConfig, keep_weights: bool = False):
    # sequence-parallel by default (each rank runs the full d_ff for its
    # token shard), or, under cfg.mlp_tp, the Megatron split: d_ff over
    # 'model', the tokens gathered (the reference's two layouts); sharded,
    # the products run on local shards (`project`: a decode step's token,
    # keep_weights, meets the FFN's shards where they lie)
    tok_axes = (("batch", "seq", "embed_act") if cfg.mlp_tp
                else ("batch", "seq_sp", "embed_act"))
    act_axes = (("batch", "seq", "mlp") if cfg.mlp_tp
                else ("batch", "seq_sp", None))
    h = constrain(h, tok_axes)
    if cfg.mlp_act == "swiglu":
        up, gate = project("bsd,df->bsf", h, prm["w_up"], prm["w_gate"],
                           keep_weights=keep_weights)
        act = torch.nn.functional.silu(gate) * up
    else:
        up = project("bsd,df->bsf", h, prm["w_up"], keep_weights=keep_weights)
        if cfg.mlp_act == "squared_relu":
            r = torch.clamp(up, min=0.0)
            act = r * r
        else:
            act = torch.nn.functional.gelu(up, approximate="tanh")
    act = constrain(act, act_axes)
    return project("bsf,fd->bsd", act, prm["w_down"],
                   keep_weights=keep_weights)


def mlp_apply(prm, x, cfg: ModelConfig, d_ff: int | None = None,
              keep_weights: bool = False) -> torch.Tensor:
    h = rms_norm(x, prm["norm"])
    return constrain(_ffn(prm, h, cfg, keep_weights),
                     ("batch", "seq_sp", "embed_act"))


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
    return _top_gates(torch.einsum("gnd,de->gne", tokens.float(), router),
                      top_k)


def _top_gates(logits: torch.Tensor, top_k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """`_route` from the router's logits (G, Nl, E)."""
    probs = torch.softmax(logits, dim=-1)
    ids = _top_indices(probs.detach(), top_k)
    gates = torch.gather(probs, -1, ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids


def _moe_grouped(tokens, router, w_up, w_gate, w_down, cfg: ModelConfig,
                 capacity: int, keep_weights: bool = False):
    """Route and run experts for G dispatch groups. tokens: (G, Nl, D).

    Dispatch is a gather: a 1-D index scatter per group builds the inverse
    map slot -> source assignment (every real slot is written exactly
    once; the drops all land in the overflow slot, which is sliced away),
    then the (G, E, C, D) expert inputs are gathered from the tokens.
    DTensor tokens (a sharded pod) take `_moe_grouped_sharded`."""
    if is_dtensor(tokens):
        return _moe_grouped_sharded(tokens, router, w_up, w_gate, w_down,
                                    cfg, capacity, keep_weights)
    gates, ids = _route(tokens, router, cfg.moe_top_k)
    dest, expert_out = _dispatch_experts(tokens, ids, w_up, w_gate, w_down,
                                         cfg, capacity, 0)
    return _combine(expert_out, gates, dest, tokens.dtype)


def _dispatch_experts(tokens, ids, w_up, w_gate, w_down, cfg: ModelConfig,
                      capacity: int, first: int, d_shard=None):
    """(dest, expert_out): each assignment's slot (G, Nl*K), and the
    (G, El, C, D) outputs of the El experts `first`, `first + 1`, ... that
    `w_up` holds (all E on one device; a rank's own over 'model'), from
    their slots' tokens. With `d_shard` = (d0, reduce) the weights hold
    the model dims d0 .. d0 + Dl alone (a data shard): the up and gate
    products are float32 partial sums over those dims, summed by
    `reduce`, and the outputs are the (G, El, C, Dl) slice."""
    G, Nl, D = tokens.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    El, C = w_up.shape[0], capacity
    A = Nl * K
    dest = _dispatch_indices(ids.reshape(G, A), E, C)          # (G, A)
    # inverse map per group: which assignment fills expert slot s
    slot_src = torch.full((G, E * C + 1), A, dtype=torch.int64,
                          device=tokens.device)
    slot_src.scatter_(1, dest, torch.arange(A, device=tokens.device)
                      .expand(G, A))
    slot_src = slot_src[:, first * C:(first + El) * C]         # (G, El*C)
    slot_valid = slot_src < A
    token_src = torch.where(slot_valid, slot_src // K, 0)
    expert_in = torch.gather(tokens, 1,
                             token_src[..., None].expand(G, El * C, D))
    expert_in = expert_in.masked_fill(~slot_valid[..., None], 0)
    expert_in = expert_in.reshape(G, El, C, D)

    if d_shard is None:
        up = torch.einsum("gecd,edf->gecf", expert_in, w_up)
        gate = torch.einsum("gecd,edf->gecf", expert_in, w_gate)
    else:
        d0, reduce = d_shard
        expert_in = expert_in[..., d0:d0 + w_up.shape[1]].float()
        up, gate = (reduce(torch.einsum("gecd,edf->gecf", expert_in,
                                        w.float())).to(w.dtype)
                    for w in (w_up, w_gate))
    act = torch.nn.functional.silu(gate) * up
    return dest, torch.einsum("gecf,efd->gecd", act, w_down)


def _combine(expert_out, gates, dest, dtype):
    """Each token's K picked expert outputs (an overflow slot gives 0),
    weighted by their gates and summed in float32 one k at a time, in
    order; cast to `dtype`."""
    G, E, C, D = expert_out.shape
    Nl, K = gates.shape[1], gates.shape[2]
    flat_out = torch.cat([expert_out.reshape(G, E * C, D),
                          expert_out.new_zeros((G, 1, D))], dim=1)
    slots = dest.reshape(G, Nl, K)
    out = torch.zeros((G, Nl, D), dtype=torch.float32,
                      device=expert_out.device)
    for k in range(K):  # accumulate per assignment; no (G,Nl,K,D) tensor
        picked = torch.gather(flat_out, 1,
                              slots[:, :, k, None].expand(G, Nl, D))
        out = out + picked.float() * gates[:, :, k:k + 1]
    return out.to(dtype)


def _moe_grouped_sharded(tokens, router, w_up, w_gate, w_down,
                         cfg: ModelConfig, capacity: int,
                         keep_weights: bool = False):
    """`_moe_grouped` of DTensors: tokens (G, Nl, D) with the groups over
    'data' and whole over 'model' (the reference's ("batch", None,
    "embed_act")), the experts' weights over 'model' ("experts").

    Three steps run on each rank's local shards (`local_map`), each
    declaring its gradients' placements: the routing (the router gathered
    whole in one redistribute, the same on every model rank; its gradient
    a partial sum over the data ranks' groups; inference's one group
    takes the router's logits by `project` instead, the router where it
    lies), the dispatch and the rank's own experts (the
    expert inputs gathered from the rank's slots alone, so the tokens'
    gradient is a partial sum over 'model' and the weights' over 'data'),
    and the combine, after the expert outputs are gathered over 'model'
    (the reference's float32 sum of the K picks, in order, on every
    rank)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = tokens.device_mesh
    t_pl = tuple(tokens.placements)
    rep = (Replicate(),) * mesh.ndim
    # a gradient summed over the mesh dims whose ranks hold other groups
    over_groups = tuple(Partial() if p.is_shard() else Replicate()
                        for p in t_pl)
    m = mesh.mesh_dim_names.index("model")
    d = mesh.mesh_dim_names.index("data")
    one_group = (keep_weights and not t_pl[d].is_shard()
                 and w_up.placements[d].is_shard(1))
    if one_group:
        logits = project("gnd,de->gne", tokens.float(), router,
                         keep_weights=True).redistribute(mesh, t_pl)
        gates, ids = local_map(
            _top_gates, out_placements=(t_pl, t_pl),
            in_placements=(t_pl, None), device_mesh=mesh)(logits,
                                                          cfg.moe_top_k)
    else:
        router = gather_axis(router, ("data", "model"))
        gates, ids = local_map(
            _route, out_placements=(t_pl, t_pl),
            in_placements=(t_pl, rep, None),
            in_grad_placements=(t_pl, over_groups, None),
            device_mesh=mesh)(tokens, router, cfg.moe_top_k)

    E = cfg.moe_experts
    first = 0
    if w_up.placements[m].is_shard():
        first = mesh.get_local_rank(m) * (E // mesh.size(m))
    if one_group:
        return _moe_one_group(tokens, gates, ids, w_up, w_gate, w_down, cfg,
                              capacity, first)
    weights = gather_axis((w_up, w_gate, w_down), "data")
    w_pl = tuple(weights[0].placements)
    # the tokens' gradient from this rank's experts alone: a partial sum
    # over 'model' when the experts are sharded there
    tok_grad = tuple(Partial() if w.is_shard() else t
                     for t, w in zip(t_pl, w_pl))
    w_grad = tuple(Partial() if t.is_shard() else w
                   for t, w in zip(t_pl, w_pl))
    out_pl = tuple(Shard(1) if w.is_shard() else t
                   for t, w in zip(t_pl, w_pl))
    dest, expert_out = local_map(
        lambda t, i, a, b, c: _dispatch_experts(t, i, a, b, c, cfg,
                                                capacity, first),
        out_placements=(t_pl, out_pl),
        in_placements=(t_pl, t_pl) + (w_pl,) * 3,
        in_grad_placements=(tok_grad, t_pl) + (w_grad,) * 3,
        device_mesh=mesh)(tokens, ids, *weights)
    # every expert's output on every model rank, for the combine
    expert_out = expert_out.redistribute(mesh, t_pl)
    return local_map(
        _combine, out_placements=(t_pl,), in_placements=(t_pl,) * 3 + (None,),
        device_mesh=mesh)(expert_out, gates, dest, tokens.dtype)


def _moe_one_group(tokens, gates, ids, w_up, w_gate, w_down,
                   cfg: ModelConfig, capacity: int, first: int):
    """Inference's MoE at one dispatch group (a decode step's, the
    reference's), whose tokens lie whole on every data rank, with the
    experts' weights where they lie (their model dims over 'data', the
    experts over 'model'), not gathered: each rank takes its experts'
    slots over its model dims, the up and gate products' float32 partial
    sums all-reduced over 'data', the down product its model dims' slice;
    the outputs are then gathered (a few tokens' worth) for the combine,
    as on one device. No autograd: the placements of a gradient are not
    declared."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = tokens.device_mesh
    t_pl = tuple(tokens.placements)
    d = mesh.mesh_dim_names.index("data")
    d0 = mesh.get_local_rank(d) * (tokens.shape[-1] // mesh.size(d))

    def reduce(t):
        t = funcol.all_reduce(t, "sum", (mesh, d))
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t

    out_pl = tuple(Shard(1) if u.is_shard(0) else
                   Shard(3) if u.is_shard(1) else t
                   for t, u in zip(t_pl, w_up.placements))
    dest, expert_out = local_map(
        lambda t, i, a, b, c: _dispatch_experts(t, i, a, b, c, cfg,
                                                capacity, first,
                                                (d0, reduce)),
        out_placements=(t_pl, out_pl),
        in_placements=(t_pl, t_pl, tuple(w_up.placements),
                       tuple(w_gate.placements), tuple(w_down.placements)),
        device_mesh=mesh)(tokens, ids, w_up, w_gate, w_down)
    expert_out = expert_out.redistribute(mesh, t_pl)
    return local_map(
        _combine, out_placements=(t_pl,), in_placements=(t_pl,) * 3 + (None,),
        device_mesh=mesh)(expert_out, gates, dest, tokens.dtype)


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """C = max(1, ceil(top_k * tokens_per_group * cf / E)), in the
    reference's arithmetic: `-(-K * Nl * cf // E)` on a Python float."""
    E, K = cfg.moe_experts, cfg.moe_top_k
    return max(1, int(-(-K * tokens_per_group * cfg.moe_capacity_factor
                        // E)))


def moe_apply(prm, x, cfg: ModelConfig, groups: int = 1,
              keep_weights: bool = False) -> torch.Tensor:
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
    tokens = _regroup(h, (G, Nl, D), ("batch", "seq", "embed_act"))
    tokens = constrain(tokens, ("batch", None, "embed_act"))
    combined = _moe_grouped(tokens, prm["router"], prm["w_up"],
                            prm["w_gate"], prm["w_down"], cfg,
                            moe_capacity(cfg, Nl), keep_weights)
    out = _regroup(combined, (B, S, D), ("batch", None, "embed_act"))
    if "shared" in prm:
        out = out + _ffn(prm["shared"], h, cfg, keep_weights)
    return constrain(out, ("batch", "seq", "embed_act"))


def _regroup(x, shape: tuple, axes: tuple):
    """`x.reshape(shape)` with the leading dims regrouped (tokens into
    dispatch groups and back). A DTensor is first constrained to `axes`
    (whole over 'model') and, where the result's leading dim divides over
    the ranks its rows lie on ('data', and 'pod' when serving: each
    rank's rows are then its groups' tokens), reshaped on its local shard;
    else gathered over those ranks as well and reshaped whole."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    x = constrain(x, axes)  # `axes` leave 'model' whole
    mesh = x.device_mesh
    rows = math.prod(mesh.size(d) for d, pl in enumerate(x.placements)
                     if pl.is_shard(0))
    if shape[0] % rows != 0:  # gathered over the rows' mesh dims
        x = x.redistribute(mesh, tuple(Replicate() if pl.is_shard(0) else pl
                                       for pl in x.placements))
    pl = tuple(x.placements)
    local = (-1,) + tuple(shape[1:])
    return local_map(lambda t: t.reshape(local), out_placements=(pl,),
                     in_placements=(pl,), device_mesh=mesh)(x)


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
