"""Consensus mixing operators on a stacked (n, ...) state, in PyTorch: the
port of `repro.core.consensus`'s `mix_dense` and `disagreement`, and its
numpy stale-gossip combines (`stale_combine`, `stale_combine_batch`) the
event-driven netsim nodes call.

`mix_dense` is the P @ z matmul the simulator uses on complete (or
near-complete) graphs; it stays a plain `torch.matmul` in float32 (the port
never turns TF32 on, so it is full precision on the card too). The sparse
k-regular mix is the hand kernel behind `repro_torch.kernels.ops`.

`tree_mix_gossip` is the LM launcher's pod mix: the reference mixes the
pods of every parameter leaf with `einsum("pq,q...->p...", P, a)` in
float32 (`launch/steps.py` `_dense_mix`), or with the graph's ppermutes
inside a shard_map across chips. The port stacks the pods on one card and
mixes each leaf through kernel K1 (`kernels.ops.gossip_gather_mix_impl`).
The shard_map collectives of the reference wait for the multi-card slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["disagreement", "gossip_operands", "mix_dense", "stale_combine",
           "stale_combine_batch", "tree_mix_gossip"]


def mix_dense(z: torch.Tensor, P: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Oracle mixing: z has shape (n, ...) -- one leading row per node."""
    P = torch.as_tensor(P, dtype=z.dtype, device=z.device)
    zf = z.reshape(z.shape[0], -1)
    return (P @ zf).reshape(z.shape)


def stale_combine(z, neighbor_acc, self_weight: float):
    """Stale-gossip combine: self_weight * z + (edge-weighted sum of the
    neighbor values that actually arrived). Used by
    `repro_torch.netsim.node.AsyncDDANode`, whose event-driven nodes fold
    the weight of missing/late messages back into `self_weight`
    (row-stochasticity preserved, as in a deadline-degraded round). Works
    on numpy arrays and tensors.
    """
    return z * self_weight + neighbor_acc


def stale_combine_batch(z_stack, neighbor_acc_stack, self_weights):
    """`stale_combine` over a stacked batch of nodes at once.

    z_stack / neighbor_acc_stack have shape (b, ...); `self_weights` is a
    (b,) vector because each node folds a DIFFERENT number of undelivered
    in-neighbors back into its own weight. Elementwise it is the exact same
    arithmetic as b scalar `stale_combine` calls -- the netsim's vectorized
    engine relies on that for bit-identical traces against the per-node
    object engine.
    """
    sw = self_weights.reshape(self_weights.shape[0],
                              *([1] * (z_stack.ndim - 1)))
    return z_stack * sw + neighbor_acc_stack


def disagreement(z_stack: torch.Tensor) -> torch.Tensor:
    """Network error max_i ||z_bar - z_i|| (paper's network-error term in
    eq. (6)); z_stack has shape (n, ...)."""
    zbar = torch.mean(z_stack, dim=0, keepdim=True)
    diff = (z_stack - zbar).reshape(z_stack.shape[0], -1)
    return torch.max(torch.linalg.vector_norm(diff, dim=-1))


def gossip_operands(graph, device) -> tuple[torch.Tensor, float, float]:
    """(S_in, self_weight, edge_weight) of `graph` for K1, as
    `core.dda.DDASimulator._sparse_weights` builds them for uniform
    weights: S_in[i, j] = perms[j][i] (int64, (n, k)) on `device`, the
    weights Python floats holding their float32 values."""
    S_in = np.stack([np.asarray(p, dtype=np.int64) for p in graph.perms],
                    axis=1) if graph.perms else np.zeros((graph.n, 0),
                                                         np.int64)
    return (torch.as_tensor(S_in, device=device),
            float(np.float32(graph.self_weight)),
            float(np.float32(graph.edge_weight)))


def tree_mix_gossip(tree: Any, graph, *, device) -> Any:
    """Every leaf of a tree of pod-stacked tensors (n, ...) mixed over the
    graph through K1 (its plain version on the CPU): `w_self z[i] + w_edge
    sum_j z[S_in[i, j]]`, accumulated in float32, new tensors in each
    leaf's dtype. With no neighbors (n = 1, k = 0) the mix is the identity
    and the tree comes back. On the complete graph at n = 2 (weights 1/2,
    exact) it is the reference's `_dense_mix` bit for bit."""
    from repro_torch.kernels import ops

    S_in, sw, ew = gossip_operands(graph, device)
    if S_in.shape[1] == 0:
        return tree

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return ops.gossip_gather_mix_impl(t.contiguous(), S_in, sw, ew)
    return walk(tree)
