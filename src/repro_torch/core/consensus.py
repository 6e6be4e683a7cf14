"""Consensus mixing operators, in PyTorch: the port of
`repro.core.consensus`. On a stacked (n, ...) state: `mix_dense` and
`disagreement`, and the stale-gossip combines (`stale_combine`,
`stale_combine_batch`) the event-driven netsim nodes call; one node a
rank: the collectives below.

`mix_dense` is the P @ z matmul the simulator uses on complete (or
near-complete) graphs (`tree_mix_dense`: on every leaf of a tree); it
stays a plain `torch.matmul` in float32 (the port never turns TF32 on, so
it is full precision on the card too). The sparse k-regular mix is the
hand kernel behind `repro_torch.kernels.ops`.

`tree_mix_gossip` is the LM launcher's pod mix when the pods are stacked
on one card: the reference mixes the pods of every parameter leaf with
`einsum("pq,q...->p...", P, a)` in float32 (`launch/steps.py`
`_dense_mix`); the port mixes each leaf through kernel K1
(`kernels.ops.gossip_gather_mix_impl`).

When the pods are one a rank, the mix is the reference's shard_map
collectives, on a `torch.distributed` process group: `mix_collective`
(complete graph: an all-reduce, then a division by n, the reference's
`pmean`; k-regular: k rounds of `batch_isend_irecv`, each leaf's own
dtype, the reference's ppermutes), `tree_mix_collective` and `mix_stale`
(one-step-stale gossip). The axis name resolves to its group through
`bind_axis` (a mesh binds "pod": `launch.mesh.Mesh.bind`), the
counterpart of the shard_map that binds the reference's axis; a process
group may also be passed in its place. Gloo takes CPU tensors for every
one of them and CUDA tensors for the all-reduce; NCCL takes CUDA tensors.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as _pytree

__all__ = ["bind_axis", "disagreement", "gossip_operands", "mix_collective",
           "mix_dense", "mix_stale", "stale_combine", "stale_combine_batch",
           "tree_mix_collective", "tree_mix_dense", "tree_mix_gossip"]


def mix_dense(z: torch.Tensor, P: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Oracle mixing: z has shape (n, ...) -- one leading row per node."""
    P = torch.as_tensor(P, dtype=z.dtype, device=z.device)
    zf = z.reshape(z.shape[0], -1)
    return (P @ zf).reshape(z.shape)


def tree_mix_dense(tree: Any, P: torch.Tensor | np.ndarray) -> Any:
    """`mix_dense` on every leaf of a tree of stacked (n, ...) tensors."""
    return _pytree.tree_map(lambda a: mix_dense(a, P), tree)


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


# ---------------------------------------------------------------------------
# collectives over a process group (one node a rank)
# ---------------------------------------------------------------------------


class _Axes(threading.local):
    def __init__(self):
        self.groups: dict[str, Any] = {}


_AXES = _Axes()


@contextlib.contextmanager
def bind_axis(axis_name: str, group):
    """Resolve `axis_name` to the process group `group` in this thread
    while the context lasts (contexts nest; the previous binding comes
    back on exit)."""
    had = axis_name in _AXES.groups
    prev = _AXES.groups.get(axis_name)
    _AXES.groups[axis_name] = group
    try:
        yield
    finally:
        if had:
            _AXES.groups[axis_name] = prev
        else:
            del _AXES.groups[axis_name]


def _group(axis_name):
    """The process group of an axis name bound by `bind_axis`, or the
    group itself."""
    if not isinstance(axis_name, str):
        return axis_name
    try:
        return _AXES.groups[axis_name]
    except KeyError:
        raise ValueError(
            f"axis {axis_name!r} is bound to no process group; call inside "
            f"`bind_axis` (a mesh's `bind()`) or pass the group") from None


def _weight(value: float, like: torch.Tensor) -> torch.Tensor:
    """A graph weight as a 0-d tensor of `like`'s dtype, rounded to it
    first, as jax rounds a Python float against a typed array."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _ppermute(z: torch.Tensor, pairs, group) -> torch.Tensor:
    """The reference's `lax.ppermute(z, perm=pairs)` on group ranks: each
    rank sends z to its destination and receives its source's z (zeros
    when no pair names it as the destination)."""
    import torch.distributed as dist

    rank = dist.get_rank(group)
    dst = [d for s, d in pairs if s == rank]
    src = [s for s, d in pairs if d == rank]
    out = torch.zeros_like(z)
    if src == [rank] and dst == [rank]:
        return out.copy_(z)
    ops = []
    send = z.contiguous()
    for d in dst:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, d), group))
    for s in src:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _pmean(z: torch.Tensor, n: int, group) -> torch.Tensor:
    """`lax.pmean`: an all-reduce of the sum, then a division by n in z's
    dtype (gloo has no average)."""
    import torch.distributed as dist

    total = z.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / _weight(float(n), total)


def _ppermute_accumulate(z: torch.Tensor, graph, axis_name, *,
                         self_weight: float | None = None,
                         edge_weight: float | None = None) -> torch.Tensor:
    sw = graph.self_weight if self_weight is None else self_weight
    ew = graph.edge_weight if edge_weight is None else edge_weight
    group = _group(axis_name)
    acc = z * _weight(sw, z)
    for pairs in graph.ppermute_pairs():
        recv = _ppermute(z, list(pairs), group)
        acc = acc + _weight(ew, z) * recv
    return acc


def mix_collective(z: torch.Tensor, graph, axis_name) -> torch.Tensor:
    """This rank's node mixed over `axis_name` (one node per rank), in z's
    dtype. Complete graph: P = (1/n) 11^T, exact averaging, one all-reduce
    (`pmean`). k-regular: k rounds of point-to-point exchange in the
    graph's order, `sw z + sum ew recv`."""
    if graph.name == "complete":
        return _pmean(z, graph.n, _group(axis_name))
    return _ppermute_accumulate(z, graph, axis_name)


def tree_mix_collective(tree: Any, graph, axis_name) -> Any:
    return _pytree.tree_map(lambda a: mix_collective(a, graph, axis_name),
                            tree)


def mix_stale(z: torch.Tensor, neighbor_acc: torch.Tensor, graph,
              axis_name) -> tuple[torch.Tensor, torch.Tensor]:
    """[beyond paper] async gossip: returns (mixed, next_neighbor_acc).

    `neighbor_acc` is the edge-weighted sum of neighbor values shipped
    during the PREVIOUS round. The mixed value uses those stale messages;
    the current z is shipped now for the next round (the complete graph's
    `pmean(z) - z / n`, or the graph's exchanges, each weighted by the
    edge weight)."""
    mixed = stale_combine(z, neighbor_acc, _weight(graph.self_weight, z))
    group = _group(axis_name)
    if graph.name == "complete":
        n = graph.n
        nxt = _pmean(z, n, group) - z / _weight(float(n), z)
    else:
        nxt = torch.zeros_like(z)
        for pairs in graph.ppermute_pairs():
            nxt = nxt + _weight(graph.edge_weight, z) * _ppermute(
                z, list(pairs), group)
    return mixed, nxt
