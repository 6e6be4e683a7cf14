"""Consensus mixing operators on a stacked (n, ...) state, in PyTorch: the
port of `repro.core.consensus`'s `mix_dense` and `disagreement`, and its
numpy stale-gossip combines (`stale_combine`, `stale_combine_batch`) the
event-driven netsim nodes call.

`mix_dense` is the P @ z matmul the simulator uses on complete (or
near-complete) graphs; it stays a plain `torch.matmul` in float32 (the port
never turns TF32 on, so it is full precision on the card too). The sparse
k-regular mix is the hand kernel behind `repro_torch.kernels.ops`. The
shard_map collectives of the reference are not part of the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["disagreement", "mix_dense", "stale_combine",
           "stale_combine_batch"]


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
