"""Pod-stacked state, the port of `repro.launch.specs`' `pod_stack` and the
launcher's per-pod parameter byte count.

For consensus (multi-pod) training, model and optimizer state carry a
leading `pod` replica dimension: each pod is one DDA node with its own
parameters, and the batch is split across pods (disjoint data shards,
paper section II). The reference builds abstract specs and shardings for
its dry-run; those wait for the port's dry-run slice.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
import torch.utils._pytree as _pytree

PyTree = Any


def pod_stack(pods: Iterable[PyTree], n_pods: int) -> PyTree:
    """Stack `n_pods` trees of one structure into one tree of (n_pods, ...)
    leaves. `pods` may be a generator: each pod's tree is copied into the
    stack and dropped before the next one is made, so only one pod's tree
    is alive beside the stack."""
    stacked, spec = None, None
    count = 0
    for i, tree in enumerate(pods):
        leaves, tree_spec = _pytree.tree_flatten(tree)
        if stacked is None:
            spec = tree_spec
            stacked = [torch.empty((n_pods,) + tuple(leaf.shape),
                                   dtype=leaf.dtype, device=leaf.device)
                       for leaf in leaves]
        elif tree_spec != spec:
            raise ValueError(f"pod {i}'s tree differs from pod 0's")
        for dst, leaf in zip(stacked, leaves):
            dst[i].copy_(leaf)
        count += 1
        del tree, leaves
    if count != n_pods:
        raise ValueError(f"{count} pod trees for n_pods={n_pods}")
    return _pytree.tree_unflatten(stacked, spec)


def param_bytes_per_pod(stacked: PyTree, n_pods: int) -> float:
    """Bytes one pod ships per gossip round per link: the pod-stacked
    parameter tree's bytes over the pods, as the reference's launcher
    divides them (a float)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in _pytree.tree_leaves(stacked)) / max(n_pods, 1)
