"""Elastic scaling: add/remove consensus nodes mid-run, the port of
`repro.runtime.elastic`.

Consensus data parallelism makes elasticity cheap compared to synchronous
all-reduce DP: membership changes only rebuild the (host-side) graph and
re-partition the data; there is no global bitwise-identical state to
re-materialize. New nodes warm-start from the average of the survivors
(the consensus estimate), which is exactly what DDA drives all nodes toward
anyway. The state is mapped in numpy on the host, as the reference maps it,
and comes back as tensors on the device each leaf came from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.utils._pytree as _pytree

from repro_torch.core.graphs import CommGraph, build_graph
from repro_torch.data.pipeline import partition_rows

__all__ = ["RescalePlan", "plan_rescale", "rescale_state"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_n: int
    new_n: int
    graph: CommGraph
    data_slices: list
    survivor_ids: tuple[int, ...]


def plan_rescale(topology: str, old_n: int, new_n: int, m_rows: int,
                 *, failed: Sequence[int] = (), k: int = 4,
                 seed: int = 0) -> RescalePlan:
    failed_set = set(failed)
    bad = sorted(i for i in failed_set if not 0 <= i < old_n)
    if bad:
        raise ValueError(
            f"failed ids {bad} out of range for old_n={old_n}")
    survivors = tuple(i for i in range(old_n) if i not in failed_set)
    if not survivors:
        raise ValueError(
            f"all {old_n} nodes failed: no survivors to rescale from")
    graph = build_graph(topology, new_n, k=k, seed=seed)
    return RescalePlan(old_n=old_n, new_n=new_n, graph=graph,
                       data_slices=partition_rows(m_rows, new_n),
                       survivor_ids=survivors)


def rescale_state(stacked_state: PyTree, plan: RescalePlan) -> PyTree:
    """Map an (old_n, ...) stacked node state to (new_n, ...).

    Surviving rows carry over (up to new_n of them); new rows initialize to
    the survivors' average -- the consensus warm start."""
    surv = np.asarray(plan.survivor_ids)

    def one(t):
        a = t.detach().cpu().numpy()
        alive = a[surv]
        mean = alive.mean(axis=0, keepdims=True)
        rows = [alive[i % len(alive)] if i < len(alive) else mean[0]
                for i in range(plan.new_n)]
        return torch.from_numpy(np.stack(rows)).to(t.device)

    return _pytree.tree_map(one, stacked_state)
