"""[Beyond paper, anticipated by its section VI] Consensus wrapping of an
arbitrary inner optimizer (SGD / AdamW / ...): the port of
`repro.core.consensus_sgd`'s host half.

Each consensus node runs `h` inner optimizer steps on its shard, then the
nodes gossip-average their PARAMETERS over the communication graph G with
mixing matrix P, on the paper's schedule (local-update data parallelism,
the DiLoCo family). `mix_params_dense` is the stacked oracle, leading axis
the node index. The reference's `mix_params` averages inside a shard_map
over the consensus axis, a collective that comes with the multi-card
slice; on one card the LM launcher mixes its stacked pods through kernel
K1 (`core.consensus.tree_mix_gossip`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core import consensus as _cons
from repro_torch.core.graphs import CommGraph

__all__ = ["ConsensusConfig", "mix_params_dense"]

PyTree = Any


class ConsensusConfig(NamedTuple):
    graph: CommGraph
    axis_name: str = "pod"


def mix_params_dense(params_stack: PyTree, graph: CommGraph) -> PyTree:
    """Oracle/simulator version: leading axis = node index."""
    return _cons.tree_mix_dense(params_stack, graph.mixing_matrix())
