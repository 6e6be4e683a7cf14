"""Consensus mixing operators on a stacked (n, ...) state, in PyTorch: the
port of `repro.core.consensus`'s `mix_dense` and `disagreement`.

`mix_dense` is the P @ z matmul the simulator uses on complete (or
near-complete) graphs; it stays a plain `torch.matmul` in float32 (the port
never turns TF32 on, so it is full precision on the card too). The sparse
k-regular mix is the hand kernel behind `repro_torch.kernels.ops`. The
shard_map collectives of the reference are not part of the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mix_dense", "disagreement"]


def mix_dense(z: torch.Tensor, P: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Oracle mixing: z has shape (n, ...) -- one leading row per node."""
    P = torch.as_tensor(P, dtype=z.dtype, device=z.device)
    zf = z.reshape(z.shape[0], -1)
    return (P @ zf).reshape(z.shape)


def disagreement(z_stack: torch.Tensor) -> torch.Tensor:
    """Network error max_i ||z_bar - z_i|| (paper's network-error term in
    eq. (6)); z_stack has shape (n, ...)."""
    zbar = torch.mean(z_stack, dim=0, keepdim=True)
    diff = (z_stack - zbar).reshape(z_stack.shape[0], -1)
    return torch.max(torch.linalg.vector_norm(diff, dim=-1))
