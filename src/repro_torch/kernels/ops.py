"""Dispatch for the port's kernels: a CPU tensor goes to the plain version in
`kernels.ref`, a CUDA tensor to the hand-written kernel, which builds or
launches or raises. There is no switch between the two and no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import compress_mix as _compress_mix
from repro_torch.kernels import gossip_mix as _gossip_mix
from repro_torch.kernels import ref

__all__ = ["compress_mix_impl", "gossip_gather_mix_impl", "ref"]


def _weight_vector(w, shape: tuple[int, ...], device) -> torch.Tensor:
    """Scalar (uniform) weights become constant float32 vectors, as the
    reference's kernel route does (`repro.kernels.ops:97-100`)."""
    if isinstance(w, torch.Tensor) and w.dim() > 0:
        return w
    return torch.full(shape, float(w), dtype=torch.float32, device=device)


def gossip_gather_mix_impl(z: torch.Tensor, S_in: torch.Tensor, w_self,
                           w_edge, *, msg: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Sparse consensus round on a stacked z (kernel K1).

    z: (n, ...) stacked node states; S_in: (n, k) in-neighbor indices
    (S_in[i, j] = the node whose value node i receives in slot j); w_self:
    (n,) or a scalar; w_edge: (n, k) or a scalar. Equals
    `W @ z.reshape(n, -1)` for the mixing matrix W with diag(W) = w_self
    and W[i, S_in[i, j]] summing w_edge[i, j] over slots. `msg` (same shape
    as z) substitutes the transmitted stack for the neighbor gathers and
    defaults to z itself.
    """
    if z.device.type == "cpu":
        return ref.gossip_gather_mix_ref(z, S_in, w_self, w_edge, msg=msg)
    n, k = S_in.shape
    w_self = _weight_vector(w_self, (n,), z.device)
    w_edge = _weight_vector(w_edge, (n, k), z.device)
    mf = None if msg is None else msg.reshape(n, -1)
    out = _gossip_mix.gossip_mix_weighted(z.reshape(n, -1), S_in, w_self,
                                          w_edge, msg=mf)
    return out.reshape(z.shape)


def compress_mix_impl(z: torch.Tensor, msg: torch.Tensor, mask: torch.Tensor,
                      S_in: torch.Tensor, w_self, w_edge) -> torch.Tensor:
    """Sparsified consensus round on a stacked z (kernel K2):
    `w_self[i] z[i] + sum_j w_edge[i, j] (msg * mask)[S_in[i, j]]`.

    Shapes and weights as in `gossip_gather_mix_impl`; msg is the corrected
    message stack and mask its 0/1 support, both like z. Each node's own z
    is mixed exactly; only the received messages are masked.
    """
    if z.device.type == "cpu":
        return ref.compress_mix_ref(z, msg, mask, S_in, w_self, w_edge)
    n, k = S_in.shape
    w_self = _weight_vector(w_self, (n,), z.device)
    w_edge = _weight_vector(w_edge, (n, k), z.device)
    out = _compress_mix.compress_mix_weighted(
        z.reshape(n, -1), msg.reshape(n, -1), mask.reshape(n, -1), S_in,
        w_self, w_edge)
    return out.reshape(z.shape)
