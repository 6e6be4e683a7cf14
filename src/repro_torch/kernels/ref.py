"""Plain PyTorch versions of the port's kernels (the oracles the kernels are
held against, on the card by chip_smoke.py and in tests/test_torch_kernels.py).
Deliberately naive and readable, and in the float order of
`repro.kernels.ref`, so CPU parity with the reference is tight.

The main path calls these only for tensors that lie on the CPU
(`kernels.ops`); a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import torch

__all__ = ["compress_mix_ref", "compress_mix_weighted_ref",
           "gossip_gather_mix_ref", "gossip_mix_weighted_ref"]


def gossip_mix_weighted_ref(self_buf: torch.Tensor,
                            neighbor_bufs: torch.Tensor,
                            w_self: torch.Tensor,
                            w_edge: torch.Tensor) -> torch.Tensor:
    """out[i] = w_self[i] * self[i] + sum_j w_edge[i, j] * nbr[j, i].
    self_buf: (n, M); neighbor_bufs: (K, n, M) already gathered; w_self:
    (n,); w_edge: (n, K)."""
    acc = w_self[:, None] * self_buf.float()
    acc = acc + torch.einsum("nk,knm->nm", w_edge.float(),
                             neighbor_bufs.float())
    return acc.to(self_buf.dtype)


def gossip_gather_mix_ref(z: torch.Tensor, S_in: torch.Tensor, w_self,
                          w_edge, msg: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """One sparse consensus round on a stacked z, as a gather + weighted sum:
    out[i] = w_self[i] z[i] + sum_j w_edge[i, j] src[S_in[i, j]].

    z: (n, ...); S_in: (n, K) in-neighbor indices; w_self: (n,) or a scalar;
    w_edge: (n, K) or a scalar (uniform lazy weights: one multiply over the
    summed gathers instead of K weight broadcasts). `msg` (same shape as z)
    substitutes the TRANSMITTED stack for the neighbor gathers and defaults
    to z itself (uncompressed). Accumulates in float32 and returns z's
    dtype.
    """
    n, k = S_in.shape
    zf = z.reshape(n, -1).float()
    mf = zf if msg is None else msg.reshape(n, -1).float()
    if not torch.is_tensor(w_edge) or w_edge.dim() == 0:
        acc = mf[S_in[:, 0]]
        for j in range(1, k):
            acc = acc + mf[S_in[:, j]]
        out = w_self * zf + w_edge * acc
        return out.to(z.dtype).reshape(z.shape)
    acc = w_self[:, None] * zf
    for j in range(k):
        acc = acc + w_edge[:, j][:, None] * mf[S_in[:, j]]
    return acc.to(z.dtype).reshape(z.shape)


def compress_mix_weighted_ref(self_buf: torch.Tensor,
                              neighbor_msgs: torch.Tensor,
                              neighbor_masks: torch.Tensor,
                              w_self: torch.Tensor,
                              w_edge: torch.Tensor) -> torch.Tensor:
    """out[i] = w_self[i] * self[i] + sum_j w_edge[i, j] * (msg_j * mask_j)[i],
    the pre-gathered form the TPU kernel takes. self_buf: (n, M);
    neighbor_msgs, neighbor_masks: (K, n, M) already gathered; w_self:
    (n,); w_edge: (n, K)."""
    sent = neighbor_msgs.float() * neighbor_masks.float()
    acc = w_self[:, None] * self_buf.float()
    acc = acc + torch.einsum("nk,knm->nm", w_edge.float(), sent)
    return acc.to(self_buf.dtype)


def compress_mix_ref(z: torch.Tensor, msg: torch.Tensor, mask: torch.Tensor,
                     S_in: torch.Tensor, w_self, w_edge) -> torch.Tensor:
    """Masked (sparsified) consensus round:
    out[i] = w_self[i] z[i] + sum_j w_edge[i, j] (msg * mask)[S_in[i, j]].

    z/msg/mask: (n, ...) with mask the 0/1 transmitted support; S_in:
    (n, K); weights as in `gossip_gather_mix_ref`. The transmitted stack is
    formed in float32 before the gather, as `repro.kernels.ref` forms it.
    """
    n = S_in.shape[0]
    sent = msg.reshape(n, -1).float() * mask.reshape(n, -1).float()
    return gossip_gather_mix_ref(z, S_in, w_self, w_edge,
                                 msg=sent.reshape(z.shape))
