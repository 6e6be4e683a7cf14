"""Plain PyTorch versions of the port's kernels (the oracles the kernels are
held against, on the card by chip_smoke.py and tests/test_torch_kernels_card.py,
and against the reference on the CPU by tests/test_torch_kernels.py and
tests/test_torch_kernel_ops.py).
Deliberately naive and readable, and in the float order of
`repro.kernels.ref`, so CPU parity with the reference is tight.

The main path calls these only for tensors that lie on the CPU
(`kernels.ops`); a CUDA tensor goes to the kernel.
"""

from __future__ import annotations

import math

import torch

__all__ = ["compress_mix_ref", "compress_mix_weighted_ref",
           "flash_attention_ref", "gossip_gather_mix_ref", "gossip_mix_ref",
           "gossip_mix_weighted_ref", "selective_scan_ref", "ssd_scan_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: float | None = None) -> torch.Tensor:
    """Plain softmax attention in float32. q: (B, H, Sq, D); k, v:
    (B, KH, Sk, D) with H % KH == 0 (GQA: query head h reads kv head
    h // (H / KH)). Returns (B, H, Sq, D) in q's dtype.

    The causal mask is top-left aligned: query row r sees key columns
    c <= r, as the TPU kernel (`repro.kernels.flash_attention`, `rows >=
    cols`) and its front door `repro.kernels.ops.flash_attention` compute.
    `repro.kernels.ref.flash_attention_ref` aligns it bottom-right
    (`tril(k=Sk-Sq)`), so the two oracles differ when Sq != Sk.
    """
    group = q.shape[1] // k.shape[1]
    D = q.shape[-1]
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vr).to(q.dtype)


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D_skip: torch.Tensor) -> torch.Tensor:
    """Mamba-1 recurrence, a Python loop over tokens.
    x, dt: (Bt, S, d); A: (d, N); B, C: (Bt, S, N); D_skip: (d,).
    Returns y: (Bt, S, d) float32."""
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    A = A.float()
    Bt, S, d = x.shape
    h = torch.zeros((Bt, d, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        x_t, dt_t = x[:, t], dt[:, t]
        dA = torch.exp(dt_t[..., None] * A)                  # (Bt, d, N)
        dBx = (dt_t * x_t)[..., None] * B[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1) + x * D_skip.float()


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD recurrence, a sequential loop over tokens.
    x: (Bt, S, H, P); dt: (Bt, S, H); A: (H,) negative; B, C: (Bt, S, N).
    Returns y: (Bt, S, H, P) float32 (no D skip, no gating)."""
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    A = A.float()
    Bt, S, H, P = x.shape
    h = torch.zeros((Bt, H, P, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        x_t, dt_t = x[:, t], dt[:, t]                        # (Bt,H,P), (Bt,H)
        dA = torch.exp(dt_t * A)                             # (Bt, H)
        dBx = torch.einsum("bhp,bn->bhpn", x_t * dt_t[..., None], B[:, t])
        h = dA[..., None, None] * h + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t]))
    return torch.stack(ys, dim=1)


def gossip_mix_ref(self_buf: torch.Tensor, neighbor_bufs: torch.Tensor,
                   self_weight: float, edge_weight: float) -> torch.Tensor:
    """out = sw * self + ew * sum_k neighbor_k, accumulated in float32.
    self_buf: (M,); neighbor_bufs: (K, M). Returns self_buf's dtype."""
    acc = self_weight * self_buf.float()
    acc = acc + edge_weight * torch.sum(neighbor_bufs.float(), 0)
    return acc.to(self_buf.dtype)


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
