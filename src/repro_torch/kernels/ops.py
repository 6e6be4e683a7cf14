"""Dispatch for the port's kernels: a CPU tensor goes to the plain version in
`kernels.ref`, a CUDA tensor to the hand-written kernel, which builds or
launches or raises. There is no switch between the two and no fallback.

The front doors of `repro.kernels.ops` have their counterparts here, with
the same signatures and layouts and no `interpret` argument:
`flash_attention` (K4), `selective_scan` (K6), `ssd_scan` (K5) and
`gossip_mix` (K3), beside the dense path's `gossip_gather_mix_impl` (K1)
and `compress_mix_impl` (K2). Each takes every shape its reference front
door takes, and refuses what that one refuses (the Pallas kernels' block
divisibility) on either device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import compress_mix as _compress_mix
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import gossip_mix as _gossip_mix
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _selective_scan
from repro_torch.kernels import ssd_scan as _ssd_scan

__all__ = ["compress_mix_impl", "flash_attention", "gossip_gather_mix_impl",
           "gossip_mix", "ref", "selective_scan", "ssd_scan"]


def _check_block(name: str, extent: int, block: int) -> None:
    """The reference's Pallas front doors cut `extent` into blocks of
    min(block, extent) and refuse a remainder; so does the port."""
    if extent < 1 or extent % min(block, extent):
        raise ValueError(f"{name}={extent} is not a multiple of "
                         f"min({block}, {name}), as the reference's kernel "
                         f"requires")


def _check_shape(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward (kernel K4), `repro.kernels.ops.flash_attention`.

    q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with H % KH == 0; Sq and Sk each
    at most 128 or a multiple of 128 (the reference's blocks). The causal
    mask is top-left aligned (query row r sees key columns c <= r), as the
    reference's kernel computes. Returns (B, H, Sq, D) in q's dtype.
    """
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Sq, D), got {tuple(q.shape)}")
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k must be (B={B}, KH, Sk, D={D}), got "
                         f"{tuple(k.shape)}")
    KH, Sk = k.shape[1], k.shape[2]
    _check_shape("v", v, (B, KH, Sk, D))
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")
    _check_block("Sq", Sq, 128)
    _check_block("Sk", Sk, 128)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _flash_attention.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D_skip: torch.Tensor) -> torch.Tensor:
    """The Mamba-1 selective scan (kernel K6),
    `repro.kernels.ops.selective_scan`.

    x, dt: (Bt, S, d); A: (d, N); B, C: (Bt, S, N); D_skip: (d,); d at most
    512 or a multiple of 512, S at most 256 or a multiple of 256 (the
    reference's blocks). Inputs are cast to float32, as the reference's
    kernel casts them. Returns y: (Bt, S, d) float32.
    """
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be (Bt, S, d) and A (d, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    Bt, S, d = x.shape
    N = A.shape[1]
    _check_shape("dt", dt, (Bt, S, d))
    _check_shape("A", A, (d, N))
    _check_shape("B", B, (Bt, S, N))
    _check_shape("C", C, (Bt, S, N))
    _check_shape("D_skip", D_skip, (d,))
    _check_block("d", d, 512)
    _check_block("S", S, 256)
    if x.device.type == "cpu":
        return ref.selective_scan_ref(x, dt, A, B, C, D_skip)
    f32 = [t.float().contiguous() for t in (x, dt, A, B, C, D_skip)]
    return _selective_scan.selective_scan(*f32)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 SSD scan (kernel K5), `repro.kernels.ops.ssd_scan`.

    x: (Bt, S, H, P); dt: (Bt, S, H); A: (H,) negative; B, C: (Bt, S, N); S
    at most 128 or a multiple of 128 (the reference's chunk). Inputs are
    cast to float32, as the reference's kernel casts them. Returns y:
    (Bt, S, H, P) float32 (no D skip, no gating).
    """
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"x must be (Bt, S, H, P) and B (Bt, S, N), got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[2]
    _check_shape("dt", dt, (Bt, S, H))
    _check_shape("A", A, (H,))
    _check_shape("B", B, (Bt, S, N))
    _check_shape("C", C, (Bt, S, N))
    _check_block("S", S, 128)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C)
    f32 = [t.float().contiguous() for t in (x, dt, A, B, C)]
    return _ssd_scan.ssd_scan(*f32)


def gossip_mix(self_buf: torch.Tensor, neighbor_bufs: torch.Tensor,
               self_weight: float, edge_weight: float) -> torch.Tensor:
    """One node's flat gossip mix (kernel K3), `repro.kernels.ops.
    gossip_mix`: `sw * self + ew * sum_k neighbor_k` over self_buf (M,) and
    neighbor_bufs (k, M), scalar weights, accumulated in float32, returned
    in self_buf's dtype. The reference pads M to whole (8, 1024) tiles; the
    kernel needs no padding.
    """
    if self_buf.dim() != 1:
        raise ValueError(f"self_buf must be (M,), got "
                         f"{tuple(self_buf.shape)}")
    (M,) = self_buf.shape
    if neighbor_bufs.dim() != 2 or neighbor_bufs.shape[1] != M:
        raise ValueError(f"neighbor_bufs must be (k, {M}), got "
                         f"{tuple(neighbor_bufs.shape)}")
    if self_buf.device.type == "cpu":
        return ref.gossip_mix_ref(self_buf, neighbor_bufs, self_weight,
                                  edge_weight)
    return _gossip_mix.gossip_mix(self_buf.contiguous(),
                                  neighbor_bufs.contiguous(),
                                  float(self_weight), float(edge_weight))


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
    defaults to z itself. A batch's (n, B, d) carry is one (n, B*d) state
    here (a view of a contiguous carry), each column mixed on its own in
    the same order, so a lane mixes as its solo run does.
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
