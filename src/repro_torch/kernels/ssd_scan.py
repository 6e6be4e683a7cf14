"""Kernel K5: the Mamba-2 SSD scan, in CUDA.

    h_t = exp(dt_t * A_h) h_{t-1} + (dt_t x_t) B_t^T,   y_t = h_t C_t

The Hopper port of the Pallas kernel `repro.kernels.ssd_scan.ssd_scan`, in
its chunked matmul form: the kernel (`csrc/ssd_scan.cu`, where its design
and bound are written down) splits the state's P rows across blocks and
loops over the chunks in order, writing the in-chunk products itself.

`ssd_scan` is the wrapper: it checks its inputs on the host, allocates the
output, launches on the current stream without synchronizing, and counts
its launches in `LAUNCHES`. It takes float32 CUDA tensors only;
`kernels.ops` casts to float32, as the reference's front door does, and
sends CPU tensors to the plain version in `kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip_mix import check_on_card, check_operand

__all__ = ["LAUNCHES", "MAX_N", "library", "ssd_scan"]

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0
#: the largest state size whose chunk fits a block's 227 KB of shared
#: memory (`smem_floats` in csrc/ssd_scan.cu: 928 N + 26,624 bytes)
MAX_N = 220

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/ssd_scan.cu` at first use."""
    lib = build.load("ssd_scan")
    if lib.ssd_scan_f32.argtypes is None:
        lib.ssd_scan_f32.argtypes = _ARGTYPES
        lib.ssd_scan_f32.restype = ctypes.c_int
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 SSD scan on the card (K5).

    x: (Bt, S, H, P); dt: (Bt, S, H); A: (H,); B, C: (Bt, S, N) with
    1 <= N <= MAX_N; all float32, contiguous, on one CUDA device. Returns a
    new (Bt, S, H, P) float32 tensor (no D skip, no gating).
    """
    global LAUNCHES
    check_on_card("ssd_scan", x)
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"x must be (Bt, S, H, P) and B (Bt, S, N), got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[2]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"state size N={N} outside the kernel's 1..{MAX_N}")
    if max(Bt, H) > 65535 or max(S, P) > _INT_MAX:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    f32 = torch.float32
    check_operand("x", x, x.device, f32, (Bt, S, H, P))
    check_operand("dt", dt, x.device, f32, (Bt, S, H))
    check_operand("A", A, x.device, f32, (H,))
    check_operand("B", B, x.device, f32, (Bt, S, N))
    check_operand("C", C, x.device, f32, (Bt, S, N))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_f32(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                               B.data_ptr(), C.data_ptr(), y.data_ptr(),
                               Bt, S, H, P, N, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return y
