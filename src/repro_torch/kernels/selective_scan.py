"""Kernel K6: the Mamba-1 selective scan, in CUDA.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t C_t + D x_t

The Hopper port of the Pallas kernel `repro.kernels.selective_scan.
selective_scan`: the TPU kernel carried the (d_block, N) state across
sequence chunks in VMEM scratch; the kernel (`csrc/selective_scan.cu`, where
its design and bound are written down) walks the sequence inside the block
with the state in registers, four threads per channel.

`selective_scan` is the wrapper: it checks its inputs on the host,
allocates the output, launches on the current stream without
synchronizing, and counts its launches in `LAUNCHES`. It takes float32
CUDA tensors only; `kernels.ops` casts to float32, as the reference's front
door does, and sends CPU tensors to the plain version in `kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip_mix import check_on_card, check_operand

__all__ = ["LAUNCHES", "MAX_N", "library", "selective_scan"]

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0
#: the largest state size the kernel takes (csrc/selective_scan.cu)
MAX_N = 64

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/selective_scan.cu` at first
    use."""
    lib = build.load("selective_scan")
    if lib.selective_scan_f32.argtypes is None:
        lib.selective_scan_f32.argtypes = _ARGTYPES
        lib.selective_scan_f32.restype = ctypes.c_int
    return lib


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D_skip: torch.Tensor) -> torch.Tensor:
    """The Mamba-1 scan on the card (K6).

    x, dt: (Bt, S, d); A: (d, N) with 1 <= N <= MAX_N; B, C: (Bt, S, N);
    D_skip: (d,); all float32, contiguous, on one CUDA device. Returns a new
    (Bt, S, d) float32 tensor.
    """
    global LAUNCHES
    check_on_card("selective_scan", x)
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be (Bt, S, d) and A (d, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    Bt, S, d = x.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"state size N={N} outside the kernel's 1..{MAX_N}")
    if max(S, d) > _INT_MAX or Bt > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's "
                         f"extents")
    f32 = torch.float32
    check_operand("x", x, x.device, f32, (Bt, S, d))
    check_operand("dt", dt, x.device, f32, (Bt, S, d))
    check_operand("A", A, x.device, f32, (d, N))
    check_operand("B", B, x.device, f32, (Bt, S, N))
    check_operand("C", C, x.device, f32, (Bt, S, N))
    check_operand("D_skip", D_skip, x.device, f32, (d,))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D_skip.data_ptr(), y.data_ptr(), Bt, S, d, N,
            stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return y
