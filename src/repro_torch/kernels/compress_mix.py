"""Kernel K2: the compressed (sparsified) gossip mix on a stacked node state,
in CUDA.

    out[i] = w_self[i] * z[i]
             + sum_{j<k} w_edge[i, j] * (msg * mask)[S_in[i, j]]

The Hopper port of the Pallas kernel `repro.kernels.compress_mix.
compress_mix_weighted` and the two gathers in front of it
(`repro.kernels.ops.compress_mix_impl`): the kernel (`csrc/compress_mix.cu`,
where its design and bound are written down) reads the k neighbor rows of
msg and of the 0/1 mask through S_in itself, so neither gathered (k, n, M)
stack the TPU version was handed is ever built. It is bandwidth-bound: one
pass over z, msg, mask and out.

`compress_mix_weighted` is the wrapper: it checks its inputs on the host,
allocates the output, launches on the current stream without
synchronizing, and counts its launches in `LAUNCHES`. It takes CUDA
tensors only; `kernels.ops` sends CPU tensors to the plain version in
`kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip_mix import check_mix_operands, check_operand

__all__ = ["LAUNCHES", "compress_mix_weighted", "library"]

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/compress_mix.cu` at first use."""
    lib = build.load("compress_mix")
    if lib.compress_mix_f32.argtypes is None:
        for fn in (lib.compress_mix_f32, lib.compress_mix_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def compress_mix_weighted(z: torch.Tensor, msg: torch.Tensor,
                          mask: torch.Tensor, S_in: torch.Tensor,
                          w_self: torch.Tensor,
                          w_edge: torch.Tensor) -> torch.Tensor:
    """One compressed gossip round on the card.

    z: (n, M) float32 or bfloat16, contiguous, on a CUDA device: each
    node's own state, mixed exactly; msg: the corrected messages, like z;
    mask: their 0/1 transmitted support, like z; S_in: (n, k) int64
    in-neighbor indices; w_self: (n,) and w_edge: (n, k) float32 weights.
    Accumulates in float32 and returns a new (n, M) tensor in z's dtype.

    The range 0 <= S_in < n is checked by the kernel on the device (a
    device-side assert, raised by the next synchronizing call), as K1 does.
    """
    global LAUNCHES
    n, M, k = check_mix_operands("compress_mix_weighted", z, S_in, w_self,
                                 w_edge)
    check_operand("msg", msg, z.device, z.dtype, (n, M))
    check_operand("mask", mask, z.device, z.dtype, (n, M))
    out = torch.empty_like(z)
    if n == 0 or M == 0:
        return out
    lib = library()
    fn = (lib.compress_mix_f32 if z.dtype == torch.float32
          else lib.compress_mix_bf16)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), msg.data_ptr(), mask.data_ptr(),
                 S_in.data_ptr(), w_self.data_ptr(), w_edge.data_ptr(),
                 out.data_ptr(), n, k, M, stream)
    if err != 0:
        raise RuntimeError(f"compress_mix kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
