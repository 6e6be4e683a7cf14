"""Kernel K4: flash attention (forward), in CUDA.

    out[b, h] = softmax(q[b, h] k[b, h // G]^T / sqrt(D) + mask) v[b, h // G]

The Hopper port of the Pallas kernel `repro.kernels.flash_attention.
flash_attention`: GQA by kv head `h // (H / KH)`, the causal mask top-left
aligned (query row r sees key columns c <= r, the TPU kernel's
`rows >= cols`), fp32 arithmetic on fp32 or bf16 inputs, out in q's dtype.
The kernel (`csrc/flash_attention.cu`, where its design and bound are
written down) skips the key tiles above the diagonal instead of loading
them.

`flash_attention` is the wrapper: it checks its inputs on the host,
allocates the output, launches on the current stream without
synchronizing, and counts its launches in `LAUNCHES`. It takes CUDA
tensors only; `kernels.ops` sends CPU tensors to the plain version in
`kernels.ref`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip_mix import check_on_card, check_operand

__all__ = ["LAUNCHES", "MAX_D", "flash_attention", "library"]

#: launches of the kernel since the count was last set to 0
LAUNCHES = 0
#: the largest head dim the kernel takes (csrc/flash_attention.cu)
MAX_D = 256

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])
_GRID_MAX = 65535
_INT_MAX = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/flash_attention.cu` at first
    use."""
    lib = build.load("flash_attention")
    if lib.flash_attention_f32.argtypes is None:
        for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward on the card (K4).

    q: (B, H, Sq, D) float32 or bfloat16, contiguous, on a CUDA device;
    k, v: (B, KH, Sk, D) like q, H % KH == 0, D <= MAX_D. The causal mask
    is top-left aligned; sm_scale is 1 / sqrt(D). Returns a new
    (B, H, Sq, D) tensor in q's dtype.
    """
    global LAUNCHES
    check_on_card("flash_attention", q)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if KH < 1 or H % KH:
        raise ValueError(f"H={H} is not a multiple of KH={KH}")
    if D > MAX_D:
        raise ValueError(f"head dim D={D} exceeds the kernel's {MAX_D}")
    if max(B, H) > _GRID_MAX or max(Sq, Sk) > _INT_MAX:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    check_operand("q", q, q.device, q.dtype, (B, H, Sq, D))
    check_operand("k", k, q.device, q.dtype, (B, KH, Sk, D))
    check_operand("v", v, q.device, q.dtype, (B, KH, Sk, D))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:
        raise ValueError("k and v hold no keys (Sk=0)")
    lib = library()
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, KH, Sq, Sk, D, int(bool(causal)),
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
