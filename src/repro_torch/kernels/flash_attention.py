"""Kernel K4: flash attention (forward), in CUDA, on two routes.

    out[b, h] = softmax(q[b, h] k[b, h // G]^T / sqrt(D) + mask) v[b, h // G]

The Hopper port of the Pallas kernel `repro.kernels.flash_attention.
flash_attention`: GQA by kv head `h // (H / KH)`, the causal mask top-left
aligned (query row r sees key columns c <= r, the TPU kernel's
`rows >= cols`), fp32 arithmetic, out in q's dtype. `route(dtype, D)` picks
the kernel:

  "sm90"    bf16 with D a multiple of 8 (TMA's 16-byte rows):
            `csrc/flash_attention_sm90.cu`, wgmma on the bf16 tensor cores
            fed by TMA, P split into two bf16 halves so that P V keeps
            about 16 bits of P (the reference's fp32 function to within
            summation order)
  "tf32x3"  everything else, fp32 above all: `csrc/flash_attention.cu`,
            3xTF32 on the tensor cores (mma.sync). One TF32 pass rounds
            each operand to 10 mantissa bits and misses the fp32 tolerance
            (atol 2e-5, rtol 2e-4); three passes, a_big b_big + a_big
            b_small + a_small b_big over each operand's TF32 part and the
            TF32 part of its remainder, drop only a_small b_small, below
            2^-22 of the product, and hold it
            (tests/test_torch_attention_forms.py shows both on the CPU)

Both kernels skip the key tiles above the diagonal instead of loading them.

`flash_attention` is the wrapper: it checks its inputs on the host,
allocates the output, launches the route's kernel on the current stream
without synchronizing, and counts its launches: `LAUNCHES` in all, and
`SM90_LAUNCHES` and `TF32X3_LAUNCHES` by route. There is no fallback: a
route's kernel that fails to build or launch raises. It takes CUDA tensors
only; `kernels.ops` sends CPU tensors to the plain version in `kernels.ref`.
`_flash_attention_fp32_out` is the sm90 kernel with an fp32 output, a
verification entry that `kernels.ops` never calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.gossip_mix import check_on_card, check_operand

__all__ = ["LAUNCHES", "MAX_D", "ROUTES", "SM90_LAUNCHES",
           "TF32X3_LAUNCHES", "flash_attention", "library", "route"]

#: launches of either kernel since the count was last set to 0
LAUNCHES = 0
#: launches by route (they sum to LAUNCHES when all three are set together)
SM90_LAUNCHES = 0
TF32X3_LAUNCHES = 0
#: the largest head dim the kernels take (csrc/flash_attention*.cu)
MAX_D = 256
#: route -> (source stem, entry point by out dtype)
ROUTES = {
    "sm90": ("flash_attention_sm90",
             {torch.bfloat16: "flash_attention_sm90_bf16",
              torch.float32: "flash_attention_sm90_bf16_f32out"}),
    "tf32x3": ("flash_attention",
               {torch.float32: "flash_attention_f32",
                torch.bfloat16: "flash_attention_bf16"}),
}

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])
_GRID_MAX = 65535
_INT_MAX = 2 ** 31 - 1
#: flash_attention_sm90.cu adds this to the CUresult of a refused tensor map
_ENCODE_ERROR = 100000


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes inputs of `dtype` and head dim `D`: "sm90" for
    bf16 with D a multiple of 8 (a TMA row is a multiple of 16 bytes), else
    "tf32x3"."""
    return "sm90" if dtype == torch.bfloat16 and D % 8 == 0 else "tf32x3"


def library(name: str) -> ctypes.CDLL:
    """The kernel library of route `name` ("sm90" or "tf32x3"), built
    from its source at first use."""
    stem, entries = ROUTES[name]
    lib = build.load(stem)
    for entry in entries.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
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
    return B, H, KH, Sq, Sk, D


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out_dtype: torch.dtype, causal: bool) -> torch.Tensor:
    """Launch route `name`'s kernel on checked inputs into a new tensor of
    `out_dtype`, and count it."""
    global LAUNCHES, SM90_LAUNCHES, TF32X3_LAUNCHES
    B, H, KH, Sq, Sk, D = _check(q, k, v)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:
        raise ValueError("k and v hold no keys (Sk=0)")
    if name == "sm90":
        for label, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{label} must start on a 16-byte boundary "
                                 f"for the sm90 route's tensor maps")
    stem, entries = ROUTES[name]
    fn = getattr(library(name), entries[out_dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, KH, Sq, Sk, D, int(bool(causal)),
                 1.0 / math.sqrt(D), stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"{stem}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"{stem} kernel launch failed with CUDA error "
                           f"{err}")
    with counters.LOCK:
        LAUNCHES += 1
        if name == "sm90":
            SM90_LAUNCHES += 1
        else:
            TF32X3_LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward on the card (K4), on the kernel `route` names.

    q: (B, H, Sq, D) float32 or bfloat16, contiguous, on a CUDA device;
    k, v: (B, KH, Sk, D) like q, H % KH == 0, D <= MAX_D. The causal mask
    is top-left aligned; sm_scale is 1 / sqrt(D). Returns a new
    (B, H, Sq, D) tensor in q's dtype.
    """
    D = q.shape[-1] if q.dim() else 0
    return _launch(route(q.dtype, D), q, k, v, q.dtype, causal)


def _flash_attention_fp32_out(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              causal: bool = True) -> torch.Tensor:
    """The sm90 kernel with an fp32 output: bf16 q, k, v as `flash_attention`
    takes them (D a multiple of 8), out (B, H, Sq, D) float32, unrounded.
    Held to the fp32 tolerance against the plain version on fp32 copies of
    the inputs, it shows that P V keeps P to about 16 bits."""
    D = q.shape[-1] if q.dim() else 0
    if route(q.dtype, D) != "sm90":
        raise ValueError(f"the fp32-out entry takes bf16 inputs with D a "
                         f"multiple of 8, got {q.dtype} D={D}")
    return _launch("sm90", q, k, v, torch.float32, causal)
