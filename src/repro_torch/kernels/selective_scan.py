"""Kernel K6: the Mamba-1 selective scan, in CUDA.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t C_t + D x_t

The Hopper port of the Pallas kernel `repro.kernels.selective_scan.
selective_scan`: the TPU kernel carried the (d_block, N) state across
sequence chunks in VMEM scratch; the kernel (`csrc/selective_scan.cu`, where
its design and bound are written down) walks the sequence inside the block
with the state in registers, 4 to 16 lanes per channel, and splits the
sequence into pieces (a carry pass between two walks) only where the
channels alone do not fill the card.

`selective_scan` is the wrapper: it checks its inputs on the host, picks the
lanes and the pieces (`plan`), allocates the output and the workspace,
launches on the current stream without synchronizing, and counts its calls
in `LAUNCHES` (one per call, whatever the number of kernels) and the
kernels they launched in `KERNELS` (as the library reports them). It takes
float32 CUDA tensors only; `kernels.ops` casts to float32, as the
reference's front door does, and sends CPU tensors to the plain version in
`kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip_mix import check_on_card, check_operand

__all__ = ["KERNELS", "LAST_PLAN", "LAUNCHES", "MAX_N", "lanes", "library",
           "plan", "selective_scan"]

#: wrapper calls that launched the kernels since the count was last set to 0
LAUNCHES = 0
#: kernels those calls launched, counted by the library where it launches
KERNELS = 0
#: the largest state size the kernel takes (csrc/selective_scan.cu)
MAX_N = 64
#: `plan(...)` of the last call that launched
LAST_PLAN: dict | None = None

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
_INT_MAX = 2 ** 31 - 1
#: channels per block and tokens per staged chunk (kCB, kT in the source)
_CHANNELS, _CHUNK = 32, 32
#: warps an SM the sequence split aims at, and its shortest piece
_WARPS_PER_SM, _MIN_PIECE = 16, 64


def lanes(N: int) -> int:
    """Threads per channel for state size N: each holds two states (one for
    N <= 4, four for N > 32)."""
    return 4 if N <= 8 else 8 if N <= 16 else 16


def plan(Bt: int, S: int, d: int, N: int, sms: int = 132) -> dict:
    """How a call at these shapes runs on a card with `sms` SMs: the lanes
    per channel (`lanes(N)`), the pieces the sequence is split into
    (`nsplit`, so that about `_WARPS_PER_SM` warps an SM are in flight,
    pieces of at least `_MIN_PIECE` tokens, a whole number of staged chunks
    each), the kernels launched (1 for one piece, else pieces, carry,
    outputs) and the (Bt, nsplit, d, N) end states and decays the wrapper
    allocates for more than one piece."""
    L = lanes(N)
    threads = Bt * -(-d // _CHANNELS) * _CHANNELS * L
    want = max(1, sms * _WARPS_PER_SM * 32 // max(threads, 1))
    nsplit = max(1, min(want, -(-S // _MIN_PIECE), 65535))
    piece = -(-S // nsplit)
    piece = -(-piece // _CHUNK) * _CHUNK
    nsplit = -(-S // piece)
    workspace = (Bt, nsplit, d, N) if nsplit > 1 else None
    return {"kernels": 1 if nsplit == 1 else 3, "lanes": L,
            "nsplit": nsplit, "piece": piece, "workspace": workspace,
            "workspace_bytes": 0 if workspace is None
            else 2 * 4 * Bt * nsplit * d * N}


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/selective_scan.cu` (and the
    header `csrc/async_copy.cuh`) at first use."""
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
    (Bt, S, d) float32 tensor. The plan of the call (`plan`) is left in
    `LAST_PLAN`, with the bytes of the workspace it allocated.
    """
    global KERNELS, LAST_PLAN, LAUNCHES
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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    how = plan(Bt, S, d, N, sms)
    if how["workspace"] is None:
        state = decay = y  # not read with one piece
        allocated = 0
    else:
        state = torch.empty(how["workspace"], dtype=f32, device=x.device)
        decay = torch.empty_like(state)
        allocated = state.nbytes + decay.nbytes
    lib = library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D_skip.data_ptr(), y.data_ptr(), state.data_ptr(),
            decay.data_ptr(), Bt, S, d, N, how["lanes"], how["piece"],
            stream, ctypes.byref(launched))
    KERNELS += launched.value
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    LAST_PLAN = dict(how, workspace_bytes=allocated)
    return y
