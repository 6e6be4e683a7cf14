"""Kernel K5: the Mamba-2 SSD scan, in CUDA.

    h_t = exp(dt_t * A_h) h_{t-1} + (dt_t x_t) B_t^T,   y_t = h_t C_t

The Hopper port of the Pallas kernel `repro.kernels.ssd_scan.ssd_scan`, in
Mamba-2's chunked form, parallel across the sequence: three kernels per call
(`csrc/ssd_scan.cu`, where the design and bound are written down) compute
each chunk's own end state, carry the states across chunks, and compute the
outputs, with the products on the tensor cores in 3xTF32.

`ssd_scan` is the wrapper: it checks its inputs on the host, picks the
chunk length and the heads that share a block (`plan`), allocates the
output and the workspace, launches on the current stream without
synchronizing, and counts its calls in `LAUNCHES` (one per call, whatever
the number of kernels) and the kernels they launched in `KERNELS` (as the
library reports them). It takes float32 CUDA tensors only; `kernels.ops`
casts to float32, as the reference's front door does, and sends CPU
tensors to the plain version in `kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.gossip_mix import check_on_card, check_operand

__all__ = ["KERNELS", "KERNELS_PER_CALL", "LAST_PLAN", "LAUNCHES", "MAX_N",
           "chunk_length", "library", "plan", "ssd_scan"]

#: wrapper calls that launched the kernels since the count was last set to 0
LAUNCHES = 0
#: kernels those calls launched, counted by the library where it launches
KERNELS = 0
#: the largest state size the kernels take (kMaxN in csrc/ssd_scan.cu)
MAX_N = 220
#: chunk states, state passing, chunk outputs
KERNELS_PER_CALL = 3
#: `plan(...)` of the last call that launched
LAST_PLAN: dict | None = None

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
_INT_MAX = 2 ** 31 - 1
#: blocks of the output pass per SM the head grouping aims at: four waves
#: of the two that fit an SM at once at N <= 64
_WAVES = 8


def chunk_length(N: int) -> int:
    """The kernels' chunk length for state size N: 64 tokens while the
    output pass (C B^T, C and two heads' x and states;
    `out_smem_floats` in csrc/ssd_scan.cu) fits a block's shared memory,
    to N = 128, else 32. At N <= 64 two output blocks share an SM."""
    return 64 if (N + 7) // 8 * 8 <= 128 else 32


def plan(Bt: int, S: int, H: int, P: int, N: int, sms: int = 132) -> dict:
    """How a call at these shapes runs on a card with `sms` SMs: the
    kernels it launches, the chunk length Q (`chunk_length(N)`), the heads
    that share one output block's C B^T (enough blocks for about `_WAVES`
    per SM, at most 8 heads), and the workspace the wrapper allocates: the
    (Bt, H, nc, P, N) chunk states and the (Bt, H, nc) chunk decays, nc =
    ceil(S / Q)."""
    Q = chunk_length(N)
    nc = -(-S // Q)
    ptiles = -(-P // 64)
    per_group = max(nc * ptiles * Bt, 1)
    heads = min(8, max(1, -(-H * per_group // (_WAVES * sms))))
    heads = -(-H // -(-H // heads))  # the same heads in every group
    return {"kernels": KERNELS_PER_CALL, "chunk": Q, "chunks": nc,
            "heads_per_block": heads, "workspace": (Bt, H, nc, P, N),
            "decay": (Bt, H, nc),
            "workspace_bytes": 4 * (Bt * H * nc * P * N + Bt * H * nc)}


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/ssd_scan.cu` (and the header
    `csrc/async_copy.cuh`) at first use."""
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
    new (Bt, S, H, P) float32 tensor (no D skip, no gating). The workspace
    (`plan(...)["workspace_bytes"]`) is freed when the call returns; the
    plan of the call is left in `LAST_PLAN`, with the bytes of the
    workspace it allocated.
    """
    global KERNELS, LAST_PLAN, LAUNCHES
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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    how = plan(Bt, S, H, P, N, sms)
    ws = torch.empty(how["workspace"], dtype=f32, device=x.device)
    decay = torch.empty(how["decay"], dtype=f32, device=x.device)
    lib = library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_f32(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                               B.data_ptr(), C.data_ptr(), y.data_ptr(),
                               ws.data_ptr(), decay.data_ptr(), Bt, S, H, P,
                               N, how["chunk"], how["heads_per_block"],
                               stream, ctypes.byref(launched))
    with counters.LOCK:
        KERNELS += launched.value
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err}")
    with counters.LOCK:
        LAUNCHES += 1
    LAST_PLAN = dict(how, workspace_bytes=ws.nbytes + decay.nbytes)
    return y
