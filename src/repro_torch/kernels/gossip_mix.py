"""Kernels K1 and K3: the gossip mixes, in CUDA.

K1, the weighted gossip mix on a stacked node state:

    out[i] = w_self[i] * z[i] + sum_{j<k} w_edge[i, j] * msg[S_in[i, j]]

The Hopper port of the Pallas kernel `repro.kernels.gossip_mix.
gossip_mix_weighted` and the gather in front of it (`repro.kernels.ops.
gossip_gather_mix_impl`): the kernel (`csrc/gossip_mix.cu`, where its
design and bound are written down) reads the k neighbor rows through S_in
itself, so the gathered (k, n, M) stack the TPU version was handed is never
built. It is bandwidth-bound: one pass over z, msg and out. The library
launches its slab kernel, which stages each slab of msg's columns in shared
memory once, whenever that kernel takes the call, and its register kernel
for the rest (ragged M, unaligned views, k > 8, n too large for the slab);
both give the same bits, and `FORM_LAUNCHES` counts the calls of each.

K3, the flat per-node mix with scalar weights:

    out[m] = sw * self[m] + ew * sum_{j<k} nbr[j, m]

The Hopper port of the Pallas kernel `repro.kernels.gossip_mix.gossip_mix`
and the padding of its front door `repro.kernels.ops.gossip_mix`: a
grid-stride loop over the flat buffer needs no (8, 1024) tiles, so nothing
is padded. Bandwidth-bound: one pass over self, the k received buffers and
out.

`gossip_mix_weighted` (K1) and `gossip_mix` (K3) are the wrappers: each
checks its inputs on the host, allocates the output, launches on the
current stream without synchronizing, and counts its launches (`LAUNCHES`
for K1, `FLAT_LAUNCHES` for K3). They take CUDA tensors only;
`kernels.ops` sends CPU tensors to the plain versions in `kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters

__all__ = ["FLAT_LAUNCHES", "FORM_LAUNCHES", "LAUNCHES",
           "check_mix_operands", "check_on_card", "check_operand",
           "gossip_mix", "gossip_mix_weighted", "library"]

#: launches of K1 since the count was last set to 0
LAUNCHES = 0
#: launches of K3 since the count was last set to 0
FLAT_LAUNCHES = 0
#: launches of K1 since the counts were last set to 0, by the kernel the
#: library reported: "slab" (a slab of columns of all rows of msg staged in
#: shared memory once) or "regs" (each output row's k + 1 input rows loaded
#: into registers; csrc/gossip_mix.cu)
FORM_LAUNCHES = {"regs": 0, "slab": 0}

_FORM_NAMES = ("regs", "slab")  # by the `form` the library reports
_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_FLAT_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64]
                  + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1
_SMS: dict[int, int] = {}  # SMs of each card, by device index


def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/gossip_mix.cu` at first use."""
    lib = build.load("gossip_mix")
    if lib.gossip_mix_f32.argtypes is None:
        for fn in (lib.gossip_mix_f32, lib.gossip_mix_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        for fn in (lib.gossip_mix_flat_f32, lib.gossip_mix_flat_bf16):
            fn.argtypes = _FLAT_ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def check_on_card(kernel: str, t) -> None:
    """Raise unless `t` is a CUDA tensor: a wrapper launches its kernel or
    raises, and `kernels.ops` sends CPU tensors to the plain versions."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors only; kernels.ops "
                         f"sends CPU tensors to the plain version")


def check_operand(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_mix_operands(kernel: str, z: torch.Tensor, S_in: torch.Tensor,
                       w_self: torch.Tensor, w_edge: torch.Tensor
                       ) -> tuple[int, int, int]:
    """The host checks a gossip-mix kernel (K1, K2) makes before it
    launches: z is a contiguous (n, M) float32 or bfloat16 CUDA tensor,
    S_in (n, k) int64, w_self (n,) and w_edge (n, k) float32, all on z's
    device and inside the kernel's 32-bit extents. Returns (n, M, k)."""
    check_on_card(kernel, z)
    if z.dtype not in _DTYPES:
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"z must be (n, M), got shape {tuple(z.shape)}")
    n, M = z.shape
    if S_in.dim() != 2 or S_in.shape[0] != n or S_in.shape[1] < 1:
        raise ValueError(f"S_in must be (n, k) with n={n} and k >= 1, got "
                         f"{tuple(S_in.shape)}")
    k = S_in.shape[1]
    if max(n, M, n * k) > _INT_MAX:
        raise ValueError(f"shape ({n}, {M}) with k={k} exceeds the "
                         f"kernel's 32-bit extents")
    check_operand("z", z, z.device, z.dtype, (n, M))
    check_operand("S_in", S_in, z.device, torch.int64, (n, k))
    check_operand("w_self", w_self, z.device, torch.float32, (n,))
    check_operand("w_edge", w_edge, z.device, torch.float32, (n, k))
    return n, M, k


def gossip_mix_weighted(z: torch.Tensor, S_in: torch.Tensor,
                        w_self: torch.Tensor, w_edge: torch.Tensor,
                        msg: torch.Tensor | None = None) -> torch.Tensor:
    """One weighted gossip round on the card.

    z: (n, M) float32 or bfloat16, contiguous, on a CUDA device; S_in:
    (n, k) int64 in-neighbor indices; w_self: (n,) and w_edge: (n, k)
    float32 weights; msg: the transmitted stack, like z, or None for z
    itself. Accumulates in float32 and returns a new (n, M) tensor in z's
    dtype.

    The range 0 <= S_in < n is checked by the kernel on the device (a
    device-side assert, raised by the next synchronizing call, as PyTorch's
    own CUDA index ops do): a host-side check would copy S_in back and wait
    for the card on every launch.
    """
    global LAUNCHES
    n, M, k = check_mix_operands("gossip_mix_weighted", z, S_in, w_self,
                                 w_edge)
    if msg is None:
        msg = z
    else:
        check_operand("msg", msg, z.device, z.dtype, (n, M))
    out = torch.empty_like(z)
    if n == 0 or M == 0:
        return out
    lib = library()
    fn = lib.gossip_mix_f32 if z.dtype == torch.float32 else lib.gossip_mix_bf16
    device = z.device.index
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    form = ctypes.c_int(-1)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), msg.data_ptr(), S_in.data_ptr(),
                 w_self.data_ptr(), w_edge.data_ptr(), out.data_ptr(),
                 n, k, M, _SMS[device], ctypes.byref(form), stream)
    if err != 0:
        raise RuntimeError(f"gossip_mix kernel launch failed with CUDA "
                           f"error {err}")
    with counters.LOCK:
        LAUNCHES += 1
        FORM_LAUNCHES[_FORM_NAMES[form.value]] += 1
    return out


def gossip_mix(self_buf: torch.Tensor, neighbor_bufs: torch.Tensor,
               self_weight: float, edge_weight: float) -> torch.Tensor:
    """One node's flat gossip mix on the card (K3).

    self_buf: (M,) float32 or bfloat16, contiguous, on a CUDA device;
    neighbor_bufs: (k, M) received buffers, like self_buf, k >= 1;
    self_weight, edge_weight: scalars. Accumulates in float32 and returns a
    new (M,) tensor in self_buf's dtype.
    """
    global FLAT_LAUNCHES
    check_on_card("gossip_mix", self_buf)
    if self_buf.dtype not in _DTYPES:
        raise TypeError(f"self_buf must be float32 or bfloat16, got "
                        f"{self_buf.dtype}")
    if self_buf.dim() != 1:
        raise ValueError(f"self_buf must be (M,), got shape "
                         f"{tuple(self_buf.shape)}")
    (M,) = self_buf.shape
    if neighbor_bufs.dim() != 2 or neighbor_bufs.shape[0] < 1:
        raise ValueError(f"neighbor_bufs must be (k, {M}) with k >= 1, got "
                         f"{tuple(neighbor_bufs.shape)}")
    k = neighbor_bufs.shape[0]
    if k > _INT_MAX:
        raise ValueError(f"k={k} exceeds the kernel's 32-bit count")
    check_operand("self_buf", self_buf, self_buf.device, self_buf.dtype,
                  (M,))
    check_operand("neighbor_bufs", neighbor_bufs, self_buf.device,
                  self_buf.dtype, (k, M))
    out = torch.empty_like(self_buf)
    if M == 0:
        return out
    lib = library()
    fn = (lib.gossip_mix_flat_f32 if self_buf.dtype == torch.float32
          else lib.gossip_mix_flat_bf16)
    with torch.cuda.device(self_buf.device):
        stream = torch.cuda.current_stream(self_buf.device).cuda_stream
        err = fn(self_buf.data_ptr(), neighbor_bufs.data_ptr(),
                 out.data_ptr(), k, M, float(self_weight), float(edge_weight),
                 stream)
    if err != 0:
        raise RuntimeError(f"gossip_mix (K3) kernel launch failed with CUDA "
                           f"error {err}")
    with counters.LOCK:
        FLAT_LAUNCHES += 1
    return out
