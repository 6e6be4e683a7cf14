"""jax's threefry2x32 random bits, in torch ops.

The randomized compressors draw their support (`RandK`) and their rounding
noise (stochastic `Int8`) from `jax.random` in the reference, as a pure
function of `(seed, t)`: shared randomness that the receiver replays. The
port reproduces those bits exactly, so a compressed run gives the
reference's result and not only its distribution. What is reproduced is
jax 0.9.0 with `jax_threefry_partitionable` on (its default) and the
`threefry2x32` implementation:

  * `key(seed)`          `jax.random.PRNGKey(seed)` (`prng.threefry_seed`)
  * `fold_in(key, t)`    `jax.random.fold_in(key, t.astype(int32))`
                         (`prng.threefry_fold_in`)
  * `random_bits(key, shape)`  32-bit `jax.random.bits`
                         (`prng._threefry_random_bits_partitionable`)
  * `uniform(key, shape, minval, maxval)`  float32 `jax.random.uniform`
                         (`random._uniform`), in [0, 1) by default
  * `split(key, num)`    `jax.random.split` (`prng._threefry_split_foldlike`)
  * `truncated_normal(key, lower, upper, shape)`  float32
                         `jax.random.truncated_normal`
                         (`random._truncated_normal`), with XLA's float32
                         `ErfInv` polynomial (`erf_inv`); with `block=`
                         any block of the draw alone (one rank's shard)

A key is a pair of 0-d int64 tensors holding the two uint32 words. torch
has little uint32 arithmetic, so every word is held in int64 and each add,
shift and rotate is masked back to 32 bits. Everything runs on the device
of the tensors it is given, with no copy to the host: on the card these are
plain torch ops, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math

import torch

__all__ = ["bits_at", "erf_inv", "fold_in", "key", "random_bits", "split",
           "threefry2x32", "truncated_normal", "uniform"]

_MASK32 = 0xFFFFFFFF
#: the rotation schedule and key-parity constant of Threefry-2x32
#: (Salmon et al., SC'11), as jax's `_threefry2x32_lowering` has them
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1

Key = tuple[torch.Tensor, torch.Tensor]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _MASK32) | (v >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); all uint32 values held in int64 tensors that
    broadcast together. On the meta device only the shape is made."""
    if k1.device.type == "meta":
        shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape,
                                       x2.shape)
        return (torch.empty(shape, dtype=torch.int64, device="meta"),
                torch.empty(shape, dtype=torch.int64, device="meta"))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK32
    y0 = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y0) & _MASK32
            y0 = _rotl(y0, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        y0 = (y0 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, y0


def key(seed: int, device=None) -> Key:
    """`jax.random.PRNGKey(seed)` with 64-bit jax off: the seed is an int32,
    so the high word is 0 and the low word its two's complement."""
    seed = int(seed)
    if not _INT32_MIN <= seed <= _INT32_MAX:
        raise ValueError(f"seed {seed} is outside int32, which jax takes "
                         f"with 64-bit mode off")
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.full((), seed & _MASK32, dtype=torch.int64, device=device))


def fold_in(k: Key, t) -> Key:
    """`jax.random.fold_in(k, t.astype(jnp.int32))` for a 0-d tensor `t`
    (the simulator's float32 iteration counter) or a Python int (the model
    init's layer index): the data becomes the counter pair
    (0, uint32(int32(t))), hashed under `k`."""
    if isinstance(t, torch.Tensor):
        data = t.to(torch.int32).to(torch.int64) & _MASK32
    else:
        data = torch.full((), int(t) & _MASK32, dtype=torch.int64,
                          device=k[0].device)
    return threefry2x32(k[0], k[1], torch.zeros_like(data), data)


def split(k: Key, num: int = 2) -> list[Key]:
    """`jax.random.split(k, num)` under threefry-partitionable: key i is
    the hash of the counter pair (0, i), both output words kept."""
    idx = torch.arange(num, dtype=torch.int64, device=k[0].device)
    w1, w2 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK32)
    return [(w1[i], w2[i]) for i in range(num)]


def bits_at(k: Key, idx: torch.Tensor) -> torch.Tensor:
    """The 32-bit draws of the elements at the flat row-major indices
    `idx` (an int64 tensor) of a partitionable draw under `k`: element i
    hashes the counter pair (i >> 32, i & 0xFFFFFFFF), and its bits are
    the xor of the two output words, whatever other elements are drawn
    beside it. int64 values in [0, 2**32), shaped like `idx`."""
    b1, b2 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK32)
    return b1 ^ b2


def _bits(k: Key, start: int, count: int) -> torch.Tensor:
    """The 32-bit draws of elements start .. start + count - 1 of a
    row-major draw: `bits_at` of a contiguous run."""
    return bits_at(k, torch.arange(start, start + count, dtype=torch.int64,
                                   device=k[0].device))


Block = tuple[tuple[int, int], ...]


def _block_indices(shape: tuple[int, ...], block: Block, start: int,
                   count: int, device) -> torch.Tensor:
    """The flat row-major indices in `shape` of elements start .. start +
    count - 1 of `block` (an (offset, length) pair a dimension), taken in
    the block's own row-major order."""
    rem = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    idx = torch.zeros_like(rem)
    stride = 1
    for d in reversed(range(len(shape))):
        off, length = block[d]
        if d:
            i, rem = rem % length, rem // length
        else:
            i = rem
        idx += (i + off) * stride
        stride *= shape[d]
    return idx


def random_bits(k: Key, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit `jax.random.bits(k, shape)`, partitionable: element i (in
    row-major order) hashes the counter pair (i >> 32, i & 0xFFFFFFFF), and
    its bits are the xor of the two output words. Returns int64 values in
    [0, 2**32)."""
    return _bits(k, 0, math.prod(shape)).reshape(shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits become the mantissa of a float in [1, 2), from which
    1 is taken: float32 in [0, 1)."""
    one = 0x3F800000  # float32 1.0
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
    return floats - 1.0


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 `a * b + c` rounded once, as XLA's CPU backend fuses it into
    a fused multiply-add: the float32 product is exact in float64, so the
    float64 sum rounded to float32 is the fused result (bar a double
    rounding, which a 53-bit sum of these operands does not meet)."""
    return (a.double() * b.double() + c.double()).float()


def _scaled(floats: torch.Tensor, minval: float, maxval: float
            ) -> torch.Tensor:
    """`max(minval, floats * (maxval - minval) + minval)` in float32, as
    `random._uniform` ends (the multiply-add fused)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def uniform(k: Key, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 `jax.random.uniform(k, shape, minval=, maxval=)`; in [0, 1)
    by default, where the scaling is the identity and is skipped."""
    floats = _unit_floats(random_bits(k, shape))
    if minval == 0.0 and maxval == 1.0:
        return floats
    return _scaled(floats, minval, maxval)


#: XLA's float32 ErfInv (Giles, "Approximating the erfinv function", GPU
#: Computing Gems Jade, 2011), as stablehlo's chlo decomposition has it:
#: Horner coefficients for w < 5 and for w >= 5; each Horner step is a
#: fused multiply-add on XLA's CPU backend
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 `lax.erf_inv` as XLA computes it (its polynomial, not
    `torch.erfinv`'s, which rounds differently)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = dict(dtype=torch.float32, device=x.device)
    p = torch.where(lt, torch.tensor(_ERFINV_LT5[0], **f32),
                    torch.tensor(_ERFINV_GE5[0], **f32))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.tensor(c_lt, **f32),
                        torch.tensor(c_ge, **f32))
        p = _fma(p, w, c)
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


#: elements a truncated-normal draw makes at once: int64 words of this many
#: elements are a few hundred MB, whatever the leaf's size
_CHUNK = 1 << 25


def truncated_normal(k: Key, lower: float, upper: float,
                     shape: tuple[int, ...], *, scale: float | None = None,
                     out_dtype: torch.dtype = torch.float32,
                     block: Block | None = None) -> torch.Tensor:
    """float32 `jax.random.truncated_normal(k, lower, upper, shape)`:
    `sqrt2 * erf_inv(uniform(k, minval=erf(lower/sqrt2),
    maxval=erf(upper/sqrt2)))`, clipped into the open interval.

    `scale` multiplies the float32 draw and `out_dtype` is the cast after
    it, as `models.common.p` does with the result; the draw is made in
    chunks of elements, each the whole draw's, so a leaf of hundreds of
    millions of elements never holds its int64 words at once. On the
    meta device it returns the draw's shape and dtype alone (the
    counterpart of `jax.eval_shape` over an init).

    `block` ((offset, length) a dimension) draws that block of the draw
    alone, each element with the bits it has in the whole draw (its flat
    index in `shape`), in chunks of the block's elements: a rank's shard
    of a leaf, which is never made whole."""
    dev = k[0].device
    out_shape = tuple(shape) if block is None else tuple(
        length for _, length in block)
    if dev.type == "meta":
        return torch.empty(out_shape, dtype=out_dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    sqrt2 = torch.tensor(math.sqrt(2.0), **f32)
    lo = torch.tensor(lower, **f32)
    hi = torch.tensor(upper, **f32)
    # the bounds' erf on the host, whatever the device: the CPU's float32
    # erf is jax's at these points
    a = float(torch.erf(lo.cpu() / sqrt2.cpu()))
    b = float(torch.erf(hi.cpu() / sqrt2.cpu()))
    lo_open = torch.nextafter(lo, torch.tensor(math.inf, **f32))
    hi_open = torch.nextafter(hi, torch.tensor(-math.inf, **f32))
    out = torch.empty(math.prod(out_shape), dtype=out_dtype, device=dev)
    for start in range(0, out.numel(), _CHUNK):
        count = min(_CHUNK, out.numel() - start)
        bits = (_bits(k, start, count) if block is None else bits_at(
            k, _block_indices(tuple(shape), block, start, count, dev)))
        u = _scaled(_unit_floats(bits), a, b)
        val = torch.clamp(sqrt2 * erf_inv(u), lo_open, hi_open)
        if scale is not None:
            val = scale * val
        out[start:start + count] = val
    return out.reshape(out_shape)

