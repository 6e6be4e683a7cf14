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
  * `uniform(key, shape)`      float32 `jax.random.uniform` in [0, 1)
                         (`random._uniform`)

A key is a pair of 0-d int64 tensors holding the two uint32 words. torch
has little uint32 arithmetic, so every word is held in int64 and each add,
shift and rotate is masked back to 32 bits. Everything runs on the device
of the tensors it is given, with no copy to the host: on the card these are
plain torch ops, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fold_in", "key", "random_bits", "threefry2x32", "uniform"]

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
    broadcast together."""
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


def fold_in(k: Key, t: torch.Tensor) -> Key:
    """`jax.random.fold_in(k, t.astype(jnp.int32))` for a 0-d tensor `t`
    (the simulator's float32 iteration counter): the data becomes the
    counter pair (0, uint32(int32(t))), hashed under `k`."""
    data = t.to(torch.int32).to(torch.int64) & _MASK32
    return threefry2x32(k[0], k[1], torch.zeros_like(data), data)


def random_bits(k: Key, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit `jax.random.bits(k, shape)`, partitionable: element i (in
    row-major order) hashes the counter pair (i >> 32, i & 0xFFFFFFFF), and
    its bits are the xor of the two output words. Returns int64 values in
    [0, 2**32)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=k[0].device).reshape(shape)
    b1, b2 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK32)
    return b1 ^ b2


def uniform(k: Key, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 `jax.random.uniform(k, shape)` in [0, 1): the top 23 bits
    become the mantissa of a float in [1, 2), from which 1 is taken."""
    bits = random_bits(k, shape)
    one = 0x3F800000  # float32 1.0
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
    return floats - 1.0

