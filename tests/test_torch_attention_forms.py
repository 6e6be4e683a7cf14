"""The algebra of kernel K4's "tf32x3" route (csrc/flash_attention.cu) on
the CPU: a plain-torch mirror of what the kernel computes, held against the
reference's Pallas kernel run in interpret mode
(`repro.kernels.ops.flash_attention(..., interpret=True)`), and the
precision decision behind the route.

- TF32 rounding as `split_tf32` (csrc/tf32x3.cuh) does it on the float
  bits: big = the fp32 mantissa rounded to 10 bits, ties away from zero;
  small = the exact remainder with its low 13 bits dropped.
- The three products a big b big + a big b small + a small b big, each
  term of S into its own partial sum, and the three terms of P V added to
  the output accumulator in turn. Products of TF32 values are exact in
  fp32, so an fp32 matmul of the parts is what the tensor cores add up, to
  within summation order.
- The tiled online softmax: key tiles of BK columns, the running max in
  the log2 domain, masked scores at -1e30, the accumulator rescaled by each
  tile's correction, a row whose sum is 0 divided by 1.
- The fragment permutations of mma.sync m16n8k8, lane by lane: the slots
  of S's contraction over D (lane t takes columns 4t .. 4t + 3 of 16), the
  key slots of P V (slot t is key 2t, slot t + 4 is key 2t + 1, so that S's
  accumulator registers are P V's A fragment), and the output columns that
  follow from V's B fragment.

The mirror is held at `ATTN_TOL["float32"]` of chip_smoke.py (atol 2e-5,
rtol 2e-4, tests/test_kernels.py's fp32 tolerance); a single TF32 pass
misses it, which is why the route runs three.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops

from repro_torch.kernels import ref

ATTN_TOL = dict(atol=2e-5, rtol=2e-4)
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _attention_inputs(B, H, KH, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, KH, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, KH, Sk, D)).astype(np.float32)
    return q, k, v


# ---- TF32 ------------------------------------------------------------------

def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (big, small) as csrc/tf32x3.cuh's `split_tf32`, on the bit
    patterns: big = (bits + 0x1000) & 0xffffe000, small = the bits of
    t - big & 0xffffe000."""
    bits = t.contiguous().numpy().view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    rest = (t.numpy() - big).astype(np.float32)
    small = (rest.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return torch.from_numpy(big.copy()), torch.from_numpy(small.copy())


def mm3(a: torch.Tensor, b: torch.Tensor) -> list[torch.Tensor]:
    """The three terms of a @ b in 3xTF32, in the order the kernel issues
    them: a_small b_big, a_big b_small, a_big b_big."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return [a_small @ b_big, a_big @ b_small, a_big @ b_big]


def mm1(a: torch.Tensor, b: torch.Tensor) -> list[torch.Tensor]:
    """One TF32 pass: both operands rounded, one product."""
    return [split_tf32(a)[0] @ split_tf32(b)[0]]


def test_split_tf32_keeps_ten_bits_and_the_remainder():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12, 0.0],
                     dtype=torch.float32)
    big, small = split_tf32(x)
    assert torch.equal(big, torch.tensor(
        [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, 1.0,
         0.0]))                                      # ties away from zero
    assert torch.equal(split_tf32(-x)[0], -big)
    assert torch.equal(big + small, x)               # these remainders fit
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    big, small = split_tf32(y)
    for part in (big, small):
        assert not (part.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    assert ((big + small - y).abs() <= 2.0 ** -21 * y.abs()).all()


# ---- the fragment permutations ---------------------------------------------

def _lanes():
    """(g, t) of the 32 lanes: g = lane / 4, t = lane % 4."""
    return [(lane // 4, lane % 4) for lane in range(32)]


def _mma(a_regs, b_regs):
    """mma.sync m16n8k8 from per-lane registers: A (16 x 8) from a0 (g, t),
    a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B (8 x 8) from b0 (t, g),
    b1 (t+4, g); returns D = A B by the C layout c0 (g, 2t), c1 (g, 2t+1),
    c2 (g+8, 2t), c3 (g+8, 2t+1), per lane."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for (g, t), a, b in zip(_lanes(), a_regs, b_regs):
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a
        B[t, g], B[t + 4, g] = b
    C = A @ B
    return [(C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
             C[g + 8, 2 * t + 1]) for g, t in _lanes()]


def test_s_fragments_permute_the_contraction_over_d():
    """S = Q K^T over 16 columns of D as the kernel loads it: lane (g, t)
    reads columns 4t .. 4t + 3 of rows g and g + 8 of Q and of key row g of
    K (16-byte loads); step 0 takes (4t, 4t + 1) as slots (t, t + 4), step
    1 takes (4t + 2, 4t + 3). The two steps sum to the plain product."""
    rng = np.random.default_rng(1)
    Q = rng.normal(size=(16, 16))
    K = rng.normal(size=(8, 16))    # 8 keys, 16 columns of D
    total = np.zeros((16, 8))
    for step in (0, 1):
        a = [(Q[g, 4 * t + 2 * step], Q[g + 8, 4 * t + 2 * step],
              Q[g, 4 * t + 2 * step + 1], Q[g + 8, 4 * t + 2 * step + 1])
             for g, t in _lanes()]
        b = [(K[g, 4 * t + 2 * step], K[g, 4 * t + 2 * step + 1])
             for g, t in _lanes()]
        for (g, t), c in zip(_lanes(), _mma(a, b)):
            total[g, 2 * t:2 * t + 2] += c[:2]
            total[g + 8, 2 * t:2 * t + 2] += c[2:]
    np.testing.assert_allclose(total, Q @ K.T, rtol=1e-12, atol=1e-12)


def test_pv_takes_s_registers_as_its_a_fragment():
    """P V over one 8-key group: the A fragment is S's accumulator (c0, c2,
    c1, c3) of the lane, unshuffled, so slot t is key 2t and slot t + 4 key
    2t + 1; V's B fragment reads keys 2t and 2t + 1 at column 2g + j of a
    16-column group for the n-blocks j = 0, 1; the lane's output row g then
    holds columns 4t .. 4t + 3 of the group as (c0 of j=0, c0 of j=1, c1 of
    j=0, c1 of j=1), stored 16 bytes at a time. That is P V, column for
    column."""
    rng = np.random.default_rng(2)
    P = rng.random(size=(16, 8))
    V = rng.normal(size=(8, 16))    # 8 keys, one 16-column group
    s_regs = [(P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t],
               P[g + 8, 2 * t + 1]) for g, t in _lanes()]   # S's C layout
    a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in s_regs]
    out = np.full((16, 16), np.nan)
    d = [_mma(a, [(V[2 * t, 2 * g + j], V[2 * t + 1, 2 * g + j])
                  for g, t in _lanes()]) for j in (0, 1)]
    for lane, (g, t) in enumerate(_lanes()):
        out[g, 4 * t:4 * t + 4] = (d[0][lane][0], d[1][lane][0],
                                   d[0][lane][1], d[1][lane][1])
        out[g + 8, 4 * t:4 * t + 4] = (d[0][lane][2], d[1][lane][2],
                                       d[0][lane][3], d[1][lane][3])
    np.testing.assert_allclose(out, P @ V, rtol=1e-12, atol=1e-12)


# ---- the kernel's function, tile by tile -----------------------------------

def flash_mirror(q, k, v, causal=True, BK=32, passes=mm3):
    """csrc/flash_attention.cu's tf32x3 kernel in plain torch, fp32: for
    each key tile of BK keys, S in three partial sums ((small big + big
    small) + big big), masked to -1e30, the online softmax in the log2
    domain, then the three terms of P V added to the rescaled accumulator
    in turn; out = acc / l, l = 0 read as 1. Tiles above a row's diagonal
    add exactly nothing (p = 0, the correction 1), so skipping them, as the
    kernel does, gives the same result."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // KH, dim=1)
    vr = v.repeat_interleave(H // KH, dim=1)
    scale_log2 = torch.tensor(1.0 / math.sqrt(D) * LOG2E,
                              dtype=torch.float32)
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Sk, BK):
        kt, vt = kr[:, :, k0:k0 + BK], vr[:, :, k0:k0 + BK]
        terms = passes(q, kt.transpose(-1, -2))
        s = terms[0] if len(terms) == 1 else (terms[0] + terms[1]) + terms[2]
        if causal:
            cols = k0 + torch.arange(kt.shape[2])[None, :]
            s = torch.where(cols > rows, torch.tensor(NEG_INF), s)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * corr
        for term in passes(p, vt):
            acc = acc + term
    return acc / torch.where(l == 0, torch.ones_like(l), l)


CASES = [
    (1, 2, 1, 128, 128, 64, True),      # MQA
    (1, 4, 2, 128, 256, 12, True),      # D = 12, Sq < Sk, GQA
    (1, 2, 2, 256, 128, 32, False),     # Sq > Sk, not causal
    (2, 4, 4, 128, 128, 128, True),     # MHA at llama3-8b's head dim
]


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", CASES)
def test_tf32x3_mirror_matches_the_pallas_kernel(B, H, KH, Sq, Sk, D,
                                                 causal):
    q, k, v = _attention_inputs(B, H, KH, Sq, Sk, D, seed=Sq + Sk + D)
    ours = flash_mirror(*map(torch.from_numpy, (q, k, v)), causal=causal)
    pallas = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    np.testing.assert_allclose(ours.numpy(), pallas, **ATTN_TOL)
    # and the port's plain version, which the card's kernel is held to
    plain = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    torch.testing.assert_close(ours, plain, **ATTN_TOL)


def test_tile_width_does_not_change_the_result():
    """BK = 64 (the kernel's tiles at D <= 32) and 32 agree to fp32
    rounding: the online softmax is exact in the tiling."""
    q, k, v = map(torch.from_numpy, _attention_inputs(1, 2, 1, 128, 128, 32,
                                                      seed=3))
    torch.testing.assert_close(flash_mirror(q, k, v, BK=64),
                               flash_mirror(q, k, v, BK=32),
                               rtol=1e-5, atol=1e-6)


def test_a_single_tf32_pass_misses_the_fp32_tolerance():
    """The precision decision: with each operand rounded to TF32 once, the
    result misses atol 2e-5 / rtol 2e-4 against the fp32 reference at
    llama3-8b's head dim; three passes hold it (the test above)."""
    B, H, KH, Sq, Sk, D, causal = CASES[-1]
    q, k, v = _attention_inputs(B, H, KH, Sq, Sk, D, seed=Sq + Sk + D)
    one = flash_mirror(*map(torch.from_numpy, (q, k, v)), causal=causal,
                       passes=mm1)
    pallas = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one.numpy(), pallas, **ATTN_TOL)
    err = np.abs(one.numpy() - pallas).max()
    assert err > 10 * ATTN_TOL["atol"], err
