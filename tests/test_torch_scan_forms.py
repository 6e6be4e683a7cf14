"""The algebra of kernels K5 (the SSD scan) and K6 (the selective scan) on
the CPU: plain-torch mirrors of the passes the CUDA kernels run, held
against the plain versions (`repro_torch.kernels.ref`) and the reference's
jnp oracles (`repro.kernels.ref`), and the precision decision of K5.

- K5 (`csrc/ssd_scan.cu`): chunk states S_c with the chunk decays, the
  carry h_{c+1} = exp(cum_Q) h_c + S_c, then the outputs (C B^T o L)(dt o x)
  + exp(cum) o (C h_c^T), at chunk lengths Q in {16, 64, 128} and with S
  not a multiple of Q (the ragged chunk enters as dt = 0, x = 0).
- K6 (`csrc/selective_scan.cu`): the sequence cut into nsplit pieces, each
  piece's end state from zero and its decay exp(A sum dt), the carry across
  pieces, then each piece again from its true initial state.
- The kernels' `plan`s: the chunk length, the head groups, the pieces and
  the workspaces the wrappers report.

Tolerance of a mirror against the plain versions: rtol 1e-5, atol 1e-5.
Both compute in fp32 on values of order 1; they differ in summation order
and in exp(a - b) against a product of exps, a few ulps a step over a few
hundred steps.

K5's products run on the tensor cores in 3xTF32. TF32 rounding is emulated
here on the bit pattern, as the kernel splits an operand (`split_tf32` in
csrc/ssd_scan.cu): the big part is the fp32 mantissa rounded to 10 bits,
ties away from zero (cvt.rna's rounding; ties to even would differ only on
exact ties), the small part the exact remainder with its low 13 bits
dropped. Products of such operands are exact in fp32, so an fp32 matmul of
them is what the tensor cores add up.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ref, selective_scan, ssd_scan

TOL = dict(rtol=1e-5, atol=1e-5)
#: chip_smoke.py's full-width error caps, which hold the precision decision
K5_CAP, K6_CAP = 1e-4, 2e-5


def _scan_inputs(shapes, seed):
    """tests/test_kernels.py's distributions: x ~ 0.5 N, dt = softplus(N -
    1), A = -exp(0.3 N) < 0, B and C ~ 0.5 N; numpy, float32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (0.5 * rng.normal(size=shapes["x"])).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=shapes["dt"]) - 1.0)).astype(f)
    A = (-np.exp(0.3 * rng.normal(size=shapes["A"]))).astype(f)
    B = (0.5 * rng.normal(size=shapes["B"])).astype(f)
    C = (0.5 * rng.normal(size=shapes["B"])).astype(f)
    return x, dt, A, B, C


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- TF32 ------------------------------------------------------------------

def tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, by integer operations on the bit pattern."""
    bits = t.contiguous().numpy().view(np.uint32)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(rounded.astype(np.uint32).view(np.float32))


def tf32_truncated(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by dropping the low 13 bits."""
    bits = t.contiguous().numpy().view(np.uint32) & np.uint32(0xFFFFE000)
    return torch.from_numpy(bits.view(np.float32))


def mm_fp32(a, b):
    return a @ b


def mm_tf32(a, b):
    """One TF32 pass: both operands rounded, products summed in fp32."""
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    """3xTF32: a_big b_big + a_big b_small + a_small b_big, the small terms
    first, as csrc/ssd_scan.cu's `mma3_tiles`."""
    a_big, b_big = tf32(a), tf32(b)
    a_small = tf32_truncated(a - a_big)
    b_small = tf32_truncated(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0e-5,
                      0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         1.0 + 2.0 ** -9, 1.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:5], want)      # ties away from zero at 2^-11
    assert torch.equal(tf32(-x[:5]), -want)
    assert torch.equal(tf32_truncated(x[:5]), torch.tensor(
        [1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10, 1.0]))
    assert torch.equal(got[6:], x[6:])
    assert abs(got[5] - x[5]) <= 2.0 ** -11 * abs(x[5])
    bits = got.numpy().view(np.uint32)
    assert not (bits & np.uint32(0x1FFF)).any()


# ---- K5: the SSD scan in three passes --------------------------------------

def ssd_passes(x, dt, A, B, C, Q, mm=mm_fp32):
    """csrc/ssd_scan.cu's three passes in plain torch, every product
    through `mm` with the operands the kernel's mma.sync takes. The cumsum
    is taken in double, as the kernels take it; L[s, t] = exp(cum_s -
    cum_t) directly on the diagonal 16 x 16 blocks and, below them, as
    exp(cum_s - cum_m) exp(cum_m - cum_t) with m = t | 7 (the kernel's
    tables), both factors <= 1."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # the ragged chunk enters as zeros
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bt, nc, Q, *t.shape[2:])

    xs, dts, Bs, Cs = chunks(x), chunks(dt), chunks(B), chunks(C)
    # pass 1: cum over the chunk, S_c[p, n] = sum_t (dt_t exp(cum_Q - cum_t)
    # x[t, p]) B[t, n], and the chunk's decay exp(cum_Q)
    cum = torch.cumsum(dts.double() * A.double(), dim=2)    # (Bt, nc, Q, H)
    total = cum[:, :, -1]                                   # (Bt, nc, H)
    w = dts * torch.exp((total[:, :, None] - cum).float())
    xw = (xs * w[..., None]).permute(0, 1, 3, 4, 2)         # (Bt,nc,H,P,Q)
    states = mm(xw, Bs[:, :, None])                         # (Bt,nc,H,P,N)
    decay = torch.exp(total.float())
    # pass 2: the state entering each chunk, in chunk order
    h = torch.zeros((Bt, H, P, N))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(entering, dim=1)                     # (Bt,nc,H,P,N)
    # pass 3: G = C B^T once per chunk, then per head the in-chunk term
    # (G o L)(dt o x) and the carried term exp(cum) o (C h_c^T)
    G = mm(Cs, Bs.transpose(-1, -2))                        # (Bt,nc,Q,Q)
    cumh = cum.permute(0, 1, 3, 2)                          # (Bt,nc,H,Q)
    rows, cols = torch.arange(Q)[:, None], torch.arange(Q)[None, :]
    diagonal = (rows // 16 == cols // 16) & (cols <= rows)
    below = cols // 16 < rows // 16
    m = cols | 7
    direct = cumh[..., :, None] - cumh[..., None, :]
    erow = cumh[..., :, None] - cumh[..., m[0]][..., None, :]
    ecol = cumh[..., m[0]] - cumh
    G = G[:, :, None]
    W = torch.where(diagonal, G * torch.exp(
        torch.where(diagonal, direct, 0.0).float()), 0.0)
    W = torch.where(below, G * torch.exp(torch.where(
        below, erow, 0.0).float()) * torch.exp(ecol.float())[..., None, :],
        W)                                                  # (Bt,nc,H,Q,Q)
    xd = (xs * dts[..., None]).permute(0, 1, 3, 2, 4)       # (Bt,nc,H,Q,P)
    intra = mm(W, xd)
    carried = mm(Cs[:, :, None], h_in.transpose(-1, -2))    # (Bt,nc,H,Q,P)
    y = intra + torch.exp(cumh.float())[..., None] * carried
    y = y.permute(0, 1, 3, 2, 4).reshape(Bt, nc * Q, H, P)
    return y[:, :S].contiguous()


SSD_CASES = [  # (Bt, S, H, P, N, Q)
    (2, 256, 3, 16, 8, 16), (1, 100, 2, 8, 5, 16), (1, 200, 2, 16, 16, 64),
    (2, 130, 2, 8, 6, 64), (1, 256, 2, 16, 64, 128), (1, 300, 3, 8, 12, 128),
    (1, 70, 2, 8, 10, 32),
]


@pytest.mark.parametrize("Bt,S,H,P,N,Q", SSD_CASES)
def test_ssd_passes_match_the_plain_scan(Bt, S, H, P, N, Q):
    args = _scan_inputs(dict(x=(Bt, S, H, P), dt=(Bt, S, H), A=(H,),
                             B=(Bt, S, N)), seed=S * Q + N)
    ours = ssd_passes(*map(_t, args), Q=Q)
    torch.testing.assert_close(ours, ref.ssd_scan_ref(*map(_t, args)), **TOL)


@pytest.mark.parametrize("Q", [16, 64, 128])
def test_ssd_passes_match_the_oracle(Q):
    args = _scan_inputs(dict(x=(1, 150, 2, 8), dt=(1, 150, 2), A=(2,),
                             B=(1, 150, 6)), seed=Q)
    ours = ssd_passes(*map(_t, args), Q=Q).numpy()
    oracle = np.asarray(jref.ssd_scan_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(ours, oracle, **TOL)


def test_ssd_precision_decision():
    """At a K5 shape, 3xTF32 products stay under chip_smoke.py's 1e-4 cap
    against the plain scan; a single TF32 pass does not."""
    Bt, S, H, P, N = 1, 512, 2, 64, 64
    args = list(map(_t, _scan_inputs(dict(x=(Bt, S, H, P), dt=(Bt, S, H),
                                          A=(H,), B=(Bt, S, N)), seed=15)))
    plain = ref.ssd_scan_ref(*args)
    Q = ssd_scan.chunk_length(N)
    err3 = (ssd_passes(*args, Q=Q, mm=mm_3xtf32) - plain).abs().max().item()
    err1 = (ssd_passes(*args, Q=Q, mm=mm_tf32) - plain).abs().max().item()
    assert err3 <= K5_CAP / 4, err3
    assert err1 > K5_CAP, err1


def test_ssd_plan():
    """Q = 64 while the padded state fits the output pass's shared memory,
    else 32; the workspace the wrapper allocates; the head groups."""
    assert [ssd_scan.chunk_length(N)
            for N in (1, 16, 64, 65, 128, 129, 220)] == \
        [64, 64, 64, 64, 64, 32, 32]
    zamba = ssd_scan.plan(1, 4096, 80, 64, 64, sms=132)
    assert zamba["kernels"] == ssd_scan.KERNELS_PER_CALL == 3
    assert zamba["chunk"] == 64 and zamba["chunks"] == 64
    assert zamba["workspace"] == (1, 80, 64, 64, 64)
    assert zamba["workspace_bytes"] == 83_886_080 + 4 * 80 * 64
    # 16 groups of 5 heads x 64 chunks: 1024 blocks, about 4 waves of 2 a SM
    assert zamba["heads_per_block"] == 5
    ragged = ssd_scan.plan(2, 100, 3, 40, 6, sms=132)
    assert ragged["chunks"] == 2 and ragged["heads_per_block"] == 1
    assert ssd_scan.plan(1, 130, 2, 64, 220)["workspace"] == \
        (1, 2, 5, 64, 220)  # Q = 32


# ---- K6: the selective scan in pieces --------------------------------------

def selective_pieces(x, dt, A, B, C, D_skip, nsplit):
    """csrc/selective_scan.cu's passes in plain torch: each of nsplit
    pieces' end state from zero and its decay exp(A sum dt), the carry
    across pieces, then each piece from its true initial state."""
    Bt, S, d = x.shape
    piece = -(-S // nsplit)
    bounds = [(s0, min(s0 + piece, S)) for s0 in range(0, S, piece)]

    def walk(h, s0, s1, ys=None):
        for t in range(s0, s1):
            dA = torch.exp(dt[:, t, :, None] * A)
            h = dA * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
            if ys is not None:
                ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
        return h

    zero = torch.zeros((Bt, d, A.shape[1]))
    ends, decays = [], []
    for s0, s1 in bounds[:-1]:                         # pass 1
        ends.append(walk(zero, s0, s1))
        decays.append(torch.exp(A * dt[:, s0:s1].sum(dim=1)[..., None]))
    h, entering = zero, []
    for j in range(len(bounds)):                       # pass 2
        entering.append(h)
        if j < len(ends):
            h = decays[j] * h + ends[j]
    ys = []
    for (s0, s1), h0 in zip(bounds, entering):         # pass 3
        walk(h0, s0, s1, ys)
    return torch.stack(ys, dim=1) + x * D_skip


SELECTIVE_CASES = [  # (Bt, S, d, N)
    (2, 96, 8, 4), (1, 101, 5, 16), (1, 130, 4, 3),
]


@pytest.mark.parametrize("nsplit", [1, 2, 5])
@pytest.mark.parametrize("Bt,S,d,N", SELECTIVE_CASES)
def test_selective_pieces_match_the_plain_scan(Bt, S, d, N, nsplit):
    x, dt, A, B, C = _scan_inputs(dict(x=(Bt, S, d), dt=(Bt, S, d),
                                       A=(d, N), B=(Bt, S, N)),
                                  seed=S + d + N)
    D_skip = np.linspace(-1.0, 1.0, d, dtype=np.float32)
    args = list(map(_t, (x, dt, A, B, C, D_skip)))
    torch.testing.assert_close(selective_pieces(*args, nsplit=nsplit),
                               ref.selective_scan_ref(*args), **TOL)


@pytest.mark.parametrize("nsplit", [1, 2, 5])
def test_selective_pieces_match_the_oracle(nsplit):
    x, dt, A, B, C = _scan_inputs(dict(x=(1, 120, 6), dt=(1, 120, 6),
                                       A=(6, 8), B=(1, 120, 8)), seed=nsplit)
    D_skip = np.ones(6, dtype=np.float32)
    args = (x, dt, A, B, C, D_skip)
    ours = selective_pieces(*map(_t, args), nsplit=nsplit).numpy()
    oracle = np.asarray(jref.selective_scan_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(ours, oracle, **TOL)


def test_selective_plan():
    """One piece where the channels fill the card (falcon-mamba-7b's full
    width), pieces of whole 32-token chunks covering S where they do not."""
    assert [selective_scan.lanes(N) for N in (1, 4, 5, 8, 9, 16, 17, 64)] \
        == [4, 4, 4, 4, 8, 8, 16, 16]
    # the (lanes, states a lane) pairs csrc/selective_scan.cu builds, three
    # states a lane running as four: every N the wrapper takes has one
    built = {(4, 1), (4, 2), (8, 2), (16, 2), (16, 4)}
    for N in range(1, selective_scan.MAX_N + 1):
        L = selective_scan.lanes(N)
        assert (L, -(-N // L) + (-(-N // L) == 3)) in built, N
    full = selective_scan.plan(1, 4096, 8192, 16, sms=132)
    assert (full["kernels"], full["nsplit"], full["lanes"]) == (1, 1, 8)
    assert full["workspace"] is None and full["workspace_bytes"] == 0
    narrow = selective_scan.plan(1, 4096, 64, 16, sms=132)
    assert narrow["kernels"] == 3 and narrow["nsplit"] > 1
    assert narrow["workspace"] == (1, narrow["nsplit"], 64, 16)
    assert narrow["workspace_bytes"] == 2 * 4 * narrow["nsplit"] * 64 * 16
    for Bt, S, d, N in ((1, 4096, 64, 16), (2, 200, 100, 3),
                        (1, 100, 8, 64), (3, 1000, 32, 8)):
        how = selective_scan.plan(Bt, S, d, N, sms=132)
        assert how["piece"] % 32 == 0 and how["piece"] >= 32
        assert (how["nsplit"] - 1) * how["piece"] < S <= \
            how["nsplit"] * how["piece"]
        assert how["kernels"] == (1 if how["nsplit"] == 1 else 3)
    assert math.ceil(200 / selective_scan.plan(2, 200, 100, 3)["piece"]) \
        == selective_scan.plan(2, 200, 100, 3)["nsplit"]
