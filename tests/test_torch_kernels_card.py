"""The port's kernels on a CUDA card. K1 and K2: each CUDA kernel against its
plain PyTorch version, its launch count, its device-side index check, and
the dense main path on the card against the same run on the CPU,
uncompressed (K1) and compressed (K2). K3 to K6: each front door of
`kernels.ops` against its plain version on the shapes of
tests/test_kernels.py and their edges, launching its kernel once per call,
with the tolerances chip_smoke.py states; K4 on the route its rule names
(bf16 with D % 8 == 0 on the sm90 kernel, fp32 and the other bf16 on the
3xTF32 kernel), and the sm90
kernel's fp32-out entry at the fp32 tolerance; K5 and K6 also on long
sequences at narrow widths, ragged chunks, odd P and d (the unvectorized
staging and stores) and the largest state sizes, with the plan (chunk or
pieces, workspace) each wrapper reports and the kernels each call
launched, as the library counts them.

Every test here needs the card (the CUDA kernel has no CPU mode) and skips
without one. This file imports nothing of JAX, so it runs on the card's
machine as it is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_card.py
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import assert_results_match
from repro_torch.kernels import (compress_mix, flash_attention, gossip_mix,
                                 ops, ref, selective_scan, ssd_scan)

ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode); "
                    "run `PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_kernels_card.py` on the card")
    return torch.device("cuda")


def _inputs(n, m, k, seed, device, dtype):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32))
    S_in = torch.from_numpy(rng.integers(0, n, size=(n, k)).astype(np.int64))
    ws = torch.from_numpy(rng.uniform(0.05, 0.9, size=(n,)).astype(np.float32))
    we = torch.from_numpy(rng.uniform(0.0, 0.3, size=(n, k))
                          .astype(np.float32))
    return (z.to(device, dtype), S_in.to(device), ws.to(device),
            we.to(device))


@pytest.mark.parametrize("n,M,k", [(7, 1, 1), (12, 257, 4), (256, 4096, 4),
                                   (64, 130, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(cuda_device, n, M, k, dtype):
    z, S_in, ws, we = _inputs(n, M, k, n + M + k, cuda_device,
                              getattr(torch, dtype))
    count = gossip_mix.LAUNCHES
    out = ops.gossip_gather_mix_impl(z, S_in, ws, we)
    assert gossip_mix.LAUNCHES == count + 1
    expect = ref.gossip_gather_mix_ref(z, S_in, ws, we)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=1e-5))
    assert out.dtype == z.dtype and out.shape == z.shape
    torch.testing.assert_close(out.float(), expect.float(), **tol)


@pytest.mark.parametrize("n,M,k", [(7, 1, 1), (12, 257, 4), (256, 4096, 4),
                                   (64, 130, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("density", [0.0, 0.125, 1.0])
def test_compress_kernel_matches_plain_on_the_card(cuda_device, n, M, k,
                                                   dtype, density):
    z, S_in, ws, we = _inputs(n, M, k, n + M + k, cuda_device,
                              getattr(torch, dtype))
    gen = torch.Generator(device=cuda_device).manual_seed(n * M + k)
    msg = torch.randn((n, M), generator=gen, device=cuda_device).to(z.dtype)
    mask = (torch.rand((n, M), generator=gen, device=cuda_device)
            < density).to(z.dtype)
    count = compress_mix.LAUNCHES
    out = ops.compress_mix_impl(z, msg, mask, S_in, ws, we)
    assert compress_mix.LAUNCHES == count + 1
    expect = ref.compress_mix_ref(z, msg, mask, S_in, ws, we)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=1e-5))
    assert out.dtype == z.dtype and out.shape == z.shape
    torch.testing.assert_close(out.float(), expect.float(), **tol)
    if density == 1.0:  # msg * 1 is exact: K1's result, bit for bit
        assert torch.equal(out, gossip_mix.gossip_mix_weighted(
            z, S_in, ws, we, msg=msg))


def _k1_form(call):
    """`call()` (one K1 call) and the kernel the library reported for it."""
    before = dict(gossip_mix.FORM_LAUNCHES)
    count = gossip_mix.LAUNCHES
    out = call()
    assert gossip_mix.LAUNCHES == count + 1
    grown = [form for form, c in gossip_mix.FORM_LAUNCHES.items()
             if c == before[form] + 1]
    assert len(grown) == 1
    assert sum(gossip_mix.FORM_LAUNCHES.values()) == sum(before.values()) + 1
    return out, grown[0]


@pytest.mark.parametrize("k", range(1, 10))  # k = 9: the generic kernel
@pytest.mark.parametrize("M,msg_kind,dtype,packets", [
    (4096, "none", "float32", True),     # slabs of 128 bytes a row
    (257, "own", "float32", False),      # ragged M: one element a thread
    (4096, "offset", "float32", False),  # a msg view not 16-byte aligned
    (1000, "own", "bfloat16", True),     # packets of 8 bf16
    (130, "none", "bfloat16", False),    # ragged in bf16
])
def test_k1_matches_plain_on_the_kernel_it_picks(cuda_device, k, M,
                                                 msg_kind, dtype, packets):
    """K1 against the plain version on the kernel the library picks: the
    slab kernel for 16-byte packets, k <= 8 and n (k + 1) row reads a
    column from 60 (here n = 40: 80 and more), else the register kernel.
    An unaligned msg view and an aligned copy of it (the register and the
    slab kernel, at k <= 8) give the same bits: each takes the slots in
    order, one FMA each after w_self * z, rounded once."""
    n = 40
    z, S_in, ws, we = _inputs(n, M, k, 7 * k + M, cuda_device,
                              getattr(torch, dtype))
    msg = None
    if msg_kind != "none":
        gen = torch.Generator(device=cuda_device).manual_seed(M + k)
        off = int(msg_kind == "offset")
        msg = torch.randn((n * M + off,), generator=gen,
                          device=cuda_device).to(z.dtype)[off:].view(n, M)
    out, form = _k1_form(lambda: gossip_mix.gossip_mix_weighted(
        z, S_in, ws, we, msg=msg))
    assert gossip_mix.slab_min_reads() <= n * 2
    assert form == ("slab" if packets and k <= 8 else "regs")
    expect = ref.gossip_gather_mix_ref(z, S_in, ws, we, msg=msg)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=1e-5))
    assert out.dtype == z.dtype and out.shape == z.shape
    torch.testing.assert_close(out.float(), expect.float(), **tol)
    if msg_kind == "offset":
        aligned, aligned_form = _k1_form(
            lambda: gossip_mix.gossip_mix_weighted(z, S_in, ws, we,
                                                   msg=msg.clone()))
        assert aligned_form == ("slab" if k <= 8 else "regs")
        assert torch.equal(aligned, out)


def test_k1_takes_the_register_kernel_past_the_slab_memory(cuda_device):
    """n = 8192 at k = 8: S_in and the weights alone (544 KB) exceed a
    block's shared memory, so the library launches the register kernel in
    packets, and it agrees with the plain version."""
    z, S_in, ws, we = _inputs(8192, 64, 8, 3, cuda_device, torch.float32)
    out, form = _k1_form(lambda: gossip_mix.gossip_mix_weighted(
        z, S_in, ws, we))
    assert form == "regs"
    expect = ref.gossip_gather_mix_ref(z, S_in, ws, we)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-6)


def test_k1_gives_the_same_bits_twice(cuda_device):
    """K1 at the main path's call (n=256, M=4096, k=4) twice on the same
    inputs: fp32 FMAs in a fixed order and no atomics, so the same bits."""
    z, S_in, ws, we = _inputs(256, 4096, 4, 0, cuda_device, torch.float32)
    first, form = _k1_form(lambda: gossip_mix.gossip_mix_weighted(
        z, S_in, ws, we))
    assert form == "slab"  # the kernel the main path launches
    second = gossip_mix.gossip_mix_weighted(z, S_in, ws, we)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    z, S_in, ws, we = _inputs(8, 64, 2, 0, cuda_device, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gossip_mix.gossip_mix_weighted(z.double(), S_in, ws, we)
    with pytest.raises(TypeError, match="int64"):
        gossip_mix.gossip_mix_weighted(z, S_in.int(), ws, we)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix.gossip_mix_weighted(z.T.contiguous().T, S_in, ws, we)
    with pytest.raises(ValueError, match="lies on"):
        gossip_mix.gossip_mix_weighted(z, S_in, ws.cpu(), we)
    with pytest.raises(ValueError, match="shape"):
        gossip_mix.gossip_mix_weighted(z, S_in, ws[:4], we)
    count = compress_mix.LAUNCHES
    with pytest.raises(TypeError, match="mask must be"):
        compress_mix.compress_mix_weighted(z, z, z.bfloat16(), S_in, ws, we)
    with pytest.raises(ValueError, match="msg must have shape"):
        compress_mix.compress_mix_weighted(z, z[:4], z, S_in, ws, we)
    with pytest.raises(ValueError, match="contiguous"):
        compress_mix.compress_mix_weighted(z, z, z.T.contiguous().T, S_in,
                                           ws, we)
    assert compress_mix.LAUNCHES == count


@pytest.mark.parametrize("call", [
    "gossip_mix.gossip_mix_weighted(z, S, w, w[:, None].contiguous())",
    "compress_mix.compress_mix_weighted(z, z, z, S, w, "
    "w[:, None].contiguous())",
], ids=["K1", "K2"])
def test_out_of_range_index_stops_the_kernel(cuda_device, call):
    """The device-side range check: a bad S_in entry raises at the next
    synchronizing call. Run in a child process, since a device-side
    assert leaves the CUDA context unusable."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import compress_mix, gossip_mix\n"
        "z = torch.ones((4, 16), device='cuda')\n"
        "S = torch.tensor([[1], [2], [3], [4]], device='cuda')\n"
        "w = torch.ones(4, device='cuda')\n"
        f"{call}\n"
        "torch.cuda.synchronize()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "assert" in (proc.stdout + proc.stderr).lower()


@pytest.mark.parametrize("name,kernel", [
    ("expander_periodic", gossip_mix), ("compressed_expander", compress_mix),
], ids=["K1", "K2"])
def test_dense_main_path_on_the_card_matches_the_cpu(cuda_device, name,
                                                     kernel):
    spec = repro_torch.ExperimentSpec.from_file(
        ROOT / "benchmarks" / "manifests" / f"{name}.json")
    counts = (gossip_mix.LAUNCHES, compress_mix.LAUNCHES)
    on_card = repro_torch.run(spec, "dense")
    launched = {gossip_mix: gossip_mix.LAUNCHES - counts[0],
                compress_mix: compress_mix.LAUNCHES - counts[1]}
    assert launched[kernel] == on_card.trace.comms[-1]
    assert sum(launched.values()) == launched[kernel]
    on_cpu = repro_torch.run(spec, "dense", device="cpu")
    assert_results_match(on_card.to_dict(), on_cpu.to_dict())


def _launched_once(module, count_name, call):
    before = getattr(module, count_name)
    out = call()
    torch.cuda.synchronize()
    assert getattr(module, count_name) == before + 1
    return out


@pytest.mark.parametrize("M,k", [(1, 1), (4099, 4), (1 << 20, 8),
                                 (65537, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_mix_matches_plain_on_the_card(cuda_device, M, k, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(M + k)
    sb = torch.randn((M,), generator=gen, device=cuda_device).to(
        getattr(torch, dtype))
    nb = torch.randn((k, M), generator=gen, device=cuda_device).to(sb.dtype)
    out = _launched_once(gossip_mix, "FLAT_LAUNCHES",
                         lambda: ops.gossip_mix(sb, nb, 0.2, 0.8 / k))
    expect = ref.gossip_mix_ref(sb, nb, 0.2, 0.8 / k)
    assert out.dtype == sb.dtype and out.shape == sb.shape
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=1e-5))
    torch.testing.assert_close(out.float(), expect.float(), **tol)


#: (B, H, KH, Sq, Sk, D, causal): the kernels' edges
ATTENTION_CASES = [
    (2, 4, 4, 128, 128, 64, True),     # MHA
    (2, 8, 2, 256, 256, 64, True),     # GQA 4x
    (2, 4, 1, 256, 256, 128, True),    # MQA
    (2, 2, 2, 512, 512, 32, True),
    (1, 2, 2, 128, 256, 64, False),    # Sq != Sk
    (1, 2, 1, 128, 256, 64, True),     # top-left mask at Sq < Sk
    (1, 2, 1, 256, 128, 64, True),     # Sq > Sk
    (1, 4, 4, 128, 128, 80, True),     # zamba2-2.7b's head dim
    (1, 2, 2, 100, 100, 48, True),     # one ragged tile, D padded
    (1, 2, 1, 256, 128, 64, False),    # Sq > Sk, not causal
    (1, 4, 2, 100, 384, 128, True),    # ragged Sq < Sk, GQA
    (1, 4, 1, 384, 100, 128, False),   # Sq > ragged Sk, MQA
    (1, 2, 1, 128, 128, 16, True),     # D below one 64-column chunk
    (1, 2, 2, 128, 128, 96, True),
    (1, 2, 1, 128, 128, 160, True),
    (1, 2, 1, 120, 120, 192, False),
    (1, 2, 1, 384, 384, 256, True),    # D = 256: 64-key tiles
]
#: shapes the front door refuses (the reference's blocks) but the wrapper
#: takes: ragged tiles past the first on both axes
RAGGED_CASES = [
    (1, 4, 2, 200, 300, 128, True),
    (1, 4, 1, 300, 200, 128, False),
    (1, 2, 1, 300, 200, 64, True),
    (1, 2, 2, 192, 330, 256, True),
    (2, 2, 1, 130, 130, 40, True),
]


def _attention_inputs(B, H, KH, Sq, Sk, D, dtype, device):
    gen = torch.Generator(device=device).manual_seed(Sq * D + H)
    q = torch.randn((B, H, Sq, D), generator=gen, device=device).to(dtype)
    k = torch.randn((B, KH, Sk, D), generator=gen, device=device).to(dtype)
    v = torch.randn((B, KH, Sk, D), generator=gen, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", ATTENTION_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_plain_on_the_card(cuda_device, B, H, KH, Sq, Sk,
                                             D, causal, dtype):
    td = getattr(torch, dtype)
    q, k, v = _attention_inputs(B, H, KH, Sq, Sk, D, td, cuda_device)
    want = "sm90" if dtype == "bfloat16" else "tf32x3"
    assert flash_attention.route(td, D) == want
    routes = (flash_attention.SM90_LAUNCHES,
              flash_attention.TF32X3_LAUNCHES)
    out = _launched_once(flash_attention, "LAUNCHES",
                         lambda: ops.flash_attention(q, k, v, causal=causal))
    moved = (flash_attention.SM90_LAUNCHES - routes[0],
             flash_attention.TF32X3_LAUNCHES - routes[1])
    assert moved == ((1, 0) if want == "sm90" else (0, 1))
    expect = ref.flash_attention_ref(q, k, v, causal=causal)
    assert out.dtype == td and out.shape == q.shape
    # bf16: both sides compute in fp32 and round once, so at most one bf16
    # ulp apart (chip_smoke.py ATTN_TOL)
    tol = (dict(atol=2e-5, rtol=2e-4) if dtype == "float32"
           else dict(atol=1e-5, rtol=1.6e-2))
    torch.testing.assert_close(out.float(), expect.float(), **tol)


@pytest.mark.parametrize("D", [1, 12, 100, 36])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_head_dims_off_the_sm90_grid_take_tf32x3(cuda_device, D,
                                                          dtype):
    """D not a multiple of 8: bf16 as well as fp32 takes the tf32x3 route
    (bf16 converted while staged; rows of D = 1 and 12 fp32 values staged
    4 bytes a copy), launched once there."""
    td = getattr(torch, dtype)
    q, k, v = _attention_inputs(1, 4, 2, 200, 300, D, td, cuda_device)
    assert flash_attention.route(td, D) == "tf32x3"
    count = flash_attention.TF32X3_LAUNCHES
    out = _launched_once(flash_attention, "LAUNCHES",
                         lambda: flash_attention.flash_attention(q, k, v))
    assert flash_attention.TF32X3_LAUNCHES == count + 1
    expect = ref.flash_attention_ref(q, k, v)
    tol = (dict(atol=2e-5, rtol=2e-4) if dtype == "float32"
           else dict(atol=1e-5, rtol=1.6e-2))
    assert out.dtype == td and out.shape == q.shape
    torch.testing.assert_close(out.float(), expect.float(), **tol)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_wrapper_takes_ragged_tiles_on_the_card(
        cuda_device, B, H, KH, Sq, Sk, D, causal, dtype):
    td = getattr(torch, dtype)
    q, k, v = _attention_inputs(B, H, KH, Sq, Sk, D, td, cuda_device)
    count = (flash_attention.SM90_LAUNCHES if dtype == "bfloat16"
             else flash_attention.TF32X3_LAUNCHES)
    out = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention.SM90_LAUNCHES if dtype == "bfloat16"
            else flash_attention.TF32X3_LAUNCHES) == count + 1
    expect = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = (dict(atol=2e-5, rtol=2e-4) if dtype == "float32"
           else dict(atol=1e-5, rtol=1.6e-2))
    torch.testing.assert_close(out.float(), expect.float(), **tol)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal",
                         ATTENTION_CASES[::2] + RAGGED_CASES)
def test_sm90_fp32_out_keeps_p_to_16_bits(cuda_device, B, H, KH, Sq, Sk, D,
                                          causal):
    """The sm90 kernel with an fp32 output, held to the fp32 tolerance on
    exact fp32 copies of its bf16 inputs: a kernel that rounded P to bf16
    would be about 1e-3 off, against rtol 2e-4."""
    q, k, v = _attention_inputs(B, H, KH, Sq, Sk, D, torch.bfloat16,
                                cuda_device)
    out = _launched_once(flash_attention, "SM90_LAUNCHES",
                         lambda: flash_attention._flash_attention_fp32_out(
                             q, k, v, causal=causal))
    expect = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, expect, atol=2e-5, rtol=2e-4)


def _scan_inputs(shapes, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shapes["x"], generator=gen, device=device) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn(shapes["dt"], generator=gen, device=device) - 1.0)
    A = -torch.exp(torch.randn(shapes["A"], generator=gen, device=device)
                   * 0.3)
    B = torch.randn(shapes["B"], generator=gen, device=device) * 0.5
    C = torch.randn(shapes["B"], generator=gen, device=device) * 0.5
    return x, dt, A, B, C


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("S,d,N", [(256, 128, 8), (512, 256, 16),
                                   (256, 512, 16), (200, 100, 5),
                                   (128, 64, 64),
                                   # long S at a narrow width: pieces
                                   (4096, 64, 16), (1000, 48, 32),
                                   # odd d: x and dt staged 4 bytes a copy
                                   (256, 37, 3)])
def test_selective_scan_matches_plain_on_the_card(cuda_device, S, d, N):
    x, dt, A, B, C = _scan_inputs(dict(x=(2, S, d), dt=(2, S, d), A=(d, N),
                                       B=(2, S, N)), S + d + N, cuda_device)
    D_skip = torch.ones((d,), device=cuda_device)
    kernels = selective_scan.KERNELS
    out = _launched_once(selective_scan, "LAUNCHES",
                         lambda: selective_scan.selective_scan(
                             x, dt, A, B, C, D_skip))
    how = selective_scan.LAST_PLAN
    assert how == selective_scan.plan(2, S, d, N, _sms(cuda_device))
    assert selective_scan.KERNELS - kernels == how["kernels"] \
        == (1 if how["nsplit"] == 1 else 3)
    if how["nsplit"] > 1:
        assert how["workspace"] == (2, how["nsplit"], d, N)
        assert how["workspace_bytes"] == 2 * 4 * 2 * how["nsplit"] * d * N
    if (S, d, N) == (4096, 64, 16):
        assert how["nsplit"] > 1
    expect = ref.selective_scan_ref(x, dt, A, B, C, D_skip)
    assert out.dtype == torch.float32 and out.shape == x.shape
    torch.testing.assert_close(out, expect, atol=5e-4, rtol=2e-3)


@pytest.mark.parametrize("S,H,P,N", [(256, 4, 32, 16), (512, 2, 64, 64),
                                     (128, 8, 64, 32), (100, 3, 40, 6),
                                     (128, 2, 64, 128),
                                     # long S at a narrow width; S not a
                                     # multiple of the chunk; 32-token
                                     # chunks above N = 128; MAX_N
                                     (4096, 2, 32, 16), (300, 3, 64, 100),
                                     (200, 2, 72, 136), (130, 2, 64, 220),
                                     # odd P, P N % 4 != 0: x staged and
                                     # y stored a float at a time, the
                                     # state pass one element a thread
                                     (128, 2, 37, 5)])
def test_ssd_scan_matches_plain_on_the_card(cuda_device, S, H, P, N):
    x, dt, A, B, C = _scan_inputs(dict(x=(2, S, H, P), dt=(2, S, H), A=(H,),
                                       B=(2, S, N)), S + H + P + N,
                                  cuda_device)
    kernels = ssd_scan.KERNELS
    out = _launched_once(ssd_scan, "LAUNCHES",
                         lambda: ssd_scan.ssd_scan(x, dt, A, B, C))
    how = ssd_scan.LAST_PLAN
    assert how == ssd_scan.plan(2, S, H, P, N, _sms(cuda_device))
    assert ssd_scan.KERNELS - kernels == how["kernels"] \
        == ssd_scan.KERNELS_PER_CALL == 3
    Q = ssd_scan.chunk_length(N)
    assert how["chunk"] == Q
    nc = -(-S // Q)
    assert how["workspace"] == (2, H, nc, P, N)
    assert how["workspace_bytes"] == 4 * (2 * H * nc * P * N + 2 * H * nc)
    expect = ref.ssd_scan_ref(x, dt, A, B, C)
    assert out.dtype == torch.float32 and out.shape == x.shape
    torch.testing.assert_close(out, expect, atol=5e-4, rtol=2e-3)


def test_sm90_route_refuses_a_misaligned_view(cuda_device):
    z = torch.ones((2 * 128 * 64 + 1,), device=cuda_device,
                   dtype=torch.bfloat16)[1:].view(1, 2, 128, 64)
    count = flash_attention.LAUNCHES
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention.flash_attention(z, z, z)
    assert flash_attention.LAUNCHES == count


def test_new_wrappers_refuse_what_their_kernels_do_not_take(cuda_device):
    z = torch.ones((1, 2, 128, 64), device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention(z.half(), z.half(), z.half())
    with pytest.raises(ValueError, match="exceeds"):
        big = torch.ones((1, 1, 8, 264), device=cuda_device)
        flash_attention.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(z.transpose(2, 3).contiguous()
                                        .transpose(2, 3), z, z)
    x = torch.ones((1, 8, 4), device=cuda_device)
    with pytest.raises(ValueError, match="state size"):
        selective_scan.selective_scan(x, x, torch.ones((4, 65),
                                                       device=cuda_device),
                                      x, x, x[0, 0])
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_scan(x[..., None].double(), x, x[0, 0], x, x)
