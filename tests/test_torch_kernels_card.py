"""Kernels K1 and K2 on a CUDA card: each CUDA kernel against its plain
PyTorch version, its launch count, its device-side index check, and the
dense main path on the card against the same run on the CPU, uncompressed
(K1) and compressed (K2).

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
from repro_torch.kernels import compress_mix, gossip_mix, ops, ref

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
