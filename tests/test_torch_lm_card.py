"""The launch backend's pod mix on the card: kernel K1 at the LM launcher's
calls (a bf16 weight leaf and an fp32 norm leaf of two pods, complete
graph) against its plain version bit for bit, and a smoke-width launch run
on the card against the same run on the CPU.

Every test here needs the card (the CUDA kernel has no CPU mode) and skips
without one. This file imports nothing of JAX, so it runs on the card's
machine as it is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_lm_card.py
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import assert_results_match
from repro_torch.core import graphs
from repro_torch.core.consensus import gossip_operands, tree_mix_gossip
from repro_torch.kernels import gossip_mix, ref

pytestmark = pytest.mark.cuda

#: the smoke run's losses on the card against the CPU (bf16 matmuls sum in
#: another order on each), as chip_smoke.py's lm phase holds them
LM_TRACE_RTOL = 1e-3
#: parameter leaves of a llama3 ("attn") model: one K1 launch each a mix
LM_LEAVES = 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode); "
                    "run `PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_lm_card.py` on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype", [((2, 512 * 4096), torch.bfloat16),
                                         ((2, 4 * 4096), torch.float32),
                                         ((2, 4, 128, 24), torch.bfloat16)])
def test_k1_at_the_lm_mix_is_its_plain_version(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    leaf = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    graph = graphs.complete_graph(2)
    S_in, sw, ew = gossip_operands(graph, cuda_device)
    before, forms = gossip_mix.LAUNCHES, dict(gossip_mix.FORM_LAUNCHES)
    out = tree_mix_gossip({"w": leaf}, graph, device=cuda_device)["w"]
    torch.cuda.synchronize()
    assert gossip_mix.LAUNCHES == before + 1
    # two rows, one neighbor: 4 row reads a column, below the slab
    # kernel's slab_min_reads(), so the register kernel streams
    assert 2 * 2 < gossip_mix.slab_min_reads()
    assert gossip_mix.FORM_LAUNCHES["regs"] == forms["regs"] + 1
    expect = ref.gossip_gather_mix_ref(leaf, S_in, sw, ew)
    assert out.dtype == dtype and out.shape == leaf.shape
    assert torch.equal(out, expect)
    # the complete graph at n = 2 averages: both pods equal
    assert torch.equal(out[0], out[1])


def _smoke_spec():
    return repro_torch.ExperimentSpec(
        name="lm_smoke", T=6, eval_every=1, r=0.05, seed=0,
        problem={"kind": "lm", "params": {
            "arch": "llama3-8b", "variant": "smoke", "batch_per_node": 2,
            "seq_len": 64}},
        topology={"kind": "expander", "params": {"k": 2, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        backends=[{"kind": "launch", "params": {"mesh": [4, 1, 1]}}])


def test_smoke_launch_run_card_against_cpu(cuda_device):
    spec = _smoke_spec()
    before = gossip_mix.LAUNCHES
    card = repro_torch.run(spec, device=cuda_device).to_dict()
    torch.cuda.synchronize()
    launched = gossip_mix.LAUNCHES - before
    cpu = repro_torch.run(spec, device="cpu").to_dict()
    assert launched == LM_LEAVES * card["extras"]["comm_rounds"] == 24
    np.testing.assert_allclose(card["trace"]["fvals"], cpu["trace"]["fvals"],
                               rtol=LM_TRACE_RTOL)
    assert card["trace"]["fvals"][-1] < card["trace"]["fvals"][0]
    for side in (card, cpu):
        side["trace"]["fvals"] = cpu["trace"]["fvals"]
        side["trace"]["fvals_consensus"] = cpu["trace"]["fvals_consensus"]
    assert_results_match(card, cpu)
