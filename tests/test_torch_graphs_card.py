"""The port's run program captured as CUDA graphs, on a CUDA card: a captured
run gives the eager loop's trace bit for bit (the same kernels in the same
order, so the warm-up left nothing in the run's state), its launch counts
are the communication rounds (derived from the graphs' replays), its graphs
are captured once per shape, batched lanes give their solo runs' traces,
and a problem that reads the card back (metric learning's eigh) is run
eagerly, as it declares.

Every test here needs the card and skips without one. This file imports
nothing of JAX, so it runs on the card's machine as it is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_graphs_card.py
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.compress import build_compressor
from repro_torch.core.dda import DDASimulator, stepsize_sqrt
from repro_torch.core.schedules import Periodic
from repro_torch.experiments import components as C
from repro_torch.kernels import compress_mix, gossip_mix

ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.cuda

COMPRESSIONS = [None, ("topk", {"keep": 0.25}),
                ("randk", {"keep": 0.25, "seed": 1}), ("int8", {}),
                ("int8", {"stochastic": True, "seed": 2})]
COMPRESSION_IDS = ["none", "topk", "randk", "int8", "int8-stochastic"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode); run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_graphs_card.py` on the card")
    return torch.device("cuda")


def _sim(device, compression=None, mix="auto", h=3, n=16, d=64, **kw):
    problem = C.build_component(C.problems, "quadratic_consensus",
                                {"n": n, "d": d}, device=device)
    graph = C.build_component(C.topologies, "expander", {"k": 4}, n=n)
    comp = None if compression is None else build_compressor(*compression)
    sim = DDASimulator(problem.subgrad_stack, problem.objective, graph,
                       Periodic(h=h), a_fn=stepsize_sqrt(0.5), r=0.01,
                       mix=mix, compression=comp, device=device, **kw)
    return sim, torch.zeros((n, d), device=device)


def _counts():
    return (gossip_mix.LAUNCHES, compress_mix.LAUNCHES,
            dict(gossip_mix.FORM_LAUNCHES))


@pytest.mark.parametrize("compression", COMPRESSIONS, ids=COMPRESSION_IDS)
def test_captured_run_equals_the_eager_loop(cuda_device, compression):
    sim, x0 = _sim(cuda_device, compression)
    captured = sim.run(x0, 50, eval_every=10)
    assert sim.last_loop == "graph"
    assert sim.last_timings["compile_s"] > 0.0
    rn = sim.last_res_norms
    eager = sim.run(x0, 50, eval_every=10, loop="segment")
    assert sim.last_loop == "eager"
    assert captured == eager
    # the same program at capture=False: the bodies called eagerly
    plain, _ = _sim(cuda_device, compression, capture=False)
    assert plain.run(x0, 50, eval_every=10) == captured
    assert plain.last_loop == "eager"
    np.testing.assert_array_equal(plain.last_res_norms, rn)


def test_captured_dense_mix_stays_within_tolerance(cuda_device):
    """cuBLAS may pick another algorithm for P @ z inside a capture, so
    the dense mix is held to the port's float32 tolerance, not bits."""
    sim, x0 = _sim(cuda_device, mix="dense")
    captured = sim.run(x0, 50, eval_every=10)
    assert sim.last_loop == "graph"
    eager = sim.run(x0, 50, eval_every=10, loop="segment")
    assert captured.comms == eager.comms
    np.testing.assert_allclose(captured.fvals, eager.fvals, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(captured.disagreement, eager.disagreement,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compression,kernel", [
    (None, gossip_mix), (("topk", {"keep": 0.25}), compress_mix),
    (("int8", {}), gossip_mix)], ids=["K1", "K2", "K1-int8"])
def test_launch_counts_equal_the_comm_rounds(cuda_device, compression,
                                             kernel):
    sim, x0 = _sim(cuda_device, compression)
    for _ in range(2):  # the capturing run and a replay-only run
        before = _counts()
        trace = sim.run(x0, 61, eval_every=10)
        after = _counts()
        rounds = trace.comms[-1]
        assert rounds == Periodic(h=3).H(61)
        launched = {gossip_mix: after[0] - before[0],
                    compress_mix: after[1] - before[1]}
        assert launched[kernel] == rounds
        assert sum(launched.values()) == rounds
        forms = {f: after[2][f] - before[2][f] for f in after[2]}
        assert forms == {"regs": 0, "slab": launched[gossip_mix]}


def test_graphs_are_captured_once_per_shape(cuda_device):
    sim, x0 = _sim(cuda_device)
    first = sim.run(x0, 40, eval_every=10)
    assert sim.last_timings["compile_s"] > 0.0
    programs = dict(sim._programs)
    assert len(programs) == 1
    again = sim.run(x0, 40, eval_every=10)
    assert again == first
    assert sim.last_timings["compile_s"] == 0.0
    # another run length and another schedule are data, not a new program
    sim.schedule = Periodic(h=2)
    sim.run(x0, 73, eval_every=25)
    assert sim.last_timings["compile_s"] == 0.0
    assert sim._programs == programs
    # a batch of three lanes is another shape
    sim.run_batch(x0, 40, 10, np.ones((3, 40), bool), [0, 1, 2])
    assert sim.last_timings["compile_s"] > 0.0
    assert len(sim._programs) == 2


@pytest.mark.parametrize("compression", COMPRESSIONS, ids=COMPRESSION_IDS)
def test_batch_lanes_equal_their_solo_runs_on_the_card(cuda_device,
                                                       compression):
    sim, x0 = _sim(cuda_device, compression)
    T = 45
    masks = np.stack([Periodic(h=h).comm_mask(0, T) for h in (1, 2, 5)])
    kernel = (compress_mix if compression and compression[0] in
              ("topk", "randk") else gossip_mix)
    before = kernel.LAUNCHES
    lanes = sim.run_batch(x0, T, 10, masks, [0, 0, 0])
    assert sim.last_loop == "graph"
    assert kernel.LAUNCHES - before == int(masks.any(axis=0).sum())
    for h, lane in zip((1, 2, 5), lanes):
        sim.schedule = Periodic(h=h)
        solo = sim.run(x0, T, eval_every=10)
        assert lane.comms == solo.comms and lane.sim_time == solo.sim_time
        for f in ("fvals", "fvals_consensus", "disagreement"):
            np.testing.assert_allclose(getattr(lane, f), getattr(solo, f),
                                       rtol=1e-6, atol=0, err_msg=f)


def test_eigh_cannot_be_captured(cuda_device):
    """cuSOLVER's eigh checks its info flag on the host, which a capture
    forbids: why metric learning declares `capturable=False`. The capture
    is tried in a process of its own, which a failed capture may leave
    unusable."""
    code = (
        "import torch\n"
        "A = torch.eye(4, device='cuda')\n"
        "torch.linalg.eigh(A)\n"
        "graph = torch.cuda.CUDAGraph()\n"
        "try:\n"
        "    with torch.cuda.graph(graph):\n"
        "        torch.linalg.eigh(A)\n"
        "except RuntimeError as e:\n"
        "    print('refused:', str(e).splitlines()[0])\n"
        "else:\n"
        "    raise SystemExit('captured')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "refused:" in proc.stdout
    problem = C.build_component(C.problems, "metric_learning",
                                {"n": 4, "m_pairs": 200}, device=cuda_device)
    assert problem.capturable is False


def test_run_api_reports_the_loop(cuda_device):
    spec = repro_torch.ExperimentSpec(
        name="loop", T=30, eval_every=10, r=0.01,
        problem={"kind": "metric_learning",
                 "params": {"n": 4, "m_pairs": 200}},
        topology={"kind": "complete", "params": {}},
        schedule={"kind": "every", "params": {}},
        stepsize={"kind": "sqrt", "params": {"A": 0.0004}},
        backends=[{"kind": "dense", "params": {}}])
    result = repro_torch.run(spec)
    assert result.metrics.notes == {"loop": "eager"}
    quad = spec.with_value("problem", {"kind": "quadratic_consensus",
                                       "params": {"n": 8, "d": 16}})
    assert repro_torch.run(quad).metrics.notes == {"loop": "graph"}
