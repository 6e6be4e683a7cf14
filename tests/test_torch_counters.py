"""The kernel wrappers' launch counters, as one registry
(`repro_torch.kernels.counters`), on the CPU: it names every counter the
kernel modules keep, its snapshot, zero, delta, add and restore agree, and
the run program adds each captured body's launches once per replay from
it (the arithmetic behind the counts a captured run reports; the card
tests hold those to real runs)."""

import importlib
import re

import pytest
import torch

from repro_torch.core.dda import DDASimulator, stepsize_sqrt
from repro_torch.experiments import components as C
from repro_torch.kernels import counters

KERNEL_MODULES = ("gossip_mix", "compress_mix", "flash_attention",
                  "ssd_scan", "selective_scan")
#: a module-level launch counter: LAUNCHES, X_LAUNCHES, or KERNELS
COUNTER_NAME = re.compile(r"^([A-Z0-9]+_)*LAUNCHES$|^KERNELS$")


@pytest.fixture
def saved_counts():
    before = counters.snapshot()
    yield before
    counters.restore(before)


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_registry_names_every_counter_of_a_kernel_module(module):
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    kept = {attr for attr in vars(mod) if COUNTER_NAME.match(attr)}
    assert kept, module
    assert kept == {attr for m, attr in counters.COUNTERS if m == module}


def test_snapshot_zero_add_and_restore(saved_counts):
    counters.zero()
    assert set(counters.snapshot().values()) == {0}
    from repro_torch.kernels import gossip_mix
    step = {("gossip_mix", "LAUNCHES"): 1,
            ("gossip_mix", "FORM_LAUNCHES", "slab"): 1}
    counters.add(step, 149)
    assert gossip_mix.LAUNCHES == 149
    assert gossip_mix.FORM_LAUNCHES == {"regs": 0, "slab": 149}
    now = counters.snapshot()
    grown = counters.delta(dict.fromkeys(now, 0), now)
    assert {k: n for k, n in grown.items() if n} == {
        k: 149 for k in step}
    counters.restore(saved_counts)
    assert counters.snapshot() == saved_counts


def test_count_replays_adds_each_bodys_launches_per_replay(saved_counts):
    n, d, T = 8, 12, 30
    cpu = torch.device("cpu")
    prob = C.build_component(C.problems, "quadratic_consensus",
                             {"n": n, "d": d}, device=cpu)
    sim = DDASimulator(prob.subgrad_stack, prob.objective,
                       C.build_component(C.topologies, "expander", {"k": 4},
                                         n=n),
                       a_fn=stepsize_sqrt(0.5), device=cpu)
    prog = sim._program(torch.zeros((n, d)), 1, T)
    assert prog.graphs is None  # no capture on the CPU
    # as a capture records them: the comm body launches K1's slab kernel
    prog.graphs = {}
    prog._launches = {"comm": {("gossip_mix", "LAUNCHES"): 1,
                               ("gossip_mix", "FORM_LAUNCHES", "slab"): 1},
                      "idle": {}, "stats": {}}
    prog._replays = {"comm": 14, "idle": 16, "stats": 3}
    counters.zero()
    prog.count_replays()
    from repro_torch.kernels import gossip_mix
    assert gossip_mix.LAUNCHES == 14
    assert gossip_mix.FORM_LAUNCHES == {"regs": 0, "slab": 14}
    assert prog._replays == {"comm": 0, "idle": 0, "stats": 0}
    prog.count_replays()  # the replays were counted once
    assert gossip_mix.LAUNCHES == 14
