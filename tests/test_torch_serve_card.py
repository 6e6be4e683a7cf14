"""The experiment server's threads on a CUDA card: captures run alone on
the card (`core.dda.DEVICE_LOCK`), so runs of different signatures may
capture and replay side by side and still give their solo runs' results
bit for bit; an eviction's free of captured graphs waits for another
thread's capture; a warm cache hit captures nothing; and the kernels'
launch counters stay exact when threads count at once.

Every test here needs the card and skips without one. This file imports
nothing of JAX, so it runs on the card's machine as it is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_serve_card.py
"""

import threading

import pytest
import torch

import repro_torch
from repro_torch.core.dda import _LaneProgram
from repro_torch.core.schedules import Periodic
from repro_torch.experiments import ExperimentSpec
from repro_torch.experiments.runner import _run_dense
from repro_torch.kernels import counters, gossip_mix
from repro_torch.serve import (CompileCache, ExperimentServer,
                               comparable_result_dict)

pytestmark = pytest.mark.cuda

#: one signature a T: the threads' specs differ in it, so each first run
#: of a T captures
TS = (40, 60, 80, 100)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode); run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_serve_card.py` on the card")
    return torch.device("cuda")


@pytest.fixture
def captures(monkeypatch):
    """Counts `_LaneProgram.capture` calls, by thread."""
    seen = []
    real = _LaneProgram.capture

    def counted(self):
        seen.append(threading.get_ident())
        return real(self)

    monkeypatch.setattr(_LaneProgram, "capture", counted)
    return seen


def _spec(T=60, h=2, seed=0, n=64, d=1024):
    return ExperimentSpec(
        name=f"card_T{T}_h{h}_s{seed}", T=T, eval_every=20, r=0.01,
        seed=seed,
        problem={"kind": "quadratic_consensus",
                 "params": {"n": n, "d": d, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": h}},
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        backends=[{"kind": "dense"}])


def _identical(a, b):
    return comparable_result_dict(a) == comparable_result_dict(b)


def _threads(targets, timeout=600):
    errors = []

    def guarded(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 -- reported below
                errors.append(e)
                raise
        return run

    threads = [threading.Thread(target=guarded(t)) for t in targets]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors


def test_two_signatures_capture_and_replay_side_by_side(cuda_device,
                                                        captures):
    """Two threads, each on its own signatures: each captures a new T
    while the other replays a warm one, over and over; every result is
    its solo run's bit for bit, and the K1 launches counted from both
    threads' replays are the rounds of every run."""
    solos = {T: repro_torch.run(_spec(T), device="cuda") for T in TS}
    cache = CompileCache()
    out = {0: [], 1: []}

    def worker(i):
        def run():
            # thread 0 walks the Ts up, thread 1 down, each running every
            # T twice: a cold run (a capture) next to the other's warm one
            for T in (TS if i == 0 else TS[::-1]):
                for _ in range(2):
                    spec = _spec(T)
                    out[i].append((T, _run_dense(spec, spec.backends[0],
                                                 sim_cache=cache,
                                                 device="cuda")))
        return run

    counters.zero()
    _threads([worker(0), worker(1)])
    launches = gossip_mix.LAUNCHES
    rounds = 0
    for i in (0, 1):
        assert len(out[i]) == 2 * len(TS)
        for T, result in out[i]:
            assert result.metrics.notes["loop"] == "graph"
            assert _identical(result, solos[T]), (i, T)
            rounds += result.trace.comms[-1]
    assert launches == rounds
    # the solo runs' captures, then one a T: the threads share the cache
    assert len(captures) == 2 * len(TS)
    assert len(set(captures[len(TS):])) == 2  # both threads captured


def test_eviction_during_a_capture_leaves_it_valid(cuda_device, captures):
    """A cache of one entry and two threads on two signatures: every
    lease evicts the other thread's simulator, whose graphs are freed
    (`DDASimulator.release`) while the other thread may be capturing.
    Each capture stays valid: every result is its solo run's."""
    specs = (_spec(60, h=2), _spec(80, h=4))
    solos = [repro_torch.run(s, device="cuda") for s in specs]
    cache = CompileCache(max_entries=1)
    out = {0: [], 1: []}

    def worker(i):
        def run():
            for _ in range(4):
                out[i].append(_run_dense(specs[i], specs[i].backends[0],
                                         sim_cache=cache, device="cuda"))
        return run

    _threads([worker(0), worker(1)])
    for i in (0, 1):
        assert all(_identical(r, solos[i]) for r in out[i]), i
    stats = cache.stats()
    assert stats["evictions"] >= 1
    # every miss built a simulator that captured once, every hit none
    assert len(captures) == len(specs) + stats["misses"]


def test_warm_hit_captures_nothing_and_counts_stay_exact(cuda_device,
                                                         captures):
    """Through the server: a warm hit captures nothing, its compile_s is
    0, and its result is the cold one's; then four warm requests of two
    signatures at once count exactly their rounds of K1."""
    spec, other = _spec(60), _spec(100)
    with ExperimentServer(workers=2, max_wait_s=0.0, packing=False) as srv:
        cold = srv.submit(spec).result(timeout=600)
        srv.submit(other).result(timeout=600)
        n_captures = len(captures)
        warm = srv.submit(spec).result(timeout=600)
        assert len(captures) == n_captures
        assert warm.metrics.counters["cache_hit"] == 1.0
        assert warm.metrics.compile_s < 1e-3
        assert _identical(warm, cold)
        counters.zero()
        futs = [srv.submit(s) for s in (spec, other, spec, other)]
        results = [f.result(timeout=600) for f in futs]
    assert len(captures) == n_captures
    expect = sum(Periodic(h=2).H(s.T) for s in (spec, other, spec, other))
    assert gossip_mix.LAUNCHES == expect
    assert sum(gossip_mix.FORM_LAUNCHES.values()) == expect
    assert [r.trace.comms[-1] for r in results] == [
        Periodic(h=2).H(s.T) for s in (spec, other, spec, other)]
