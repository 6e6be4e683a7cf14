"""The differential serving tier on the port: `repro_torch.serve` must be
invisible.

A result served from a warm compile cache, or packed into a cross-request
`run_batch` lane, must equal a solo `repro_torch.run()` of the same spec
exactly (JSON equality under `comparable_result_dict`, which strips only
wall-clock and serve bookkeeping), and must match the reference's served
result (`repro.serve`, the same server settings) under the port's parity
check, `convert.assert_results_match` (host fields exact, trace floats
rtol 1e-5, atol 1e-6). The copy of tests/test_serve.py at its sizes (n=8,
d=6, T=60), on the CPU (`device="cpu"`); plus: the cache key and lane key
are the reference's strings, the hermetic client->server->result TCP e2e
(`-m serve`), property tests for the cache key and the packer's admission
relation, the packer/cache units, and the process-wide device lock
(`core.dda.DEVICE_LOCK`) and counter lock the card's threads rely on.
"""

import threading
import time

import pytest
import torch

import repro
import repro.serve as ref_serve
from repro.experiments import runner as ref_runner

import repro_torch
from repro_torch.convert import assert_results_match
from repro_torch.core.dda import DEVICE_LOCK, _DeviceLock
from repro_torch.experiments import ExperimentSpec
from repro_torch.experiments import runner as port_runner
from repro_torch.kernels import counters
from repro_torch.serve import (Client, CompileCache, ExperimentServer,
                               LanePacker, ServeError, cache_signature,
                               comparable_result_dict, lane_key)

from _hyp import given, settings, st

CPU = "cpu"


def _base(**kw):
    base = dict(
        name="serve",
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 8, "d": 6, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        backends=[{"kind": "dense"}],
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        T=60, eval_every=20, seed=0, r=0.01, eps_frac=0.05)
    base.update(kw)
    return base


def _spec(**kw):
    return ExperimentSpec(**_base(**kw))


def _ref(spec):
    """The reference's spec for a port spec (same JSON)."""
    return repro.ExperimentSpec.from_json(spec.to_json())


def _solo(spec, backend="dense"):
    return repro_torch.run(spec, backend=backend, device=CPU)


def _ref_served(specs, **server_kw):
    """The reference's served results for `specs`, submitted together to
    one `repro.serve.ExperimentServer` with the same settings."""
    with ref_serve.ExperimentServer(**server_kw) as srv:
        futs = [srv.submit(_ref(s)) for s in specs]
        return [f.result(timeout=180) for f in futs]


def _assert_identical(served, solo, what):
    a, b = comparable_result_dict(served), comparable_result_dict(solo)
    assert a == b, f"{what}: served result differs from solo repro_torch.run()"


def _assert_matches_reference(served, ref_served):
    assert_results_match(served.to_dict(), ref_served.to_dict())


# ---------------------------------------------------------------------------
# differential gates (the headline tests)
# ---------------------------------------------------------------------------


def test_warm_cache_run_bit_identical_to_cold_solo():
    """Gate (a): a warm-cache served run round-trips to EXACTLY the cold
    solo result -- and says so in its counters."""
    spec = _spec(name="warm_gate")
    solo = _solo(spec)
    with ExperimentServer(workers=1, max_wait_s=0.01, device=CPU) as srv:
        cold = srv.submit(spec).result()
        warm = srv.submit(spec).result()
    # exact compare happens on the JSON ROUND-TRIPPED dict: what a client
    # reads from an artifact, not just the in-memory object
    _assert_identical(repro_torch.RunResult.from_json(cold.to_json()), solo,
                      "cold served")
    _assert_identical(repro_torch.RunResult.from_json(warm.to_json()), solo,
                      "warm served")
    assert cold.metrics.counters["cache_miss"] == 1.0
    assert warm.metrics.counters["cache_hit"] == 1.0
    assert warm.metrics.counters["queue_wait_s"] >= 0.0
    ref_cold, = _ref_served([spec], workers=1, max_wait_s=0.01)
    _assert_matches_reference(cold, ref_cold)
    _assert_matches_reference(warm, ref_cold)


def test_cross_request_packed_lane_bit_identical_to_solo():
    """Gate (b): specs packed into ONE lane from different requests each
    return results bit-identical to their solo runs."""
    variants = [_spec(name=f"lane{s}", seed=s, r=0.01 * (s + 1))
                for s in range(3)]
    solos = [_solo(v) for v in variants]
    with ExperimentServer(workers=1, max_width=3, max_wait_s=5.0,
                          device=CPU) as srv:
        futs = [srv.submit(v) for v in variants]  # width 3 == max: flushes
        packed = [f.result(timeout=120) for f in futs]
    for served, solo in zip(packed, solos):
        _assert_identical(repro_torch.RunResult.from_json(served.to_json()),
                          solo, "packed lane")
        assert served.metrics.counters["lane_width"] == 3.0
        assert served.extras["lane_width"] == 3
    st_ = srv.stats()
    assert st_["packer"]["packed_requests"] == 3
    assert st_["packer"]["occupancy"] == 1.0
    refs = _ref_served(variants, workers=1, max_width=3, max_wait_s=5.0)
    for served, theirs in zip(packed, refs):
        assert theirs.extras["lane_width"] == 3
        _assert_matches_reference(served, theirs)


def test_all_comm_lane_keeps_solo_program_variant():
    """An all-comm spec ("every") packs only with all-comm peers, as the
    reference keys lanes, and the differential holds end-to-end when
    both arrive together."""
    every = _spec(name="ac", schedule={"kind": "every"})
    sparse = _spec(name="sp", schedule={"kind": "periodic",
                                        "params": {"h": 2}})
    key_every, _ = lane_key(every, None, device=CPU)
    key_sparse, _ = lane_key(sparse, None, device=CPU)
    assert key_every is not None and key_sparse is not None
    assert key_every != key_sparse  # same shapes, different ac bit
    solos = [_solo(s) for s in (every, sparse)]
    with ExperimentServer(workers=1, max_width=4, max_wait_s=0.2,
                          device=CPU) as srv:
        futs = [srv.submit(s) for s in (every, sparse)]
        served = [f.result(timeout=120) for f in futs]
    for got, solo in zip(served, solos):
        _assert_identical(got, solo, "mixed ac traffic")
    refs = _ref_served([every, sparse], workers=1, max_width=4,
                       max_wait_s=0.2)
    for got, theirs in zip(served, refs):
        _assert_matches_reference(got, theirs)


def test_compression_splits_lanes_and_cache_entries():
    """`spec.compression` participates in BOTH serving keys: compressed
    and uncompressed specs never share a compile-cache entry or a lane,
    while same-compression traffic still packs -- and the served
    compressed result is bit-identical to solo repro_torch.run()."""
    plain = _spec(name="plain")
    topk = _spec(name="topk",
                 compression={"kind": "topk", "params": {"keep": 0.25}})
    topk2 = _spec(name="topk2", seed=1,
                  compression={"kind": "topk", "params": {"keep": 0.25}})
    backend = plain.backends[0]
    assert cache_signature(plain, backend) != cache_signature(topk, backend)
    assert cache_signature(topk, backend) == cache_signature(topk2, backend)
    key_plain, _ = lane_key(plain, None, device=CPU)
    key_topk, _ = lane_key(topk, None, device=CPU)
    key_topk2, _ = lane_key(topk2, None, device=CPU)
    assert key_plain is not None and key_topk is not None
    assert key_plain != key_topk
    assert key_topk == key_topk2  # same compressor still packs
    solos = [_solo(s) for s in (topk, topk2)]
    with ExperimentServer(workers=1, max_width=4, max_wait_s=0.2,
                          device=CPU) as srv:
        futs = [srv.submit(s) for s in (topk, topk2, plain)]
        served = [f.result(timeout=120) for f in futs]
    _assert_identical(served[0], solos[0], "compressed spec via server")
    _assert_identical(served[1], solos[1], "compressed lane peer")
    assert served[0].metrics.compression["kind"] == "topk"
    assert served[0].extras["lane_width"] == 2
    refs = _ref_served([topk, topk2, plain], workers=1, max_width=4,
                       max_wait_s=0.2)
    for got, theirs in zip(served, refs):
        _assert_matches_reference(got, theirs)


R_TRUE = 50.0  # eq. 21 then asks for h = 5 (h0 = 2)


def _charge(sim, comm, iters):
    """What eq. 9 says `iters` iterations cost at R_TRUE."""
    n, k = sim.graph.n, sim.graph.degree
    return (1.0 / n + (k * R_TRUE if comm else 0.0)) * iters


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def charged_closed_loops(monkeypatch):
    """Both packages' dense closed loops under an injected clock that
    charges each chunk `_charge` (the port's seam `DDASimulator.run_chunk`,
    the reference's `_segment`), a fresh clock each run: the controller's
    decisions are then a function of the spec alone, as
    tests/test_torch_adaptive.py holds them."""
    real_port = port_runner._dense_adaptive_run
    real_ref = ref_runner._dense_adaptive_run

    def port_loop(sim, ctrl, x0, T, eval_every, seed, timings=None):
        clock, real_chunk = _FakeClock(), sim.run_chunk

        def charged(comm, chunk):
            clock.t += _charge(sim, comm, chunk)
            return real_chunk(comm, chunk)

        sim.run_chunk = charged
        try:
            return real_port(sim, ctrl, x0, T, eval_every, seed,
                             timer=clock, timings=timings)
        finally:
            del sim.run_chunk

    def ref_loop(sim, ctrl, x0, T, eval_every, seed, timings=None):
        import numpy as np

        clock, real_segment = _FakeClock(), sim._segment

        def charged(z, x, xhat, res, t, mask, keys):
            mask = np.asarray(mask)
            clock.t += _charge(sim, bool(mask[0]), len(mask))
            return real_segment(z, x, xhat, res, t, mask, keys)

        sim._segment = charged
        try:
            return real_ref(sim, ctrl, x0, T, eval_every, seed,
                            timer=clock, timings=timings)
        finally:
            sim._segment = real_segment

    monkeypatch.setattr(port_runner, "_dense_adaptive_run", port_loop)
    monkeypatch.setattr(ref_runner, "_dense_adaptive_run", ref_loop)


def test_adaptive_spec_rides_warm_cache_solo(charged_closed_loops):
    """A dense_adaptive (controller) spec is not packable -- with the
    stated reason -- but STILL leases the warm simulator: the warm run
    builds no program (the cold run's one-lane program is reused, and on
    a card its graphs). Under the injected clock both served runs equal
    the solo run exactly (retunes included: h rises) and match the
    reference's served run."""
    spec = _spec(
        name="adaptive",
        schedule={"kind": "adaptive", "params": {"h0": 2}},
        controller={"kind": "dense_adaptive",
                    "params": {"retune_every": 20}})
    key, reason = lane_key(spec, None, device=CPU)
    assert key is None and "controller" in reason
    solo = _solo(spec)
    assert solo.extras["retunes"], "the injected clock must retune h"
    with ExperimentServer(workers=1, max_wait_s=0.01, device=CPU) as srv:
        cold = srv.submit(spec).result(timeout=180)
        sim = next(iter(srv.cache._entries.values())).sim
        programs = dict(sim._programs)
        warm = srv.submit(spec).result(timeout=180)
        assert sim._programs == programs  # the same program objects
    assert cold.metrics.counters["cache_miss"] == 1.0
    assert warm.metrics.counters["cache_hit"] == 1.0
    assert "controller" in warm.metrics.notes["solo_reason"]
    assert warm.metrics.compile_s <= cold.metrics.compile_s
    _assert_identical(cold, solo, "cold adaptive")
    _assert_identical(warm, solo, "warm adaptive")
    ref_cold, ref_warm = _ref_served([spec, spec], workers=1,
                                     max_wait_s=0.01)
    _assert_matches_reference(cold, ref_cold)
    _assert_matches_reference(warm, ref_warm)


def test_netsim_spec_served_solo_with_reason():
    """Non-dense backends run through the ordinary path, annotated."""
    spec = ExperimentSpec(
        name="net", problem={"kind": "quadratic_consensus",
                             "params": {"n": 8, "d": 4, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "every"},
        backends=[{"kind": "netsim", "params": {"scenario": "homogeneous",
                                                "engine": "vectorized"}}],
        stepsize={"kind": "inv_sqrt", "params": {"A": 0.5}},
        T=30, eval_every=10, seed=0, r=0.01)
    solo = repro_torch.run(spec, device=CPU)
    with ExperimentServer(workers=1, max_wait_s=0.01, device=CPU) as srv:
        served = srv.submit(spec).result(timeout=120)
    _assert_identical(served, solo, "netsim via serve")
    assert "not dense" in served.metrics.notes["solo_reason"]
    assert served.metrics.counters["lane_width"] == 1.0
    ref, = _ref_served([spec], workers=1, max_wait_s=0.01)
    _assert_matches_reference(served, ref)


def test_submit_surfaces_run_errors():
    bad = _spec(name="bad", backends=[{"kind": "dense",
                                       "params": {"bogus": 1}}])
    with ExperimentServer(workers=1, max_wait_s=0.01, device=CPU) as srv:
        fut = srv.submit(bad)
        with pytest.raises(ValueError, match="unknown params"):
            fut.result(timeout=60)
        assert srv.stats()["server"]["errors"] == 1


def test_unported_backend_surfaces_to_its_requester():
    """The launch backend is not ported: a served LM spec gets the
    NotImplementedError, and the server goes on serving."""
    spec = _spec(name="lm", backends=[{"kind": "launch"}])
    with ExperimentServer(workers=1, max_wait_s=0.01, device=CPU) as srv:
        with pytest.raises(NotImplementedError, match="launch backend"):
            srv.submit(spec).result(timeout=60)
        ok = srv.submit(_spec(name="after")).result(timeout=60)
        _assert_identical(ok, _solo(_spec(name="after")), "after a failure")
        assert srv.stats()["server"]["errors"] == 1


def test_server_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ExperimentServer(workers=1)
    with ExperimentServer(workers=1, device=CPU) as srv:
        assert srv.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# hermetic TCP e2e (tier-1: spawned server, port 0, teardown in finally)
# ---------------------------------------------------------------------------


@pytest.mark.serve
def test_client_server_e2e_localhost():
    """Gate (c): client -> TCP server -> streamed result, hermetically."""
    spec = _spec(name="e2e", T=40, eval_every=5)  # 8 rows: multi-op smoke
    solo = _solo(spec)
    srv = ExperimentServer(port=0, workers=1, max_wait_s=0.01, device=CPU)
    try:
        host, port = srv.start()
        assert port != 0
        with Client(host, port, timeout=120.0) as client:
            assert client.ping()
            events = []
            served = client.run(spec, backend="dense",
                                on_event=lambda e: events.append(e["event"]))
            assert events[0] == "accepted"
            assert "trace" in events and events[-1] == "result"
            _assert_identical(served, solo, "tcp e2e")
            # the streamed trace reassembled EXACTLY
            assert served.to_dict()["trace"] == solo.to_dict()["trace"]
            warm = client.run(spec, backend="dense")
            assert warm.metrics.counters["cache_hit"] == 1.0
            stats = client.stats()
            assert stats["cache"]["hits"] == 1
            bad = spec.to_dict()
            bad["problem"] = {"kind": "no_such_problem", "params": {}}
            with pytest.raises(ServeError, match="no_such_problem"):
                client.run(bad)
            assert client.ping()  # connection survives a failed run
    finally:
        srv.close()
    ref, = _ref_served([spec], workers=1, max_wait_s=0.01)
    _assert_matches_reference(served, ref)


# ---------------------------------------------------------------------------
# cache + packer units
# ---------------------------------------------------------------------------


def test_compile_cache_lease_lru_and_concurrency():
    cache = CompileCache(max_entries=2)
    built = []

    def factory(tag):
        def make():
            built.append(tag)
            return {"sim": tag}
        return make

    s1, s2, s3 = (_spec(T=t) for t in (10, 20, 30))  # distinct signatures
    b = s1.backends[0]
    out = {}

    def contend():
        with cache.lease(s1, b, factory("a2")) as (sim2, hit2):
            out["sim"], out["hit"] = sim2, hit2

    with cache.lease(s1, b, factory("a")) as (sim, hit):
        assert sim == {"sim": "a"} and not hit
        # same signature, concurrent: blocks on the entry lock (leases
        # are exclusive), then hits the already-built simulator
        thread = threading.Thread(target=contend)
        thread.start()
        thread.join(timeout=0.2)
        assert out == {}  # still waiting: the lease is exclusive
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert out == {"sim": {"sim": "a"}, "hit": True}  # built once, shared
    assert built == ["a"]
    with cache.lease(s2, b, factory("b")) as _:
        pass
    with cache.lease(s3, b, factory("c")) as _:  # capacity 2: evicts LRU
        pass
    assert cache.stats()["entries"] == 2
    assert cache.stats()["evictions"] == 1
    with cache.lease(s1, b, factory("a3")) as (sim, hit):
        assert not hit and sim == {"sim": "a3"}  # s1 was the LRU victim


def test_eviction_releases_the_simulator_outside_the_table_lock():
    """An evicted simulator's programs (on a card, its captured graphs)
    are freed through `release()`, which waits for every other thread's
    device work; the cache calls it after letting go of its table, so
    other leases go on meanwhile."""
    cache = CompileCache(max_entries=1)
    seen = []

    class Sim:
        def release(self):
            seen.append(cache._lock.locked())

    s1, s2 = _spec(T=10), _spec(T=20)
    b = s1.backends[0]
    with cache.lease(s1, b, Sim):
        pass
    with cache.lease(s2, b, Sim):
        pass
    assert seen == [False]
    # a real simulator: its run programs go, and it still runs after
    spec = _spec(name="evicted")
    parts = port_runner._dense_parts(spec, spec.backends[0],
                                     torch.device("cpu"))
    sim = port_runner._dense_sim(spec, parts, torch.device("cpu"))
    first = sim.run(torch.zeros((8, 6)), spec.T, spec.eval_every)
    assert sim._programs
    sim.release()
    assert not sim._programs
    assert sim.run(torch.zeros((8, 6)), spec.T, spec.eval_every) == first


def test_lane_packer_admission_policy():
    now = [0.0]
    packer = LanePacker(max_width=2, max_wait_s=1.0, clock=lambda: now[0])
    packer.admit("k1", "a")
    assert packer.pop_ready() == []  # neither full nor expired
    packer.admit("k1", "b")  # hits max_width
    lanes = packer.pop_ready()
    assert [lane.items for lane in lanes] == [["a", "b"]]
    packer.admit("k2", "c")
    assert packer.next_deadline() == 1.0
    now[0] = 2.0
    lanes = packer.pop_ready()  # expired at width 1
    assert [lane.items for lane in lanes] == [["c"]]
    packer.admit("k3", "d")
    assert [lane.items for lane in packer.flush()] == [["d"]]
    stats = packer.stats()
    assert stats["lanes_flushed"] == 3
    assert stats["packed_requests"] == 2
    assert stats["occupancy"] == pytest.approx(4 / 6)


# ---------------------------------------------------------------------------
# the device lock and the counters' lock (what the card's threads rely on)
# ---------------------------------------------------------------------------


def _run_threads(targets, timeout=30):
    threads = [threading.Thread(target=t) for t in targets]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    assert not any(th.is_alive() for th in threads)


def test_device_lock_shares_runs_and_excludes_a_capture():
    """Shared holds overlap; an exclusive hold overlaps nothing; a thread
    that holds it shared may ask for it exclusively (a capture inside a
    run) while another does the same; nested holds add nothing."""
    lock = _DeviceLock()
    state = {"shared": 0, "exclusive": 0, "max_shared": 0, "bad": 0}
    guard = threading.Lock()

    def enter(kind):
        with guard:
            state[kind] += 1
            if kind == "shared":
                state["max_shared"] = max(state["max_shared"],
                                          state["shared"])
            if state["exclusive"] > 1 or (state["exclusive"]
                                          and state["shared"]):
                state["bad"] += 1

    def leave(kind):
        with guard:
            state[kind] -= 1

    barrier = threading.Barrier(4, timeout=30)

    def run_with_capture():
        with lock.shared():
            enter("shared")
            barrier.wait()  # all four hold it shared at once
            time.sleep(0.01)
            leave("shared")
            with lock.exclusive():  # the upgrade: gives up the shared hold
                enter("exclusive")
                with lock.shared(), lock.exclusive():  # nested: nothing
                    time.sleep(0.005)
                leave("exclusive")
            enter("shared")
            with lock.shared():
                time.sleep(0.005)
            leave("shared")

    _run_threads([run_with_capture] * 4)
    assert state["max_shared"] == 4
    assert state["bad"] == 0
    assert lock._readers == 0 and lock._writer is None
    assert DEVICE_LOCK is not lock and isinstance(DEVICE_LOCK, _DeviceLock)


def test_counters_stay_exact_under_concurrent_adds(monkeypatch):
    """Threads adding replayed launches at once (two runs ending side by
    side) lose none: `counters.add` is a read-modify-write under
    `counters.LOCK`. More threads than cores, a short switch interval."""
    import sys

    before = counters.snapshot()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        counters.zero()
        step = {("gossip_mix", "LAUNCHES"): 1,
                ("gossip_mix", "FORM_LAUNCHES", "slab"): 1,
                ("compress_mix", "LAUNCHES"): 2}
        threads, adds = 16, 200

        def work():
            for _ in range(adds):
                counters.add(step, 3)

        _run_threads([work] * threads, timeout=120)
        snap = counters.snapshot()
        for key, n in step.items():
            assert snap[key] == threads * adds * 3 * n, key
    finally:
        sys.setswitchinterval(interval)
        counters.restore(before)


# ---------------------------------------------------------------------------
# the reference's keys, and property tests: cache key + admission relation
# ---------------------------------------------------------------------------

_IRRELEVANT = st.fixed_dictionaries({
    "seed": st.integers(0, 2**31 - 1),
    "r": st.floats(0.0, 10.0, allow_nan=False),
    "eps_frac": st.one_of(st.none(), st.floats(0.001, 0.5)),
    "name": st.text(
        st.characters(whitelist_categories=("Lu", "Ll", "Nd")),
        min_size=1, max_size=12),
})

#: shape-relevant axes and values: every pair of DISTINCT values within a
#: field must produce distinct signatures (problem seed included -- the
#: problem's tensors are what the run program's closures read)
_RELEVANT_VALUES = {
    "problem.params.n": [4, 8, 12],
    "problem.params.d": [2, 6, 10],
    "problem.params.seed": [0, 1, 2],
    "problem.kind": ["quadratic_consensus", "nonsmooth"],
    "topology.params.k": [2, 4],
    "schedule.kind": ["every", "periodic", "sparse"],
    "stepsize.params.A": [0.25, 0.5, 1.0],
    "T": [20, 40, 60],
    "eval_every": [10, 20],
    # compression realizes inside the run program (support masks,
    # quantization) and scales the time axis: never share a lane across it
    "compression": [None,
                    {"kind": "topk", "params": {"keep": 0.25}},
                    {"kind": "topk", "params": {"keep": 0.5}},
                    {"kind": "randk", "params": {"keep": 0.25}},
                    {"kind": "int8", "params": {}}],
}
_RELEVANT_AXES = {axis: st.sampled_from(vals)
                  for axis, vals in _RELEVANT_VALUES.items()}


def _assert_reference_keys(spec):
    """The port's cache signature and lane key of `spec` are the
    reference's strings."""
    ref = _ref(spec)
    assert cache_signature(spec, spec.backends[0]) == \
        ref_serve.cache_signature(ref, ref.backends[0])
    assert lane_key(spec, None, device=CPU) == ref_serve.lane_key(ref, None)


@pytest.mark.parametrize("axis", sorted(_RELEVANT_VALUES))
def test_keys_are_the_references_strings(axis):
    for v in _RELEVANT_VALUES[axis]:
        _assert_reference_keys(_spec().with_value(axis, v))


def test_unpackable_keys_give_the_references_reasons():
    for spec in (_spec(backends=[{"kind": "netsim"}]),
                 _spec(controller={"kind": "dense_adaptive", "params": {}},
                       schedule={"kind": "adaptive", "params": {"h0": 2}}),
                 _spec(backends=[{"kind": "dense",
                                  "params": {"loop": "segment"}}]),
                 _spec(problem={"kind": "no_such_problem", "params": {}})):
        _assert_reference_keys(spec)


@settings(max_examples=50, deadline=None)
@given(a=_IRRELEVANT, b=_IRRELEVANT)
def test_cache_key_ignores_cache_irrelevant_fields(a, b):
    base = _spec()
    backend = base.backends[0]
    specs = []
    for fields in (a, b):
        s = base
        for axis, v in fields.items():
            s = s.with_value(axis, v)
        specs.append(s)
    assert cache_signature(specs[0], backend) == \
        cache_signature(specs[1], backend)
    _assert_reference_keys(specs[0])


@settings(max_examples=50, deadline=None)
@given(axis=st.sampled_from(sorted(_RELEVANT_AXES)), data=st.data())
def test_cache_key_separates_shape_relevant_fields(axis, data):
    strat = _RELEVANT_AXES[axis]
    v1 = data.draw(strat)
    v2 = data.draw(strat.filter(lambda v: v != v1))
    base = _spec()
    backend = base.backends[0]
    s1, s2 = base.with_value(axis, v1), base.with_value(axis, v2)
    assert cache_signature(s1, backend) != cache_signature(s2, backend)
    _assert_reference_keys(s1)


@settings(max_examples=25, deadline=None)
@given(pool=st.lists(
    st.fixed_dictionaries({
        "seed": st.integers(0, 3),
        "r": st.sampled_from([0.0, 0.01]),
        "T": st.sampled_from([20, 40]),
        "schedule": st.sampled_from([
            {"kind": "every"},
            {"kind": "periodic", "params": {"h": 2}},
            {"kind": "periodic", "params": {"h": 4}},
        ]),
    }), min_size=2, max_size=6))
def test_packer_admission_is_symmetric_and_transitive(pool):
    """The admission predicate (equal non-None lane keys) is an
    equivalence relation over any generated spec pool, so lanes are
    well-defined partitions -- no ordering effects in what packs."""
    specs = [_spec(name=f"p{i}", **fields) for i, fields in enumerate(pool)]
    keys = [lane_key(s, None, device=CPU)[0] for s in specs]
    assert keys == [ref_serve.lane_key(_ref(s), None)[0] for s in specs]

    def compat(i, j):
        return (keys[i] is not None and keys[j] is not None
                and keys[i] == keys[j])

    idx = range(len(specs))
    for i in idx:
        assert compat(i, i) or keys[i] is None  # reflexive when packable
        for j in idx:
            assert compat(i, j) == compat(j, i)  # symmetric
            for k in idx:
                if compat(i, j) and compat(j, k):
                    assert compat(i, k)  # transitive


@pytest.mark.parametrize("axis", sorted(_RELEVANT_VALUES))
def test_cache_key_axis_inventory(axis):
    """Non-hypothesis floor under the property tests: for every declared
    shape-relevant axis, pairwise-distinct values give pairwise-distinct
    signatures (so the strategies above cannot silently test nothing)."""
    base = _spec()
    backend = base.backends[0]
    sigs = [cache_signature(base.with_value(axis, v), backend)
            for v in _RELEVANT_VALUES[axis]]
    assert len(set(sigs)) == len(sigs), axis
