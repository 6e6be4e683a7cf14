"""The robustness tier for `repro_torch.serve`, the copy of
tests/test_serve_pool.py on the port (CPU, `device="cpu"`): supervised
worker pools, deadlines, retries/dedup, load shedding, and real-process
chaos.

Three layers, cheapest first:

  * `WorkerPool` units against `_toy_worker_main` -- a spawn worker that
    interprets commands (sleep/crash/echo) instead of running the port,
    so crash re-enqueue, the re-enqueue cap, deadline kills, and drain
    semantics are exercised in real processes for milliseconds each (a
    toy worker imports no torch: it is held to that here too).
  * Server-level robustness with the in-process executor: bounded
    admission (`Overloaded` + retry-after hint), deadline shedding,
    idempotency dedup (in-flight join + completed replay, never a
    second execution), graceful-drain refusal, and the satellite-(a)
    regression -- a `SystemExit` escaping a run must tear the server
    down, not masquerade as a run failure.
  * The chaos gate (`-m chaos`): a real pooled server behind a
    `ChaosProxy`, a seeded `ChaosPlan` SIGKILLing a worker mid-run and
    tearing a response line, a retrying `Client` -- every request must
    still end bit-identical to a solo `repro_torch.run()`, and match the
    reference's served results (`convert.assert_results_match`), with at
    most one execution per idempotency key.

Client transport units (per-op timeouts, torn-line detection, tolerant
shutdown) run against tiny hand-rolled socket servers.
"""

import json
import os
import socket
import threading
import time

import pytest

import repro
import repro.serve as ref_serve

import repro_torch
from repro_torch.convert import assert_results_match
from repro_torch.experiments import ExperimentSpec
from repro_torch.serve import (ChaosPlan, ChaosProxy, Client,
                               DeadlineExceeded, ExperimentServer,
                               Overloaded, PoolError, ShuttingDown,
                               WorkerCrashed, WorkerPool,
                               comparable_result_dict)
from repro_torch.serve.pool import _toy_worker_main

CPU = "cpu"


def _spec(**kw):
    base = dict(
        name="robust",
        problem={"kind": "quadratic_consensus",
                 "params": {"n": 8, "d": 6, "seed": 0}},
        topology={"kind": "expander", "params": {"k": 4, "seed": 0}},
        schedule={"kind": "periodic", "params": {"h": 2}},
        backends=[{"kind": "dense"}],
        stepsize={"kind": "sqrt", "params": {"A": 0.5}},
        T=60, eval_every=20, seed=0, r=0.01, eps_frac=0.05)
    base.update(kw)
    return ExperimentSpec(**base)


def _toy_pool(**kw):
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_cap_s", 0.2)
    return WorkerPool(kw.pop("processes", 1), worker_main=_toy_worker_main,
                      **kw)


def _cmd(**kw):
    return json.dumps(kw)


def _solo(spec):
    return repro_torch.run(spec, backend="dense", device=CPU)


def _ref_served(specs):
    """The reference's served results for `specs`, one request after the
    other as the chaos gate's client sends them (its in-process
    server)."""
    with ref_serve.ExperimentServer(workers=1, max_wait_s=0.02) as srv:
        return [srv.submit(repro.ExperimentSpec.from_json(s.to_json()),
                           backend="dense").result(timeout=180)
                for s in specs]


# ---------------------------------------------------------------------------
# WorkerPool units (toy workers: real processes, no XLA)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_toy_pool_echo_roundtrip():
    with _toy_pool(processes=2) as pool:
        futs = [pool.submit([_cmd(action="echo", value=i)], [None])
                for i in range(6)]
        for i, f in enumerate(futs):
            payload, meta = f.result(timeout=60)
            assert json.loads(payload[0])["value"] == i
            assert meta["reenqueues"] == 0
        assert pool.stats()["jobs_ok"] == 6


@pytest.mark.chaos
def test_crash_is_reenqueued_transparently(tmp_path):
    """A worker crash mid-job re-enqueues the job; the retry succeeds
    (the marker file makes the crash one-shot) and the caller never sees
    the failure -- only the `reenqueues` meta records it."""
    marker = str(tmp_path / "crashed-once")
    with _toy_pool(processes=1) as pool:
        payload, meta = pool.submit(
            [_cmd(action="crash_once", marker=marker)], [None]
        ).result(timeout=60)
        assert meta["reenqueues"] == 1
        stats = pool.stats()
        assert stats["worker_restarts"] >= 1
        assert stats["reenqueues"] == 1
        assert stats["jobs_ok"] == 1
    assert os.path.exists(marker)


@pytest.mark.chaos
def test_reenqueue_cap_fails_job():
    """A job that kills every worker it touches must not loop forever:
    after max_reenqueues crashes it fails with WorkerCrashed."""
    with _toy_pool(processes=1, max_reenqueues=2) as pool:
        fut = pool.submit([_cmd(action="crash")], [None])
        with pytest.raises(WorkerCrashed):
            fut.result(timeout=60)
        assert pool.stats()["reenqueues"] == 3  # initial + 2 retries
        # the pool survives its poison pill: next job runs fine
        payload, _ = pool.submit([_cmd(action="echo", value=7)],
                                 [None]).result(timeout=60)
        assert json.loads(payload[0])["value"] == 7


@pytest.mark.chaos
def test_deadline_kills_overrunning_worker():
    with _toy_pool(processes=1) as pool:
        # wait out the spawn first, so the deadline can only expire
        # MID-RUN (a slow spawn would otherwise shed it pre-dispatch)
        pool.submit([_cmd(action="echo", value=0)], [None]).result(timeout=60)
        fut = pool.submit([_cmd(action="sleep", s=30)], [None],
                          deadline=time.monotonic() + 0.5)
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=60)
        assert not ei.value.shed  # killed mid-run, not shed
        assert pool.stats()["deadline_missed"] == 1
        # the killed worker's replacement serves the next job
        payload, _ = pool.submit([_cmd(action="echo", value=1)],
                                 [None]).result(timeout=60)
        assert json.loads(payload[0])["value"] == 1


@pytest.mark.chaos
def test_expired_job_is_shed_not_run():
    with _toy_pool(processes=1) as pool:
        # occupy the worker so the expired job sits in the queue
        slow = pool.submit([_cmd(action="sleep", s=1.0)], [None])
        fut = pool.submit([_cmd(action="echo", value=1)], [None],
                          deadline=time.monotonic() + 0.05)
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=60)
        assert ei.value.shed
        slow.result(timeout=60)


@pytest.mark.chaos
def test_worker_error_does_not_restart_worker():
    """An in-worker Exception is a job failure, not a crash: the same
    process keeps serving and the exception type round-trips."""
    with _toy_pool(processes=1) as pool:
        fut = pool.submit([_cmd(action="raise", msg="boom")], [None])
        with pytest.raises(ValueError, match="boom"):
            fut.result(timeout=60)
        payload, meta = pool.submit([_cmd(action="echo", value=2)],
                                    [None]).result(timeout=60)
        assert json.loads(payload[0])["value"] == 2
        assert pool.stats()["worker_restarts"] == 0


@pytest.mark.chaos
def test_pool_drain_then_refuse():
    pool = _toy_pool(processes=1)
    fut = pool.submit([_cmd(action="sleep", s=0.3, value=9)], [None])
    pool.close(drain=True)
    payload, _ = fut.result(timeout=60)  # drained, not dropped
    assert json.loads(payload[0])["value"] == 9
    with pytest.raises(PoolError):
        pool.submit([_cmd(action="echo")], [None])


# ---------------------------------------------------------------------------
# server-level robustness (in-process executor: no spawn cost)
# ---------------------------------------------------------------------------


def test_overloaded_admission_with_retry_after_hint():
    with ExperimentServer(workers=1, max_queue=2, device=CPU) as srv:
        srv._pending_n = 2  # saturate admission deterministically
        with pytest.raises(Overloaded) as ei:
            srv.submit(_spec())
        assert ei.value.retry_after_s > 0
        assert srv.stats()["robustness"]["overloaded"] == 1
        srv._pending_n = 0


def test_expired_request_is_shed_server_side():
    with ExperimentServer(workers=1, packing=False, device=CPU) as srv:
        fut = srv.submit(_spec(), backend="dense", deadline_s=0.0)
        with pytest.raises(DeadlineExceeded) as ei:
            fut.result(timeout=60)
        assert ei.value.shed
        assert srv.stats()["robustness"]["requests_shed"] == 1


def test_idempotency_dedup_inflight_and_replay():
    spec = _spec(name="idem")
    with ExperimentServer(workers=1, max_wait_s=0.01, device=CPU) as srv:
        f1 = srv.submit(spec, backend="dense", idempotency_key="k1")
        f2 = srv.submit(spec, backend="dense", idempotency_key="k1")
        assert f2 is f1  # in-flight join: same Future, one execution
        r1 = f1.result(timeout=120)
        f3 = srv.submit(spec, backend="dense", idempotency_key="k1")
        assert f3.result(timeout=5) is r1  # completed key replays
        st = srv.stats()
        assert st["robustness"]["requests_retried"] == 2
        assert st["dedup"]["max_executions_per_key"] == 1
        assert comparable_result_dict(r1) == comparable_result_dict(
            _solo(spec))


def test_closed_server_refuses_with_shutting_down():
    srv = ExperimentServer(workers=1, device=CPU)
    srv.close()
    with pytest.raises(ShuttingDown):
        srv.submit(_spec())


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fatal_signal_tears_server_down_not_masked():
    """Satellite (a): SystemExit out of a run is not swallowed as a run
    failure -- the waiter is failed (no stranded client) AND the server
    records the fatal and tears down, refusing further work."""
    from repro_torch.experiments.components import problems

    @problems.register("exploding_problem_for_test")
    def _exploding(**kw):
        raise SystemExit(3)

    try:
        spec = _spec(name="fatal",
                     problem={"kind": "exploding_problem_for_test",
                              "params": {}})
        srv = ExperimentServer(workers=1, max_wait_s=0.01, device=CPU)
        try:
            fut = srv.submit(spec, backend="dense")
            with pytest.raises(SystemExit):
                fut.result(timeout=60)
            deadline = time.monotonic() + 10
            while srv.fatal is None and time.monotonic() < deadline:
                time.sleep(0.01)
            assert isinstance(srv.fatal, SystemExit)
            assert srv.stats()["server"]["fatal"] is not None
            deadline = time.monotonic() + 10
            while not srv._closed and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(ShuttingDown):
                srv.submit(_spec())
        finally:
            srv.close()
    finally:
        problems._builders.pop("exploding_problem_for_test", None)


# ---------------------------------------------------------------------------
# client transport units (hand-rolled socket peers)
# ---------------------------------------------------------------------------


def _fake_server(behavior):
    """One-connection-at-a-time fake server; `behavior(conn, rfile)` is
    called per accepted connection. Returns (host, port, close)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)

    def loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                behavior(conn, conn.makefile("rb"))
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    threading.Thread(target=loop, daemon=True).start()
    host, port = srv.getsockname()[:2]
    return host, port, srv.close


def test_client_shutdown_tolerates_connection_close():
    """Satellite (b): a server that closes the connection instead of
    replying "bye" is a clean shutdown, not a ConnectionResetError."""
    def behavior(conn, rfile):
        rfile.readline()  # the shutdown op
        import struct
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))  # hard RST on close
        conn.close()

    host, port, close = _fake_server(behavior)
    try:
        with Client(host, port, timeout=5) as c:
            c.shutdown()  # must not raise
    finally:
        close()


def test_client_per_op_timeout_override():
    """Satellite (b): a per-op timeout beats the connect-time default."""
    def behavior(conn, rfile):
        rfile.readline()
        time.sleep(5)  # never answer within the op timeout

    host, port, close = _fake_server(behavior)
    try:
        with Client(host, port, timeout=60) as c:
            t0 = time.monotonic()
            with pytest.raises(OSError):
                c.ping(timeout=0.2)
            assert time.monotonic() - t0 < 2
    finally:
        close()


def test_client_detects_torn_response_line():
    """A response cut mid-line is a transport error (retryable), not a
    JSON parse crash."""
    def behavior(conn, rfile):
        rfile.readline()
        conn.sendall(b'{"event": "po')  # torn: no newline, then close

    host, port, close = _fake_server(behavior)
    try:
        with Client(host, port, timeout=5) as c:
            with pytest.raises(ConnectionError, match="torn|closed"):
                c.ping()
    finally:
        close()


# ---------------------------------------------------------------------------
# the chaos gate (real pooled server + proxy + retrying client)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.serve
def test_chaos_gate_bit_identical_and_no_double_execution():
    """The acceptance gate: a seeded ChaosPlan SIGKILLs a worker mid-run
    and tears one TCP response; every request must still succeed (via
    re-enqueue or client retry) bit-identical to a solo
    repro_torch.run(), with at most one execution per idempotency key;
    and each matches the reference's served result."""
    specs = [_spec(name=f"chaos{i}", seed=i) for i in range(3)]
    solos = {s.seed: _solo(s) for s in specs}
    plan = ChaosPlan(seed=7, kill_at_dispatch=(1,),
                     kill_delay_s=(0.05, 0.3),
                     tear_response_at=(5,))
    srv = ExperimentServer(processes=2, max_wait_s=0.02, chaos=plan,
                           pool_kwargs={"backoff_base_s": 0.05},
                           device=CPU)
    try:
        host, port = srv.start()
        with ChaosProxy(host, port, plan) as proxy:
            phost, pport = proxy.address
            with Client(phost, pport, timeout=240, retries=4,
                        seed=11) as client:
                results = {s.seed: client.run(s, backend="dense")
                           for s in specs}
        for seed, res in results.items():
            rt = repro_torch.RunResult.from_json(res.to_json())
            assert (comparable_result_dict(rt)
                    == comparable_result_dict(solos[seed])), \
                f"chaos seed {seed}: served result differs from solo"
        st = srv.stats()
        assert st["robustness"]["worker_restarts"] >= 1
        assert st["dedup"]["max_executions_per_key"] <= 1
        assert st["chaos"]["kills_delivered"] >= 1
        assert proxy.stats()["torn_responses"] == 1
    finally:
        srv.close()
    for spec, theirs in zip(specs, _ref_served(specs)):
        assert_results_match(results[spec.seed].to_dict(), theirs.to_dict())


@pytest.mark.chaos
@pytest.mark.serve
def test_pooled_server_inflight_survives_drain():
    """Graceful drain: in-flight pooled work finishes through close()."""
    spec = _spec(name="drain")
    solo = _solo(spec)
    srv = ExperimentServer(processes=1, packing=False, device=CPU)
    fut = srv.submit(spec, backend="dense")
    srv.close()  # drain, not drop
    res = fut.result(timeout=10)
    assert comparable_result_dict(res) == comparable_result_dict(solo)


@pytest.mark.chaos
@pytest.mark.serve
def test_pooled_unported_backend_fails_the_request_not_the_worker():
    """A served LM spec (the launch backend is not ported) fails with the
    NotImplementedError in its worker, which goes on serving."""
    lm = _spec(name="lm", backends=[{"kind": "launch"}])
    spec = _spec(name="after_lm")
    srv = ExperimentServer(processes=1, packing=False, device=CPU)
    try:
        with pytest.raises(NotImplementedError, match="launch backend"):
            srv.submit(lm).result(timeout=120)
        res = srv.submit(spec, backend="dense").result(timeout=120)
        assert comparable_result_dict(res) == comparable_result_dict(
            _solo(spec))
        assert srv.stats()["robustness"]["worker_restarts"] == 0
    finally:
        srv.close()
