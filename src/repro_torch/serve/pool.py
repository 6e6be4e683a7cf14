"""`WorkerPool`: supervised spawn-based worker processes for the server,
on the port (`repro.serve.pool`).

The in-process server runs every request in the parent process, which
makes one wedged or killed run a whole-server outage. This module moves
execution into N spawn-based worker processes (spawn: a fork after CUDA
has started breaks CUDA), each owning its own CUDA context, kernel
library load and `CompileCache` -- so a worker's first job of a shape is
a cold one -- with a supervisor thread in the parent that:

  * ships jobs as canonical spec JSON over a duplex pipe (results come
    back as exact `RunResult.to_json` strings, so bit-identity survives
    the process boundary the same way it survives the TCP one);
  * watches every worker's process sentinel and pipe; a crash (SIGKILL,
    segfault, uncaught BaseException) is detected the moment the
    sentinel fires, the lost in-flight job is transparently re-enqueued
    at the front of the queue (safe: every run is deterministic and
    side-effect-free until its Future resolves), and the worker is
    restarted under capped exponential backoff;
  * enforces per-job deadlines -- a worker that blows its job's deadline
    is SIGKILLed and replaced, and the job fails with
    `DeadlineExceeded` (deadline overruns are never re-enqueued: the
    client's budget is already spent);
  * heartbeats idle workers (ping/pong) so a wedged-but-alive worker is
    detected and replaced even when no job is queued.

Execution semantics are shared with the in-process path through
`execute_requests` (solo `repro_torch.run()` / cache-leased dense /
packed `run_batch` lane), so `--workers N` is gated bit-identical to the
in-process server by the same differential tier.

`worker_main` is injectable so the supervisor's crash/hang/deadline
machinery is unit-testable with a toy worker (`_toy_worker_main`) that
costs milliseconds: this module imports nothing of torch at its top, so
a toy worker's spawn loads none of it.
"""

from __future__ import annotations

import collections
import dataclasses
import multiprocessing
import os
import signal
import threading
import time
from concurrent.futures import Future
from multiprocessing import connection as mp_connection
from typing import Any, Callable

__all__ = ["DeadlineExceeded", "PoolError", "WorkerCrashed", "WorkerPool",
           "execute_requests"]


class PoolError(RuntimeError):
    """Pool-level failure (closed pool, unserviceable job)."""


class WorkerCrashed(PoolError):
    """A job died with its worker more times than the re-enqueue cap."""


class DeadlineExceeded(PoolError):
    """The job's deadline passed -- either shed before dispatch or its
    worker was killed mid-run. `shed` distinguishes the two."""

    def __init__(self, msg: str, shed: bool = False):
        super().__init__(msg)
        self.shed = shed


# ---------------------------------------------------------------------------
# shared execution semantics (parent in-process path AND worker processes)
# ---------------------------------------------------------------------------


def execute_requests(specs: list, backends: list, cache, *,
                     device=None) -> tuple[list, dict]:
    """Run one job -- solo when a single spec, else one packed `run_batch`
    lane -- on `device` (None: the CUDA card) and return `(results,
    meta)`.

    This is the single definition of serving execution semantics: the
    in-process server path and every worker process call it, which is
    what keeps `--workers N` bit-identical to the in-process server.
    `meta` carries lane bookkeeping (`cache_hit` for multi-spec lanes)
    that the caller folds into `RunMetrics` counters -- never into the
    scientific payload.
    """
    from repro_torch import resolve_device
    from repro_torch.experiments.runner import (_dense_lanes, _dense_parts,
                                                _dense_sim,
                                                _resolve_backend,
                                                _run_dense)
    from repro_torch.experiments.runner import run as _run

    if len(specs) == 1:
        backend = _resolve_backend(specs[0], backends[0])
        if backend.kind == "dense":
            return [_run_dense(specs[0], backend, sim_cache=cache,
                               device=device)], {}
        return [_run(specs[0], backend=backend, device=device)], {}

    device = resolve_device(device)
    resolved = [_resolve_backend(s, b) for s, b in zip(specs, backends)]
    parts = _dense_parts(specs[0], resolved[0], device)
    # the lease is waited for outside DEVICE_LOCK: its holder may capture
    with cache.lease(specs[0], resolved[0],
                     lambda: _dense_sim(specs[0], parts, device)) as (sim,
                                                                      hit):
        sim.schedule = parts["schedule"]
        sim.r = specs[0].r
        results = _dense_lanes(specs, resolved, sim, parts,
                               lane_counter="lane_width")
    return results, {"cache_hit": hit}


def _ser_backend(backend: Any) -> Any:
    """Backend selectors are None | str | int | ComponentSpec; only the
    last needs explicit serialization for the pipe."""
    from repro_torch.experiments.spec import ComponentSpec

    if isinstance(backend, ComponentSpec):
        return {"__component__": backend.to_dict()}
    return backend


def _deser_backend(ser: Any) -> Any:
    from repro_torch.experiments.spec import ComponentSpec

    if isinstance(ser, dict) and "__component__" in ser:
        return ComponentSpec.from_dict(ser["__component__"])
    return ser


# ---------------------------------------------------------------------------
# worker process mains (module-level: spawn requires picklable targets)
# ---------------------------------------------------------------------------


def _worker_main(conn, cache_entries: int = 32, device=None) -> None:
    """Real worker: owns a private CompileCache, runs every job on
    `device` (None: the CUDA card), loops on the pipe.

    Protocol (tuples over the duplex pipe):
      -> ("run", job_id, [spec_json, ...], [backend_ser, ...])
      <- ("ok", job_id, [result_json, ...], meta) | ("err", job_id, type, msg)
      -> ("ping", token)   <- ("pong", token)
      -> ("stop",)         (worker exits cleanly)

    Only `Exception` is caught per job; a BaseException (or SIGKILL)
    takes the process down and the supervisor's sentinel watch handles
    it -- that IS the crash path, not an error to mask.
    """
    # the parent owns lifecycle: a terminal Ctrl-C must not race the
    # supervisor's graceful drain
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    from repro_torch.experiments.result import RunResult  # noqa: F401
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.serve.cache import CompileCache

    cache = CompileCache(max_entries=cache_entries)
    conn.send(("ready", os.getpid()))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return  # parent went away
        op = msg[0]
        if op == "stop":
            return
        if op == "ping":
            conn.send(("pong", msg[1]))
            continue
        if op != "run":
            continue
        _, job_id, spec_jsons, backend_sers = msg
        try:
            specs = [ExperimentSpec.from_json(s) for s in spec_jsons]
            backends = [_deser_backend(b) for b in backend_sers]
            results, meta = execute_requests(specs, backends, cache,
                                             device=device)
            payload = [r.to_json() for r in results]
            conn.send(("ok", job_id, payload, meta))
        except Exception as e:  # noqa: BLE001 -- per-job failure surface
            conn.send(("err", job_id, type(e).__name__, str(e)))


def _toy_worker_main(conn, cache_entries: int = 32, device=None) -> None:
    """Test double for the supervisor: interprets each spec_json as a
    JSON command dict instead of an ExperimentSpec.

      {"action": "echo", "value": x}       -> result json '{"value": x}'
      {"action": "sleep", "s": 1.0, ...}   -> sleeps, then echoes
      {"action": "crash"}                  -> os._exit(13) (simulated kill)
      {"action": "crash_once", "marker": p} -> crashes only while the
          marker file does not exist (touches it first), so a re-enqueued
          job succeeds on the retry -- the transparent-re-enqueue test.
    """
    import json

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    conn.send(("ready", os.getpid()))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg[0] == "stop":
            return
        if msg[0] == "ping":
            conn.send(("pong", msg[1]))
            continue
        _, job_id, spec_jsons, _backends = msg
        try:
            out = []
            for s in spec_jsons:
                cmd = json.loads(s)
                action = cmd.get("action", "echo")
                if action == "sleep":
                    time.sleep(float(cmd.get("s", 0.1)))
                elif action == "crash":
                    os._exit(13)
                elif action == "crash_once":
                    marker = cmd["marker"]
                    if not os.path.exists(marker):
                        with open(marker, "w") as f:
                            f.write(str(os.getpid()))
                        os._exit(13)
                elif action == "raise":
                    raise ValueError(cmd.get("msg", "toy failure"))
                out.append(json.dumps({"value": cmd.get("value"),
                                       "pid": os.getpid()}))
            conn.send(("ok", job_id, out, {"pid": os.getpid()}))
        except Exception as e:  # noqa: BLE001
            conn.send(("err", job_id, type(e).__name__, str(e)))


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Job:
    id: int
    spec_jsons: list
    backend_sers: list
    future: Future
    deadline: float | None  # absolute time.monotonic(), None = unbounded
    reenqueues: int = 0


class _Slot:
    """One worker seat: its live process/pipe plus restart bookkeeping."""

    def __init__(self, slot_id: int):
        self.id = slot_id
        self.proc = None
        self.conn = None
        self.ready = False
        self.job: _Job | None = None
        self.dispatched_at = 0.0
        self.spawned = 0            # lifetime spawn count for this seat
        self.consec_failures = 0    # resets on a completed job
        self.backoff_until = 0.0
        self.last_hb = 0.0
        self.awaiting_pong = False
        self.pong_deadline = 0.0


class WorkerPool:
    """N supervised spawn workers behind a `submit() -> Future` facade.

    Args:
      processes: worker count (>= 1; the server's `processes=0` means "no
        pool at all", not a zero-width pool).
      cache_entries: per-worker CompileCache capacity.
      max_reenqueues: how many times a job lost to a worker crash is
        transparently retried before failing with `WorkerCrashed`.
      backoff_base_s / backoff_cap_s: capped exponential restart backoff
        (base * 2**(consecutive_failures-1), clamped to the cap; resets
        once a worker completes a job).
      heartbeat_s / heartbeat_timeout_s: idle-worker ping cadence and how
        long a missing pong is tolerated before the worker is replaced.
      chaos: optional `ChaosMonkey`; `on_dispatch(ordinal, proc)` is
        called after every job dispatch so a seeded plan can SIGKILL
        workers mid-run.
      worker_main: injectable process target (tests use
        `_toy_worker_main`); must be module-level picklable.
      device: where the workers run their jobs, passed to each as a
        string (None: the CUDA card, resolved in the worker).
    """

    def __init__(self, processes: int, *, cache_entries: int = 32,
                 max_reenqueues: int = 2, backoff_base_s: float = 0.25,
                 backoff_cap_s: float = 5.0, heartbeat_s: float = 5.0,
                 heartbeat_timeout_s: float = 30.0, chaos=None,
                 worker_main: Callable = _worker_main, device=None):
        if processes < 1:
            raise ValueError("WorkerPool needs processes >= 1 "
                             "(use the in-process server path for 0)")
        self.max_reenqueues = max_reenqueues
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.chaos = chaos
        self._cache_entries = cache_entries
        self._worker_main = worker_main
        self._device = None if device is None else str(device)
        self._ctx = multiprocessing.get_context("spawn")
        self._slots = [_Slot(i) for i in range(processes)]
        self._pending: collections.deque[_Job] = collections.deque()
        self._lock = threading.Lock()
        self._wake_r, self._wake_w = self._ctx.Pipe(duplex=False)
        self._closing = False
        self._drain = True
        self._job_seq = 0
        self._dispatches = 0
        self._rr = 0
        self._hb_seq = 0
        # robustness counters (surfaced on server stats / RunMetrics)
        self.worker_restarts = 0
        self.reenqueues = 0
        self.deadline_missed = 0
        self.jobs_ok = 0
        self.jobs_failed = 0
        self._supervisor = threading.Thread(
            target=self._supervise, name="repro-serve-pool", daemon=True)
        self._supervisor.start()

    # -- public API ----------------------------------------------------------

    def submit(self, spec_jsons: list, backend_sers: list,
               deadline: float | None = None) -> Future:
        """Enqueue one job (a solo request or a whole packed lane).

        Resolves to `(result_jsons, meta)`; meta carries `cache_hit`,
        `reenqueues`, `dispatched_at`, and the worker slot id."""
        with self._lock:
            if self._closing:
                raise PoolError("worker pool is closed")
            self._job_seq += 1
            job = _Job(id=self._job_seq, spec_jsons=list(spec_jsons),
                       backend_sers=list(backend_sers), future=Future(),
                       deadline=deadline)
            self._pending.append(job)
        self._wake()
        return job.future

    def stats(self) -> dict[str, Any]:
        with self._lock:
            pending = len(self._pending)
        busy = sum(1 for s in self._slots if s.job is not None)
        alive = sum(1 for s in self._slots
                    if s.proc is not None and s.proc.is_alive())
        return {
            "processes": len(self._slots),
            "alive": alive,
            "busy": busy,
            "pending": pending,
            "dispatches": self._dispatches,
            "jobs_ok": self.jobs_ok,
            "jobs_failed": self.jobs_failed,
            "worker_restarts": self.worker_restarts,
            "reenqueues": self.reenqueues,
            "deadline_missed": self.deadline_missed,
        }

    def close(self, drain: bool = True, timeout: float | None = None) -> None:
        """Stop the pool. `drain=True` finishes queued + in-flight jobs
        first; `drain=False` fails them all with `PoolError`."""
        with self._lock:
            self._closing = True
            self._drain = drain
        self._wake()
        self._supervisor.join(timeout)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- supervisor loop -----------------------------------------------------

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _supervise(self) -> None:
        try:
            self._supervise_loop()
        finally:
            self._stop_workers()
            self._abort_pending(PoolError("worker pool is closed"))

    def _supervise_loop(self) -> None:
        while True:
            now = time.monotonic()
            with self._lock:
                closing, drain = self._closing, self._drain
            if closing and not drain:
                for s in self._slots:
                    if s.job is not None:
                        self._fail_job(s.job, PoolError("worker pool closed "
                                                        "without drain"))
                        s.job = None
                        self._kill_slot(s)
                return
            if closing and self._idle():
                return
            for s in self._slots:
                if s.proc is None and now >= s.backoff_until:
                    self._spawn(s)
            self._dispatch_jobs()
            if closing and self._idle():
                return
            ready = self._wait(now)
            if self._wake_r in ready:
                while self._wake_r.poll(0):
                    try:
                        self._wake_r.recv()
                    except (EOFError, OSError):
                        break
            for s in self._slots:
                if s.conn is not None and s.conn in ready:
                    self._drain_conn(s)
            for s in self._slots:
                if (s.proc is not None and s.proc.sentinel in ready
                        and not s.proc.is_alive()):
                    self._on_death(s, "worker process died")
            self._enforce_deadlines()
            self._heartbeat()

    def _idle(self) -> bool:
        with self._lock:
            if self._pending:
                return False
        return all(s.job is None for s in self._slots)

    def _wait(self, now: float) -> set:
        waits: list[Any] = [self._wake_r]
        wake_times = []
        for s in self._slots:
            if s.conn is not None:
                waits.append(s.conn)
            if s.proc is not None:
                waits.append(s.proc.sentinel)
            else:
                wake_times.append(s.backoff_until)
            if s.job is not None and s.job.deadline is not None:
                wake_times.append(s.job.deadline)
            if s.awaiting_pong:
                wake_times.append(s.pong_deadline)
        wake_times.append(now + self.heartbeat_s)
        timeout = max(0.0, min(wake_times) - now)
        try:
            ready = mp_connection.wait(waits, timeout)
        except OSError:
            ready = []
        return set(ready)

    # -- spawning / death ----------------------------------------------------

    def _spawn(self, s: _Slot) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=self._worker_main,
            args=(child_conn, self._cache_entries, self._device),
            name=f"repro-serve-worker-{s.id}", daemon=True)
        proc.start()
        child_conn.close()
        s.proc, s.conn, s.ready = proc, parent_conn, False
        s.spawned += 1
        s.last_hb = time.monotonic()
        s.awaiting_pong = False
        if s.spawned > 1:
            self.worker_restarts += 1

    def _on_death(self, s: _Slot, why: str) -> None:
        job, s.job = s.job, None
        if s.conn is not None:
            try:
                s.conn.close()
            except OSError:
                pass
        if s.proc is not None:
            s.proc.join(timeout=0)
        s.proc, s.conn, s.ready = None, None, False
        s.awaiting_pong = False
        s.consec_failures += 1
        backoff = min(self.backoff_cap_s,
                      self.backoff_base_s * 2 ** (s.consec_failures - 1))
        s.backoff_until = time.monotonic() + backoff
        if job is not None:
            job.reenqueues += 1
            self.reenqueues += 1
            if job.reenqueues > self.max_reenqueues:
                self._fail_job(job, WorkerCrashed(
                    f"job lost to {job.reenqueues} worker crashes "
                    f"(cap {self.max_reenqueues}): {why}"))
            else:
                with self._lock:
                    self._pending.appendleft(job)

    def _kill_slot(self, s: _Slot) -> None:
        if s.proc is not None:
            try:
                s.proc.kill()
            except (OSError, AttributeError):
                pass
            s.proc.join(timeout=5)
        self._on_death_cleanup(s)

    def _on_death_cleanup(self, s: _Slot) -> None:
        if s.conn is not None:
            try:
                s.conn.close()
            except OSError:
                pass
        s.proc, s.conn, s.ready = None, None, False
        s.awaiting_pong = False
        s.consec_failures += 1
        s.backoff_until = time.monotonic() + min(
            self.backoff_cap_s,
            self.backoff_base_s * 2 ** (s.consec_failures - 1))

    # -- pipe traffic --------------------------------------------------------

    def _drain_conn(self, s: _Slot) -> None:
        while s.conn is not None and s.conn.poll(0):
            try:
                msg = s.conn.recv()
            except (EOFError, OSError):
                self._on_death(s, "worker pipe closed")
                return
            self._handle_msg(s, msg)

    def _handle_msg(self, s: _Slot, msg: tuple) -> None:
        kind = msg[0]
        if kind == "ready":
            s.ready = True
        elif kind == "pong":
            s.awaiting_pong = False
        elif kind == "ok":
            _, job_id, payload, meta = msg
            if s.job is not None and s.job.id == job_id:
                job, s.job = s.job, None
                s.consec_failures = 0
                self.jobs_ok += 1
                meta = dict(meta)
                meta.setdefault("reenqueues", job.reenqueues)
                meta.setdefault("worker", s.id)
                meta.setdefault("dispatched_at", s.dispatched_at)
                if not job.future.set_running_or_notify_cancel():
                    return
                job.future.set_result((payload, meta))
        elif kind == "err":
            _, job_id, type_name, text = msg
            if s.job is not None and s.job.id == job_id:
                job, s.job = s.job, None
                s.consec_failures = 0  # the worker itself is healthy
                self._fail_job(job, _revive_exception(type_name, text))

    # -- dispatch / deadlines / heartbeats ----------------------------------

    def _dispatch_jobs(self) -> None:
        now = time.monotonic()
        # round-robin over slots (not first-free) so successive jobs
        # spread across workers: each worker's private compile cache
        # warms instead of one hot worker absorbing every dispatch
        n = len(self._slots)
        order = [self._slots[(self._rr + i) % n] for i in range(n)]
        for s in order:
            if s.proc is None or not s.ready or s.job is not None:
                continue
            while True:  # shed expired heads without wasting the slot
                with self._lock:
                    job = self._pending.popleft() if self._pending else None
                if job is None:
                    return
                if job.deadline is not None and now > job.deadline:
                    self.deadline_missed += 1
                    self._fail_job(job, DeadlineExceeded(
                        "deadline expired before dispatch", shed=True))
                    continue
                break
            self._dispatches += 1
            self._rr = (self._slots.index(s) + 1) % n
            s.job, s.dispatched_at = job, now
            try:
                s.conn.send(("run", job.id, job.spec_jsons, job.backend_sers))
            except OSError:
                self._on_death(s, "worker pipe broken at dispatch")
                continue
            if self.chaos is not None:
                self.chaos.on_dispatch(self._dispatches, s.proc)

    def _enforce_deadlines(self) -> None:
        now = time.monotonic()
        for s in self._slots:
            job = s.job
            if job is not None and job.deadline is not None \
                    and now > job.deadline:
                self.deadline_missed += 1
                s.job = None
                self._fail_job(job, DeadlineExceeded(
                    f"deadline exceeded {now - job.deadline:.3f}s into "
                    "the run; worker killed"))
                self._kill_slot(s)

    def _heartbeat(self) -> None:
        now = time.monotonic()
        for s in self._slots:
            if s.proc is None or s.conn is None:
                continue
            if s.awaiting_pong and now > s.pong_deadline:
                self._fail_job_of(s, "worker unresponsive to heartbeat")
                self._kill_slot(s)
                continue
            if (s.ready and s.job is None and not s.awaiting_pong
                    and now - s.last_hb >= self.heartbeat_s):
                self._hb_seq += 1
                try:
                    s.conn.send(("ping", self._hb_seq))
                except OSError:
                    self._on_death(s, "worker pipe broken at heartbeat")
                    continue
                s.awaiting_pong = True
                s.last_hb = now
                s.pong_deadline = now + self.heartbeat_timeout_s

    def _fail_job_of(self, s: _Slot, why: str) -> None:
        job, s.job = s.job, None
        if job is not None:
            job.reenqueues += 1
            self.reenqueues += 1
            if job.reenqueues > self.max_reenqueues:
                self._fail_job(job, WorkerCrashed(why))
            else:
                with self._lock:
                    self._pending.appendleft(job)

    # -- teardown ------------------------------------------------------------

    def _fail_job(self, job: _Job, exc: BaseException) -> None:
        self.jobs_failed += 1
        if not job.future.done():
            job.future.set_exception(exc)

    def _abort_pending(self, exc: BaseException) -> None:
        while True:
            with self._lock:
                job = self._pending.popleft() if self._pending else None
            if job is None:
                return
            self._fail_job(job, exc)

    def _stop_workers(self) -> None:
        for s in self._slots:
            if s.conn is not None:
                try:
                    s.conn.send(("stop",))
                except OSError:
                    pass
        for s in self._slots:
            if s.proc is not None:
                s.proc.join(timeout=5)
                if s.proc.is_alive():
                    try:
                        s.proc.kill()
                    except OSError:
                        pass
                    s.proc.join(timeout=5)
            if s.conn is not None:
                try:
                    s.conn.close()
                except OSError:
                    pass
            s.proc, s.conn, s.ready = None, None, False


def _revive_exception(type_name: str, text: str) -> Exception:
    """Rebuild a worker-reported exception: builtin types round-trip
    (ValueError stays ValueError for the client's error event), anything
    else degrades to a RuntimeError carrying the remote type name."""
    import builtins

    cls = getattr(builtins, type_name, None)
    if isinstance(cls, type) and issubclass(cls, Exception):
        try:
            return cls(text)
        except Exception:  # noqa: BLE001 -- exotic constructor signature
            pass
    return RuntimeError(f"{type_name}: {text}")
