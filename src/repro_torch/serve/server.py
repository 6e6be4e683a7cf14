"""`ExperimentServer`: the persistent multi-tenant run server, on the port
(`repro.serve.server` over the port's runner, on a CUDA card unless the
caller asks for the CPU).

Architecture (all stdlib):

    TCP clients ──> ThreadingTCPServer (JSON lines)──┐
                                                     v
    in-process submit() ──> admission (dedup, max_queue, deadline)
                                                     │ dispatcher thread
                                 ┌───────────────────┤
                                 v                   v
                          LanePacker (dense,   solo requests
                          shape-compatible)         │
                                 │ full / expired   │
                                 v                   v
                      _execute: shed expired, count executions
                                 │
                ┌────────────────┴────────────────┐
                v (processes == 0)                v (processes >= 1)
        ThreadPoolExecutor in-process      WorkerPool (spawn procs,
        (threads share the process)        supervised: crash restart,
                 │                         re-enqueue, deadline kill)
                 └───────> execute_requests <─────┘
                                 │
                  CompileCache.lease -> warm DDASimulator
                      (its captured graphs replayed)
                                 │
                        Future[RunResult] -> stream back

Dense requests lease simulators from a `CompileCache` (so repeat traffic
skips the library load, warm-up and capture entirely) and, when
shape-compatible with concurrent traffic, ride one `run_batch` lane
(`LanePacker`); netsim/launch requests run solo through the ordinary
`repro_torch.run()` path. Threads of one process capture one at a time
and otherwise replay side by side (`core.dda.DEVICE_LOCK`). With
`processes >= 1` whole jobs (solo or packed lane) ship to supervised
worker processes as canonical spec JSON and come back as exact
`RunResult` JSON -- bit-identity is gated by the same differential tier
either way. Every response carries the serving observability on its
`RunMetrics`: `cache_hit`/`cache_miss`, `queue_wait_s`, `lane_width`,
`lane_occupancy` counters, a `solo_reason` note when a dense request
could not pack, and `reenqueues` when a crashed worker's job was retried.

Robustness knobs: `deadline_s` (per-request budget; expired work is shed
pre-dispatch, an in-flight pool overrun SIGKILLs the worker), `max_queue`
(bounded admission; over-limit submits raise `Overloaded` with a
retry-after hint), idempotency keys (a retried request joins the
original's Future or replays its cached result -- never runs twice), and
graceful drain on `close()` (in-flight finishes, new submits raise
`ShuttingDown`).

Wire protocol (one JSON object per line, strict RFC both directions --
requests parse through the frozen `ExperimentSpec` schema, responses are
`json_sanitize`d result dicts):

    -> {"op": "run", "spec": {...}, "backend": "dense"?,
        "deadline_s": 30.0?, "idempotency_key": "..."?}
    <- {"event": "accepted", "name": ...}
    <- {"event": "trace", "lo": 0, "hi": 256, "total": N,
        "columns": {"iters": [...], "fvals": [...], ...}}   (chunked)
    <- {"event": "result", "result": {...}}     (trace omitted: streamed)
    -> {"op": "ping"} / {"op": "stats"} / {"op": "shutdown"}
    <- {"event": "pong"} / {"event": "stats", ...} / {"event": "bye"}
    <- {"event": "error", "error": "...", "type": "Overloaded",
        "retry_after_s": 0.8?}
"""

from __future__ import annotations

import collections
import dataclasses
import json
import queue
import socketserver
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

from repro_torch import resolve_device
from repro_torch.experiments.result import RunResult
from repro_torch.experiments.spec import ComponentSpec, ExperimentSpec
from repro_torch.serve.cache import CompileCache
from repro_torch.serve.chaos import ChaosMonkey, ChaosPlan
from repro_torch.serve.packer import LanePacker, lane_key
from repro_torch.serve.pool import (DeadlineExceeded, WorkerPool,
                                    _ser_backend, execute_requests)

__all__ = ["ExperimentServer", "Overloaded", "ShuttingDown",
           "TRACE_CHUNK_ROWS"]

#: rows per streamed trace chunk (a row = one evaluation point)
TRACE_CHUNK_ROWS = 256

_STOP = object()


class Overloaded(RuntimeError):
    """Admission queue full; retry after `retry_after_s` seconds."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ShuttingDown(RuntimeError):
    """The server is draining and refuses new work."""


@dataclasses.dataclass
class _Request:
    spec: ExperimentSpec
    backend: Any
    future: Future
    submitted: float
    solo_reason: str | None = None
    deadline: float | None = None  # absolute time.monotonic()
    idem_key: str | None = None
    settled: bool = False


class ExperimentServer:
    """Persistent run server; usable in-process (`submit`) or over TCP
    (`start` + `repro_torch.serve.Client`).

    Args:
      host/port: TCP bind address (`port=0` picks a free port; read the
        real one from `start()`'s return or `.address`).
      workers: in-process executor width (each thread drives one run or
        lane; in pool mode these threads only deliver pool results).
      max_width / max_wait_s: lane-packer admission policy -- a lane
        flushes when `max_width` shape-compatible requests arrived or the
        oldest has waited `max_wait_s`.
      cache_entries: compile-cache capacity (warm simulators, LRU; in
        pool mode each worker process owns its own cache of this size).
      packing: disable to force every request solo (the cache still
        applies); the differential tests use both modes.
      processes: worker-process count. 0 (default) runs every job in
        this process; >= 1 ships jobs to a supervised `WorkerPool` of
        spawn processes (crash restart + re-enqueue, deadline kills,
        heartbeats), each with its own CUDA context.
      deadline_s: default per-request budget; expired requests are shed
        (failed with `DeadlineExceeded`, never run). Per-request
        `deadline_s` on submit overrides.
      max_queue: bounded admission -- more than this many unsettled
        requests and `submit` raises `Overloaded` (0 = unbounded).
      dedup_entries: completed idempotency keys remembered for replay.
      chaos: optional `ChaosPlan` (pool mode only) -- a seeded
        `ChaosMonkey` SIGKILLs workers per the plan, for the chaos tier.
      pool_kwargs: extra `WorkerPool` knobs (max_reenqueues,
        backoff_base_s, heartbeat_s, ...).
      device: where every run happens, in process and in the workers;
        None means the CUDA card, and raises when there is none. Pass
        "cpu" to serve on the CPU.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 workers: int = 2, max_width: int = 4,
                 max_wait_s: float = 0.05, cache_entries: int = 32,
                 packing: bool = True, processes: int = 0,
                 deadline_s: float | None = None, max_queue: int = 0,
                 dedup_entries: int = 128,
                 chaos: ChaosPlan | dict | None = None,
                 pool_kwargs: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.cache = CompileCache(max_entries=cache_entries)
        self.packer = LanePacker(max_width=max_width, max_wait_s=max_wait_s)
        self.packing = packing
        self.deadline_s = deadline_s
        self.max_queue = max_queue
        self._host, self._port = host, port
        self._queue: queue.Queue = queue.Queue()
        self._tpool = ThreadPoolExecutor(max_workers=max(1, workers),
                                         thread_name_prefix="repro-serve")
        if isinstance(chaos, dict):
            chaos = ChaosPlan.from_dict(chaos)
        self.chaos: ChaosMonkey | None = (None if chaos is None
                                          else ChaosMonkey(chaos))
        self.pool: WorkerPool | None = None
        if processes > 0:
            self.pool = WorkerPool(processes, cache_entries=cache_entries,
                                   chaos=self.chaos, device=self.device,
                                   **(pool_kwargs or {}))
        self._dispatcher: threading.Thread | None = None
        self._tcp: _TCPServer | None = None
        self._tcp_thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._closed = False
        self._started_at = time.monotonic()
        self.fatal: BaseException | None = None
        self.requests = 0
        self.errors = 0
        # robustness bookkeeping (all under self._lock)
        self._pending_n = 0
        self.shed = 0
        self.overloaded = 0
        self.dedup_hits = 0
        self._avg_run_s = 0.5  # EWMA of result walls, for retry-after hints
        self._inflight_keys: dict[str, _Request] = {}
        self._done_keys: collections.OrderedDict[str, Any] = \
            collections.OrderedDict()
        self._dedup_entries = dedup_entries
        self._executions: collections.Counter = collections.Counter()

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> tuple[str, int] | None:
        return None if self._tcp is None else self._tcp.server_address[:2]

    def start(self) -> tuple[str, int]:
        """Bind the TCP front door and return (host, port)."""
        self._ensure_dispatcher()
        if self._tcp is None:
            self._tcp = _TCPServer((self._host, self._port), _Handler, self)
            self._tcp_thread = threading.Thread(
                target=self._tcp.serve_forever, name="repro-serve-tcp",
                daemon=True)
            self._tcp_thread.start()
        return self.address  # type: ignore[return-value]

    def close(self) -> None:
        """Graceful drain: stop accepting, flush open lanes, finish
        in-flight runs (pool jobs included), then stop the workers."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._tcp is not None:
            self._tcp.shutdown()
            self._tcp.server_close()
        if self._dispatcher is not None:
            self._queue.put(_STOP)
            self._dispatcher.join()
        if self.pool is not None:
            self.pool.close(drain=True)
        self._tpool.shutdown(wait=True)

    def __enter__(self) -> "ExperimentServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _fatal_teardown(self, exc: BaseException) -> None:
        """A fatal signal (SystemExit/KeyboardInterrupt) escaped a run:
        record it and tear the server down from a fresh thread (close()
        joins the thread the signal may be unwinding)."""
        with self._lock:
            if self.fatal is None:
                self.fatal = exc
        threading.Thread(target=self.close, name="repro-serve-fatal-close",
                         daemon=True).start()

    # -- submission ----------------------------------------------------------

    def submit(self, spec: ExperimentSpec | dict, backend: Any = None,
               deadline_s: float | None = None,
               idempotency_key: str | None = None) -> "Future":
        """Enqueue one run; returns a Future resolving to its RunResult.

        `deadline_s` (defaults to the server-wide budget) sheds the
        request instead of running it once expired. `idempotency_key`
        makes retries safe: a key already in flight returns the
        original's Future, a completed key replays its result.
        """
        if isinstance(spec, dict):
            spec = ExperimentSpec.from_dict(spec)
        now = time.monotonic()
        with self._lock:
            if self._closed:
                raise ShuttingDown("server is shutting down")
            if idempotency_key is not None:
                if idempotency_key in self._done_keys:
                    self._done_keys.move_to_end(idempotency_key)
                    self.requests += 1
                    self.dedup_hits += 1
                    fut: Future = Future()
                    fut.set_result(self._done_keys[idempotency_key])
                    return fut
                live = self._inflight_keys.get(idempotency_key)
                if live is not None:
                    self.requests += 1
                    self.dedup_hits += 1
                    return live.future
            if self.max_queue and self._pending_n >= self.max_queue:
                self.overloaded += 1
                hint = self._retry_after_locked()
                raise Overloaded(
                    f"admission queue full ({self._pending_n} pending, "
                    f"max_queue={self.max_queue})", retry_after_s=hint)
            self.requests += 1
            self._pending_n += 1
            if deadline_s is None:
                deadline_s = self.deadline_s
            req = _Request(
                spec=spec, backend=backend, future=Future(), submitted=now,
                deadline=None if deadline_s is None else now + deadline_s,
                idem_key=idempotency_key)
            if idempotency_key is not None:
                self._inflight_keys[idempotency_key] = req
        self._ensure_dispatcher()
        self._queue.put(req)
        return req.future

    def _retry_after_locked(self) -> float:
        width = len(self.pool._slots) if self.pool is not None \
            else self._tpool._max_workers
        est = self._pending_n * self._avg_run_s / max(width, 1)
        return round(min(max(est, 0.05), 30.0), 3)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            robustness = {
                "requests_shed": self.shed,
                "requests_retried": self.dedup_hits,
                "overloaded": self.overloaded,
                "pending": self._pending_n,
                "worker_restarts": 0,
                "reenqueues": 0,
                "deadline_missed": 0,
            }
            dedup = {"inflight_keys": len(self._inflight_keys),
                     "done_keys": len(self._done_keys),
                     "max_executions_per_key":
                         max(self._executions.values(), default=0)}
        if self.pool is not None:
            ps = self.pool.stats()
            robustness["worker_restarts"] = ps["worker_restarts"]
            robustness["reenqueues"] = ps["reenqueues"]
            robustness["deadline_missed"] = ps["deadline_missed"]
        out = {
            "server": {"requests": self.requests, "errors": self.errors,
                       "uptime_s": time.monotonic() - self._started_at,
                       "packing": self.packing,
                       "processes": (0 if self.pool is None
                                     else len(self.pool._slots)),
                       "fatal": (None if self.fatal is None
                                 else repr(self.fatal))},
            "cache": self.cache.stats(),
            "packer": self.packer.stats(),
            "robustness": robustness,
            "dedup": dedup,
        }
        if self.pool is not None:
            out["pool"] = self.pool.stats()
        if self.chaos is not None:
            out["chaos"] = self.chaos.stats()
        return out

    def _ensure_dispatcher(self) -> None:
        with self._lock:
            if self._dispatcher is None:
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="repro-serve-dispatch",
                    daemon=True)
                self._dispatcher.start()

    # -- dispatch ------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            deadline = self.packer.next_deadline()
            timeout = (None if deadline is None
                       else max(deadline - time.monotonic(), 0.0))
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                req = None
            if req is _STOP:
                for lane in self.packer.flush():
                    self._launch_lane(lane)
                return
            if req is not None:
                try:
                    self._route(req)
                except Exception as e:  # noqa: BLE001 -- one bad
                    self._fail(req, e)  # request must not kill dispatch
                except BaseException as e:
                    # fatal signal: don't strand the waiter, then tear
                    # the server down instead of masking it as a failure
                    self._fail(req, e)
                    self._fatal_teardown(e)
                    raise
            for lane in self.packer.pop_ready():
                self._launch_lane(lane)

    def _route(self, req: _Request) -> None:
        if req.deadline is not None and time.monotonic() > req.deadline:
            self._shed(req)
            return
        if not self.packing:
            req.solo_reason = "packing disabled on this server"
            self._execute([req])
            return
        key, reason = lane_key(req.spec, req.backend, device=self.device)
        if key is None:
            req.solo_reason = reason
            self._execute([req])
        else:
            self.packer.admit(key, req)

    def _launch_lane(self, lane) -> None:
        reqs = lane.items
        if len(reqs) == 1:
            req = reqs[0]
            req.solo_reason = (req.solo_reason or
                               "lane flushed at width 1 (no shape-"
                               "compatible peer arrived within max_wait_s)")
        self._execute(reqs)

    # -- execution -----------------------------------------------------------

    def _shed(self, req: _Request) -> None:
        with self._lock:
            self.shed += 1
        self._fail(req, DeadlineExceeded(
            "deadline expired before dispatch; request shed", shed=True))

    def _execute(self, reqs: list) -> None:
        """Shed expired members, record idempotent executions, and hand
        the job to the in-process executor or the worker pool."""
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._shed(r)
            else:
                live.append(r)
        if not live:
            return
        with self._lock:
            for r in live:
                if r.idem_key is not None:
                    self._executions[r.idem_key] += 1
        if self.pool is None:
            self._tpool.submit(self._run_inproc, live)
        else:
            self._dispatch_pool(live)

    def _run_inproc(self, reqs: list) -> None:
        waits = [time.monotonic() - r.submitted for r in reqs]
        try:
            results, meta = execute_requests(
                [r.spec for r in reqs], [r.backend for r in reqs], self.cache,
                device=self.device)
        except Exception as e:  # noqa: BLE001 -- delivered to the client
            for r in reqs:
                self._fail(r, e)
            return
        except BaseException as e:
            for r in reqs:
                self._fail(r, e)
            self._fatal_teardown(e)
            raise
        hit = meta.get("cache_hit") if len(reqs) > 1 else None
        for req, result, wait in zip(reqs, results, waits):
            self._finish(req, result, width=len(reqs), queue_wait=wait,
                         cache_hit=hit)

    def _dispatch_pool(self, reqs: list) -> None:
        deadlines = [r.deadline for r in reqs]
        job_deadline = (None if any(d is None for d in deadlines)
                        else max(deadlines))
        try:
            fut = self.pool.submit(
                [r.spec.to_json(indent=None) for r in reqs],
                [_ser_backend(r.backend) for r in reqs],
                deadline=job_deadline)
        except Exception as e:  # noqa: BLE001 -- pool closed under us
            for r in reqs:
                self._fail(r, e)
            return
        fut.add_done_callback(
            lambda f: self._deliver_pool(reqs, f))

    def _deliver_pool(self, reqs: list, fut: Future) -> None:
        """Runs on the pool supervisor thread; the payload decode is
        cheap relative to a run, so deliver inline."""
        try:
            payload, meta = fut.result()
        except Exception as e:  # noqa: BLE001 -- job-level failure
            for r in reqs:
                self._fail(r, e)
            return
        try:
            results = [RunResult.from_json(s) for s in payload]
        except Exception as e:  # noqa: BLE001 -- torn/invalid payload
            for r in reqs:
                self._fail(r, e)
            return
        dispatched = meta.get("dispatched_at")
        reen = int(meta.get("reenqueues", 0))
        hit = meta.get("cache_hit") if len(reqs) > 1 else None
        for req, result in zip(reqs, results):
            wait = ((dispatched - req.submitted) if dispatched is not None
                    else 0.0)
            self._finish(req, result, width=len(reqs), queue_wait=wait,
                         cache_hit=hit, reenqueues=reen)

    def _finish(self, req: _Request, result, width: int, queue_wait: float,
                cache_hit: bool | None = None, reenqueues: int = 0) -> None:
        """Attach the serve-side observability to the result's metrics.

        Everything added here is bookkeeping the differential gates
        exclude (`comparable_result_dict` strips metrics), so annotation
        can never perturb the scientific payload."""
        m = result.metrics
        if m is not None:
            counters = dict(m.counters)
            counters["queue_wait_s"] = queue_wait
            counters["lane_width"] = float(width)
            counters["lane_occupancy"] = width / self.packer.max_width
            if cache_hit is not None:
                counters["cache_hit" if cache_hit else "cache_miss"] = \
                    counters.get(
                        "cache_hit" if cache_hit else "cache_miss", 0) + 1
            notes = dict(m.notes)
            if req.solo_reason:
                notes["solo_reason"] = req.solo_reason
            if reenqueues:
                counters["reenqueues"] = float(reenqueues)
                notes["reenqueues"] = (f"job survived {reenqueues} worker "
                                       "crash(es) via re-enqueue")
            result.metrics = dataclasses.replace(m, counters=counters,
                                                 notes=notes)
        self._settle(req, result=result)
        if not req.future.done():
            req.future.set_result(result)

    def _fail(self, req: _Request, exc: BaseException) -> None:
        with self._lock:
            self.errors += 1
        self._settle(req)
        if not req.future.done():
            req.future.set_exception(exc)

    def _settle(self, req: _Request, result=None) -> None:
        """Once per request: release its admission slot and resolve its
        idempotency key (successful results become replayable)."""
        with self._lock:
            if req.settled:
                return
            req.settled = True
            self._pending_n -= 1
            if result is not None and result.wall_s is not None:
                self._avg_run_s = (0.8 * self._avg_run_s
                                   + 0.2 * float(result.wall_s))
            if req.idem_key is not None:
                self._inflight_keys.pop(req.idem_key, None)
                if result is not None:
                    self._done_keys[req.idem_key] = result
                    while len(self._done_keys) > self._dedup_entries:
                        self._done_keys.popitem(last=False)


# ---------------------------------------------------------------------------
# TCP front door
# ---------------------------------------------------------------------------


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler, owner: ExperimentServer):
        self.owner = owner
        super().__init__(addr, handler)


class _Handler(socketserver.StreamRequestHandler):
    """One connection; any number of newline-delimited JSON ops."""

    def _send(self, obj: dict) -> None:
        line = json.dumps(obj, allow_nan=False) + "\n"
        self.wfile.write(line.encode("utf-8"))
        self.wfile.flush()

    def handle(self) -> None:
        server: ExperimentServer = self.server.owner  # type: ignore[attr-defined]
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                msg = json.loads(raw)
                op = msg.get("op", "run")
                if op == "ping":
                    self._send({"event": "pong", "ok": True})
                elif op == "stats":
                    self._send({"event": "stats", **server.stats()})
                elif op == "shutdown":
                    self._send({"event": "bye"})
                    # shut down from a fresh thread: shutdown() joins the
                    # serve_forever loop, and this handler must first
                    # return its socket to it
                    threading.Thread(target=server.close,
                                     daemon=True).start()
                    return
                elif op == "run":
                    self._handle_run(server, msg)
                else:
                    self._send({"event": "error", "type": "ValueError",
                                "error": f"unknown op {op!r}"})
            except BrokenPipeError:
                return
            except Exception as e:  # noqa: BLE001 -- protocol surface
                payload = {"event": "error", "type": type(e).__name__,
                           "error": str(e)}
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    payload["retry_after_s"] = retry_after
                try:
                    self._send(payload)
                except OSError:
                    return

    def _handle_run(self, server: ExperimentServer, msg: dict) -> None:
        spec = ExperimentSpec.from_dict(msg["spec"])
        backend = msg.get("backend")
        if isinstance(backend, dict):
            backend = ComponentSpec.from_dict(backend)
        future = server.submit(spec, backend=backend,
                               deadline_s=msg.get("deadline_s"),
                               idempotency_key=msg.get("idempotency_key"))
        self._send({"event": "accepted", "name": spec.name})
        result = future.result()
        d = result.to_dict()
        trace = d.pop("trace")
        total = len(trace["iters"])
        for lo in range(0, total, TRACE_CHUNK_ROWS):
            hi = min(lo + TRACE_CHUNK_ROWS, total)
            self._send({"event": "trace", "lo": lo, "hi": hi,
                        "total": total,
                        "columns": {f: col[lo:hi]
                                    for f, col in trace.items()}})
        self._send({"event": "result", "result": d})
