"""Deterministic chaos for the real-process serving stack, on the port:
a copy of `repro.serve.chaos` (numpy and sockets only).

`repro_torch.faults` injects crashes and partitions into *simulated*
time; nothing there ever kills a real process. This module extends the
same philosophy -- seeded, replayable, plan-driven -- to the serving
tier's actual failure domain:

  * `ChaosPlan` -- a frozen, JSON-round-trippable schedule of injected
    failures. Every stochastic choice is driven from the plan's own
    seeded RNG streams (`[seed, 0]` for kills, `[seed, 1]` for the wire
    proxy), so a chaos run replays exactly given the same traffic order.
  * `ChaosMonkey` -- pool-side injector: `WorkerPool` calls
    `on_dispatch(ordinal, proc)` after every job dispatch, and the plan
    decides whether that worker gets SIGKILLed (optionally after a
    drawn delay, i.e. mid-lane).
  * `ChaosProxy` -- an in-process TCP proxy between client and server
    that tears response lines mid-byte, drops connections, and delays
    lines -- the wire-level failures a retrying `Client` must absorb.

The chaos gate (tests/test_torch_serve_pool.py, and `chip_smoke.py`'s
`serve` phase on the card) runs real traffic through these injectors
and asserts every request still completes bit-identical to a solo
`repro_torch.run()` with no double execution: faults must not change
the answer.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import threading
import time
from typing import Any

import numpy as np

__all__ = ["ChaosMonkey", "ChaosPlan", "ChaosProxy"]


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Seeded, replayable schedule of serving-layer failures.

    Ordinals are 1-based and deterministic given traffic order: job
    dispatch ordinals for kills (the pool counts every dispatch), global
    response-line ordinals for wire faults (the proxy counts every
    server->client line it forwards).
    """

    seed: int = 0
    #: dispatch ordinals whose worker gets SIGKILLed
    kill_at_dispatch: tuple = ()
    #: uniform [lo, hi) seconds between dispatch and the SIGKILL --
    #: a positive window lands the kill mid-run (mid-lane)
    kill_delay_s: tuple = (0.0, 0.0)
    #: response-line ordinals forwarded only halfway, then cut
    tear_response_at: tuple = ()
    #: response-line ordinals where the connection drops before the line
    drop_connection_at: tuple = ()
    #: per-line Bernoulli delay probability (proxy RNG stream)
    delay_line_prob: float = 0.0
    #: uniform [lo, hi) seconds for a drawn delay
    delay_s: tuple = (0.0, 0.02)

    def __post_init__(self):
        object.__setattr__(self, "kill_at_dispatch",
                           tuple(int(k) for k in self.kill_at_dispatch))
        object.__setattr__(self, "tear_response_at",
                           tuple(int(k) for k in self.tear_response_at))
        object.__setattr__(self, "drop_connection_at",
                           tuple(int(k) for k in self.drop_connection_at))
        object.__setattr__(self, "kill_delay_s",
                           tuple(float(x) for x in self.kill_delay_s))
        object.__setattr__(self, "delay_s",
                           tuple(float(x) for x in self.delay_s))
        for name in ("kill_delay_s", "delay_s"):
            lo, hi = getattr(self, name)
            if lo < 0 or hi < lo:
                raise ValueError(f"{name} must be 0 <= lo <= hi, "
                                 f"got ({lo}, {hi})")
        if not 0.0 <= self.delay_line_prob <= 1.0:
            raise ValueError("delay_line_prob must be in [0, 1]")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, tuple):
                d[k] = list(v)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ChaosPlan fields: {sorted(unknown)}")
        return cls(**d)


class ChaosMonkey:
    """Pool-side kill injector; RNG stream `[seed, 0]`.

    `on_dispatch` is called by the supervisor thread after every job
    dispatch; a scheduled kill fires from a daemon timer so a drawn
    delay lands the SIGKILL mid-run without blocking dispatch."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._rng = np.random.default_rng([plan.seed, 0])
        self._lock = threading.Lock()
        self.kills_scheduled = 0
        self.kills_delivered = 0

    def on_dispatch(self, ordinal: int, proc) -> None:
        if ordinal not in self.plan.kill_at_dispatch:
            return
        with self._lock:
            lo, hi = self.plan.kill_delay_s
            delay = float(self._rng.uniform(lo, hi)) if hi > lo else lo
            self.kills_scheduled += 1
        pid = proc.pid
        if delay <= 0:
            self._kill(pid)
        else:
            t = threading.Timer(delay, self._kill, args=(pid,))
            t.daemon = True
            t.start()

    def _kill(self, pid: int) -> None:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            return
        with self._lock:
            self.kills_delivered += 1

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"kills_scheduled": self.kills_scheduled,
                    "kills_delivered": self.kills_delivered}


class ChaosProxy:
    """In-process TCP proxy injecting wire faults between client and
    server; RNG stream `[seed, 1]`.

    Client->server bytes pass through untouched (requests must arrive
    intact or the retry story conflates with request loss); the
    server->client direction is read line-by-line so faults land on
    protocol-event boundaries: `tear_response_at` forwards half the
    line's bytes then cuts the connection, `drop_connection_at` cuts
    before the line, `delay_line_prob` sleeps a drawn delay first.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: ChaosPlan | None = None):
        self.plan = plan or ChaosPlan()
        self._up = (upstream_host, upstream_port)
        self._rng = np.random.default_rng([self.plan.seed, 1])
        self._lock = threading.Lock()
        self._line = 0
        self._closing = False
        self._conns: set = set()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(16)
        self._accept_thread: threading.Thread | None = None
        self.connections = 0
        self.torn_responses = 0
        self.dropped_connections = 0
        self.delayed_lines = 0

    @property
    def address(self) -> tuple[str, int]:
        return self._srv.getsockname()[:2]

    def start(self) -> tuple[str, int]:
        if self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="repro-chaos-proxy",
                daemon=True)
            self._accept_thread.start()
        return self.address

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self) -> "ChaosProxy":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"connections": self.connections,
                    "torn_responses": self.torn_responses,
                    "dropped_connections": self.dropped_connections,
                    "delayed_lines": self.delayed_lines,
                    "lines_forwarded": self._line}

    # -- internals -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                client, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self.connections += 1
            threading.Thread(target=self._handle, args=(client,),
                             daemon=True).start()

    def _track(self, *socks) -> None:
        with self._lock:
            self._conns.update(socks)

    def _untrack(self, *socks) -> None:
        with self._lock:
            self._conns.difference_update(socks)

    def _handle(self, client: socket.socket) -> None:
        try:
            upstream = socket.create_connection(self._up, timeout=30)
        except OSError:
            client.close()
            return
        self._track(client, upstream)
        done = threading.Event()
        t = threading.Thread(target=self._pump_up, name="repro-chaos-c2s",
                             args=(client, upstream, done), daemon=True)
        t.start()
        try:
            self._pump_down(upstream, client)
        finally:
            done.set()
            for s in (client, upstream):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
            self._untrack(client, upstream)

    def _pump_up(self, client: socket.socket, upstream: socket.socket,
                 done: threading.Event) -> None:
        """client -> server: verbatim bytes."""
        try:
            while not done.is_set():
                data = client.recv(65536)
                if not data:
                    break
                upstream.sendall(data)
        except OSError:
            pass
        try:
            upstream.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def _pump_down(self, upstream: socket.socket,
                   client: socket.socket) -> None:
        """server -> client: line-framed, with plan-driven faults."""
        rfile = upstream.makefile("rb")
        try:
            while True:
                line = rfile.readline()
                if not line:
                    return
                with self._lock:
                    self._line += 1
                    n = self._line
                    tear = n in self.plan.tear_response_at
                    drop = n in self.plan.drop_connection_at
                    delay = 0.0
                    if self.plan.delay_line_prob > 0:
                        if self._rng.random() < self.plan.delay_line_prob:
                            lo, hi = self.plan.delay_s
                            delay = float(self._rng.uniform(lo, hi))
                            self.delayed_lines += 1
                    if tear:
                        self.torn_responses += 1
                    if drop:
                        self.dropped_connections += 1
                if drop:
                    return
                if delay > 0:
                    time.sleep(delay)
                if tear:
                    client.sendall(line[:max(1, len(line) // 2)])
                    return
                client.sendall(line)
        except OSError:
            return
        finally:
            try:
                rfile.close()
            except OSError:
                pass
