"""TCP client for `ExperimentServer`'s JSON-lines protocol, on the port:
a copy of `repro.serve.client` over the port's `RunResult`.

    from repro_torch.serve import Client

    with Client(host, port, retries=3) as c:
        result = c.run(spec)            # -> RunResult (trace reassembled
        print(c.stats()["cache"])       #    exactly from streamed chunks)

The transport never touches the payload: `run()` reassembles the
streamed trace chunks into the full `RunResult` byte-for-byte -- the
differential serving tests compare a round-tripped served result against
a local `repro_torch.run()` with exact JSON equality.

Robustness (all opt-in; `retries=0` keeps the plain client, which
tries once): transport failures (connection reset, torn response line,
timeout) and `Overloaded` rejections are retried with jittered
exponential backoff, honoring the server's retry-after hint. A retried
`run` auto-generates an idempotency key (unless one is supplied), so the
server dedups the retry against the original -- a request never executes
twice even when the first response was lost mid-stream. Per-op `timeout`
overrides beat the connect-time default, and `shutdown()` tolerates the
server closing the connection before the "bye" lands.
"""

from __future__ import annotations

import contextlib
import json
import random
import socket
import time
import uuid
from typing import Any, Callable

from repro_torch.experiments.result import RunResult
from repro_torch.experiments.spec import ExperimentSpec

__all__ = ["Client", "DeadlineExceededError", "OverloadedError",
           "ServeError", "ShuttingDownError"]


class ServeError(RuntimeError):
    """Server-reported failure (`error` event), with the remote type."""

    def __init__(self, error: str, remote_type: str = "Exception"):
        super().__init__(f"{remote_type}: {error}")
        self.remote_type = remote_type


class OverloadedError(ServeError):
    """Admission queue full; `retry_after_s` is the server's hint."""

    def __init__(self, error: str, remote_type: str = "Overloaded",
                 retry_after_s: float | None = None):
        super().__init__(error, remote_type)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(ServeError):
    """The request's deadline passed server-side (shed or killed)."""


class ShuttingDownError(ServeError):
    """The server is draining and refused the request."""


_ERROR_TYPES: dict[str, type] = {
    "Overloaded": OverloadedError,
    "OverloadedError": OverloadedError,
    "DeadlineExceeded": DeadlineExceededError,
    "DeadlineExceededError": DeadlineExceededError,
    "ShuttingDown": ShuttingDownError,
    "ShuttingDownError": ShuttingDownError,
}


def _error_from_event(ev: dict) -> ServeError:
    remote = ev.get("type", "?")
    cls = _ERROR_TYPES.get(remote, ServeError)
    if cls is OverloadedError:
        return OverloadedError(ev.get("error", "?"), remote,
                               retry_after_s=ev.get("retry_after_s"))
    return cls(ev.get("error", "?"), remote)


#: transport-level failures a retrying run() treats as "response lost,
#: outcome unknown" -- safe to retry because the idempotency key dedups
_RETRYABLE = (ConnectionError, socket.timeout, OSError,
              json.JSONDecodeError)


class Client:
    """One socket, blocking calls; retries opt-in via `retries`.

    Args:
      timeout: connect-time socket timeout, the default for every op.
      retries: how many times `run()` re-submits after a transport
        failure or an `Overloaded` rejection (0 = never: one try).
      backoff_s / backoff_cap_s / jitter: retry delay is
        `min(cap, backoff_s * 2**attempt) * (1 + jitter * U[0,1))`,
        floored at the server's retry-after hint when one was given.
      seed: seeds the jitter RNG (deterministic chaos replays).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float | None = 600.0, retries: int = 0,
                 backoff_s: float = 0.1, backoff_cap_s: float = 2.0,
                 jitter: float = 0.5, seed: int | None = None):
        self._host, self._port, self._timeout = host, port, timeout
        self.retries = retries
        self.backoff_s, self.backoff_cap_s = backoff_s, backoff_cap_s
        self.jitter = jitter
        self._rng = random.Random(seed)
        self.retries_used = 0
        self._sock: socket.socket | None = None
        self._rfile = None
        self._connect()

    # -- plumbing ------------------------------------------------------------

    def _connect(self) -> None:
        self._close_sock()
        self._sock = socket.create_connection((self._host, self._port),
                                              timeout=self._timeout)
        self._rfile = self._sock.makefile("rb")

    def _close_sock(self) -> None:
        if self._rfile is not None:
            with contextlib.suppress(OSError):
                self._rfile.close()
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
        self._rfile = self._sock = None

    @contextlib.contextmanager
    def _op_timeout(self, timeout: float | None):
        """Per-op socket timeout override; None keeps the default."""
        if timeout is None or self._sock is None:
            yield
            return
        old = self._sock.gettimeout()
        self._sock.settimeout(timeout)
        try:
            yield
        finally:
            if self._sock is not None:
                with contextlib.suppress(OSError):
                    self._sock.settimeout(old)

    def _send(self, obj: dict) -> None:
        self._sock.sendall((json.dumps(obj, allow_nan=False) + "\n")
                           .encode("utf-8"))

    def _recv(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        if not line.endswith(b"\n"):
            # a cut mid-line (torn response) surfaces as a partial read;
            # fail as a transport error so the retry path owns it
            raise ConnectionError("connection cut mid-response (torn line)")
        return json.loads(line)

    def close(self) -> None:
        self._close_sock()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- ops -----------------------------------------------------------------

    def ping(self, timeout: float | None = None) -> bool:
        with self._op_timeout(timeout):
            self._send({"op": "ping"})
            ev = self._recv()
        return ev.get("event") == "pong"

    def stats(self, timeout: float | None = None) -> dict[str, Any]:
        with self._op_timeout(timeout):
            self._send({"op": "stats"})
            ev = self._recv()
        if ev.get("event") == "error":
            raise _error_from_event(ev)
        ev.pop("event", None)
        return ev

    def shutdown(self, timeout: float | None = None) -> None:
        """Ask the server to drain and exit. A server that closes the
        connection before (or instead of) the "bye" reply is a clean
        shutdown, not an error."""
        with self._op_timeout(timeout):
            try:
                self._send({"op": "shutdown"})
                self._recv()  # "bye"
            except (ConnectionError, socket.timeout, OSError):
                pass

    def run(self, spec: ExperimentSpec | dict, backend: Any = None,
            on_event: Callable[[dict], None] | None = None,
            timeout: float | None = None, deadline_s: float | None = None,
            idempotency_key: str | None = None,
            retries: int | None = None) -> RunResult:
        """Submit one spec and block for its RunResult.

        `on_event` (optional) sees every raw protocol event as it
        arrives -- accepted, each trace chunk, the final result -- for
        progress display. `timeout` overrides the socket timeout for
        this op; `deadline_s`/`idempotency_key` propagate server-side.
        `retries` overrides the client default for this call; when
        retrying without an explicit key, one is auto-generated so the
        server can dedup the retry against the original submission.
        """
        if retries is None:
            retries = self.retries
        key = idempotency_key
        if retries > 0 and key is None:
            key = uuid.uuid4().hex
        spec_dict = (spec.to_dict() if isinstance(spec, ExperimentSpec)
                     else dict(spec))
        last: Exception | None = None
        for attempt in range(retries + 1):
            if attempt > 0:
                self.retries_used += 1
                time.sleep(self._delay(attempt - 1, last))
                try:
                    self._connect()
                except OSError as e:
                    last = e
                    continue
            try:
                with self._op_timeout(timeout):
                    return self._run_once(spec_dict, backend, on_event,
                                          deadline_s, key)
            except OverloadedError as e:
                last = e
            except _RETRYABLE as e:
                last = e
            if attempt == retries:
                raise last
        raise last  # all attempts spent reconnecting

    def _delay(self, attempt: int, last: Exception | None) -> float:
        base = min(self.backoff_cap_s, self.backoff_s * 2 ** attempt)
        delay = base * (1.0 + self.jitter * self._rng.random())
        hint = getattr(last, "retry_after_s", None)
        if hint is not None:
            delay = max(delay, float(hint))
        return delay

    def _run_once(self, spec_dict: dict, backend: Any,
                  on_event: Callable[[dict], None] | None,
                  deadline_s: float | None, key: str | None) -> RunResult:
        msg: dict[str, Any] = {"op": "run", "spec": spec_dict}
        if backend is not None:
            msg["backend"] = (backend.to_dict()
                              if hasattr(backend, "to_dict") else backend)
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        if key is not None:
            msg["idempotency_key"] = key
        self._send(msg)
        columns: dict[str, list] = {}
        while True:
            ev = self._recv()
            if on_event is not None:
                on_event(ev)
            kind = ev.get("event")
            if kind == "accepted":
                continue
            if kind == "trace":
                for f, col in ev["columns"].items():
                    columns.setdefault(f, []).extend(col)
                continue
            if kind == "result":
                d = ev["result"]
                d["trace"] = columns
                return RunResult.from_dict(d)
            if kind == "error":
                raise _error_from_event(ev)
            raise ServeError(f"unexpected event {kind!r}", "ProtocolError")
