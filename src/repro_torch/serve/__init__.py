"""`repro_torch.serve` -- persistent multi-tenant experiment serving on the
port, the counterpart of `repro.serve`.

The paper's object is amortizing a fixed cost (communication) against
useful work (computation); this package is the serving analog. On a CUDA
card what a cold dense run pays once per shape is the kernel library's
first load, the warm-up and the capture of its run program as CUDA
graphs; the server amortizes that across many incoming `ExperimentSpec`
requests:

  * `ExperimentServer` -- long-lived server, in-process threads or a
    supervised pool of worker processes, with a stdlib TCP JSON-lines
    front door (`python -m repro_torch.serve serve`);
  * `CompileCache` / `cache_signature` -- warm `DDASimulator`s (with
    their captured graphs) keyed by the run program's shape signature, so
    repeat traffic captures nothing and replays at once;
  * `LanePacker` / `lane_key` -- shape-compatible specs from different
    requests batched into one `run_batch` lane under a max-wait/max-width
    admission policy;
  * `Client` -- thin blocking client (`repro_torch.serve.Client(host,
    port)`);
  * `comparable_result_dict` -- the canonicalization the differential
    serving gates compare under: served results must equal a solo
    `repro_torch.run()` of the same spec exactly, outside wall-clock and
    serve bookkeeping.

Every run happens on the server's `device`: None means the CUDA card
(and raises without one), "cpu" runs on the CPU. Quickstart (in-process):

    from repro_torch.serve import ExperimentServer

    with ExperimentServer(workers=2) as srv:
        fut = srv.submit(spec)          # Future[RunResult]
        result = fut.result()
        print(result.metrics.counters)  # cache_hit, queue_wait_s, ...

Over TCP:

    host, port = srv.start()
    with Client(host, port) as c:
        result = c.run(spec)

The names are loaded lazily (PEP 562): a spawned toy worker imports
`repro_torch.serve.pool` alone, without torch.
"""

from __future__ import annotations

import importlib
from typing import Any

#: public name -> the module of this package that defines it
_EXPORTS = {
    "ChaosMonkey": "chaos",
    "ChaosPlan": "chaos",
    "ChaosProxy": "chaos",
    "Client": "client",
    "CompileCache": "cache",
    "DeadlineExceeded": "pool",
    "DeadlineExceededError": "client",
    "ExperimentServer": "server",
    "Lane": "packer",
    "LanePacker": "packer",
    "Overloaded": "server",
    "OverloadedError": "client",
    "PoolError": "pool",
    "ServeError": "client",
    "ShuttingDown": "server",
    "ShuttingDownError": "client",
    "TRACE_CHUNK_ROWS": "server",
    "WorkerCrashed": "pool",
    "WorkerPool": "pool",
    "cache_signature": "cache",
    "execute_requests": "pool",
    "lane_key": "packer",
}

__all__ = sorted([*_EXPORTS, "comparable_result_dict"])

#: extras keys that record HOW a result was executed, not WHAT it is --
#: batching and fallback bookkeeping legitimately differs between a solo
#: run and the same run served from a warm cache or packed lane
_EXECUTION_EXTRAS = ("vmap_lanes", "lane_width", "vmap_fallback",
                     "solo_reason")


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def comparable_result_dict(result: Any) -> dict:
    """Canonical dict for exact result comparison.

    Strips the fields that measure the execution rather than define the
    run: `wall_s`, the whole `metrics` block (wall splits, serve
    counters, the loop note), and the execution-bookkeeping extras.
    Everything else -- spec, backend, the full trace, eps/target fields,
    predictions, remaining extras -- must match EXACTLY (`==` on the JSON
    dicts) for a served result to count as equivalent to its solo run.
    Accepts a `RunResult` or an already-serialized result dict.
    """
    d = result if isinstance(result, dict) else result.to_dict()
    d = dict(d)
    d.pop("wall_s", None)
    d.pop("metrics", None)
    extras = dict(d.get("extras") or {})
    for k in _EXECUTION_EXTRAS:
        extras.pop(k, None)
    d["extras"] = extras
    return d
