"""`repro.obs` -- backend-agnostic observability: tracing, metrics, export.

The paper's central quantity r is a *measured* ratio of communication time
to computation time, so the stack that measures it needs a place to put its
measurements. This package is that place, three layers deep:

  * `Tracer` (obs.tracer) -- span/counter/series collector all three
    execution backends emit into. Phase spans (build/compile/execute/eval)
    ride the host clock; per-event detail spans (node steps, message
    flights, retunes) ride the backend's own sim clock and are emitted by
    the netsim engines only when `detail` tracing is requested -- the same
    "no hot-path branches unless attached" pattern the AdaptiveController
    hooks use, so tracing cannot perturb the engines' bit-identity
    guarantees.

  * `RunMetrics` (obs.metrics) -- the frozen, JSON-exact metrics block
    every `repro.run()` attaches to its `RunResult`: compile/execute wall
    split, message/byte/drop counters, retune history, per-node step-time
    quantiles and the observed r-hat trajectory. Serialized through the
    same strict-RFC path as the rest of the result (`json_sanitize`).

  * export + tooling (obs.export, obs.summary) -- Chrome-trace/Perfetto
    JSON and JSONL writers for the tracer's event stream, the shared
    strict-JSON artifact writer (one code path for CI smoke artifacts and
    the convergence tier's failure dumps), and the text renderer behind
    `python -m repro.experiments trace <result.json>`.

`obs.profiler.profile_ctx` is the opt-in `torch.profiler` hook
(`ExperimentSpec.profile_dir`) the dense backend wraps around its
iteration loop.
"""

from repro_torch.obs.export import (chrome_trace_events, write_chrome_trace,
                              write_json_artifact, write_jsonl)
from repro_torch.obs.metrics import (METRICS_VERSION, RunMetrics,
                               sample_quantiles)
from repro_torch.obs.profiler import profile_ctx
from repro_torch.obs.summary import render_summary
from repro_torch.obs.tracer import TraceEvent, Tracer

__all__ = [
    "METRICS_VERSION",
    "RunMetrics",
    "TraceEvent",
    "Tracer",
    "chrome_trace_events",
    "profile_ctx",
    "render_summary",
    "sample_quantiles",
    "write_chrome_trace",
    "write_json_artifact",
    "write_jsonl",
]
