"""`RunMetrics` -- the frozen metrics block every `repro.run()` returns.

One schema across all three backends, so downstream tooling (the `trace`
CLI, the bench regression files, the future serving layer) reads one
shape regardless of which engine produced it:

  * `compile_s` / `execute_s` -- the host wall split of the run.  For the
    dense backend these are the jit lower+compile time vs the blocked
    execution time of the scanned program (their sum is `RunResult.wall_s`,
    preserving JSON back-compat).  The netsim engines have no compile
    phase (`compile_s == 0.0`); launch-dryrun reports its AOT compile
    walls.
  * message/byte counters -- `msgs` is messages sent (netsim: actual
    sends including drops; dense/launch: the closed-form n*k per gossip
    round), `bytes_on_wire` assumes the backend's payload width.
  * `retunes` / `retune_history` / `r_hat` / `r_hat_trajectory` -- the
    adaptive controller's observable record: what r-hat it measured when,
    and which h it spliced in where.
  * `step_time_quantiles` -- per-node step-time distribution
    (p50/p90/p99/max); the `unit` key says which clock the samples rode
    ("sim" for netsim, "host" for dense per-iteration walls and launch
    per-step walls).
  * `faults` -- fault-injection record for netsim runs with a FaultPlan
    attached (crashes/restarts/joins/leaves, summed sim-time downtime,
    partition epochs, link flaps, checkpoints taken, sends refused at
    partitioned links, and link-layer retransmits); `None` on fault-free
    runs, `{"retransmits": k}` when only bounded retry was configured.
  * `compression` -- compressed-gossip record for runs with
    `ExperimentSpec.compression` attached: the compressor `kind`, its
    bytes-on-wire `wire_ratio` c, `bytes_saved` vs uncompressed payloads,
    and the `residual_norms` trajectory (mean per-node error-feedback
    residual norm at each trace point); `None` on uncompressed runs.
  * `phases` / `counters` -- the tracer's aggregates, verbatim.
  * `notes` -- free-form string diagnostics (vmap-fallback reasons, the
    serving packer's solo reasons); empty on clean runs.

Serialization is strict-RFC via the same `json_sanitize` path as
`RunResult` (inf/nan -> null, numpy scalars -> Python), and
`from_dict(to_dict(m)) == m` exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["METRICS_VERSION", "RunMetrics", "sample_quantiles"]

METRICS_VERSION = 1


def _freeze_pairs(pairs: Any) -> tuple:
    """Normalize a list/tuple of 2-sequences into a tuple of float pairs,
    so JSON round-trips (lists of lists) compare equal to the original."""
    return tuple((float(a), float(b)) for a, b in pairs)


def _freeze_retunes(history: Any) -> tuple:
    """Normalize retune records into (from_t, h, h_opt_raw, r_hat, lam2)
    float/int tuples; accepts Retune dataclasses, dicts, or sequences."""
    out = []
    for r in history:
        if dataclasses.is_dataclass(r) and not isinstance(r, type):
            r = dataclasses.asdict(r)
        if isinstance(r, dict):
            rec = (r["from_t"], r["h"], r["h_opt_raw"], r["r_hat"], r["lam2"])
        else:
            rec = tuple(r)
        from_t, h, h_opt_raw, r_hat, lam2 = rec
        out.append((float(from_t), int(h), float(h_opt_raw), float(r_hat),
                    float(lam2)))
    return tuple(out)


def sample_quantiles(samples: Any, unit: str) -> dict[str, float] | None:
    """p50/p90/p99/max/n summary of a timing sample array, or None when
    there are no samples. `unit` says which clock the samples rode
    ("sim" or "host")."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        return None
    return {
        "p50": float(np.percentile(arr, 50)),
        "p90": float(np.percentile(arr, 90)),
        "p99": float(np.percentile(arr, 99)),
        "max": float(np.max(arr)),
        "n": int(arr.size),
        "unit": str(unit),
    }


@dataclasses.dataclass(frozen=True)
class RunMetrics:
    """Frozen per-run metrics block; see module docstring for field
    semantics. All fields are optional-with-defaults so backends populate
    what they can observe and leave the rest at identity."""

    compile_s: float = 0.0
    execute_s: float = 0.0
    eval_s: float | None = None
    msgs: int = 0
    bytes_on_wire: float = 0.0
    drops: int = 0
    gossip_rounds: int = 0
    retunes: int = 0
    retune_history: tuple = ()
    r_hat: float | None = None
    r_hat_trajectory: tuple = ()
    step_time_quantiles: dict | None = None
    faults: dict | None = None
    compression: dict | None = None
    phases: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    #: free-form string diagnostics (e.g. "vmap_fallback": why a sweep
    #: degraded to serial, "solo_reason": why the serving packer ran a
    #: spec unbatched). Absent keys mean "nothing to report"; old
    #: serialized blocks load with the empty default.
    notes: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # normalize sequence fields so JSON round-trips compare equal
        object.__setattr__(self, "retune_history",
                           _freeze_retunes(self.retune_history))
        object.__setattr__(self, "r_hat_trajectory",
                           _freeze_pairs(self.r_hat_trajectory))

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        from repro_torch.core.dda import json_sanitize

        d = dataclasses.asdict(self)
        d["metrics_version"] = METRICS_VERSION
        return json_sanitize(d)

    @classmethod
    def from_dict(cls, d: dict) -> "RunMetrics":
        d = dict(d)
        version = d.pop("metrics_version", None)
        if version != METRICS_VERSION:
            raise ValueError(
                f"unsupported metrics_version {version!r} "
                f"(this reader supports {METRICS_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RunMetrics fields: {sorted(unknown)}")
        return cls(**d)

    # -- construction helpers ------------------------------------------------

    @classmethod
    def from_tracer(cls, tracer, **fields: Any) -> "RunMetrics":
        """Build a metrics block with `phases`/`counters` taken from a
        Tracer's aggregates and everything else from explicit fields."""
        if tracer is not None:
            fields.setdefault("phases", tracer.phase_totals())
            fields.setdefault("counters", dict(tracer.counters))
            if "r_hat_trajectory" not in fields and "r_hat" in tracer.series:
                fields["r_hat_trajectory"] = tracer.series["r_hat"]
        return cls(**fields)
