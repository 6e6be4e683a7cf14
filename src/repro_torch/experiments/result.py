"""Canonical run result: one type for all three backends.

`RunResult` unifies what the three front doors used to return separately:
the evaluation trace (`core.dda.SimTrace`, whatever its time axis means on
that backend), host wall-clock, the empirical tradeoff measurement
(`netsim.RMeasurement`, when the backend observes messages), and the
paper's closed-loop predictions (`h_opt` / `n_opt` / `tau_eps` from
`core.tradeoff`). `to_json` emits strict-RFC JSON (via
`core.dda.json_sanitize`: inf/nan -> null, so a diverged run is still a
readable artifact); `from_json` reconstructs the dataclasses. The one lossy
edge: numeric fields that were inf/nan come back as None -- exactly the
convention the convergence tier's artifacts already use.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.core.dda import SimTrace, TRACE_FIELDS, json_sanitize
from repro_torch.experiments.spec import ExperimentSpec, ComponentSpec
from repro_torch.netsim.simulator import RMeasurement
from repro_torch.obs.metrics import RunMetrics

__all__ = ["RunResult"]

RESULT_VERSION = 1


@dataclasses.dataclass
class RunResult:
    """Outcome of one `repro.experiments.run` call.

    Fields:
      spec:           the spec as run.
      backend:        the resolved backend component (spec.backends entry,
                      params included -- engine, scenario, mesh...).
      trace:          SimTrace; sim_time is simulated time (dense), the
                      event clock (netsim) or eq.-9 time units (launch).
      wall_s:         host wall-clock of the backend run.
      eps_value:      resolved accuracy target (None without eps_frac).
      time_to_target: first trace time at or below eps_value; None when no
                      target was set or it was never reached.
      r_measurement:  empirical r recovered from the run's own timeline
                      (netsim backends; None elsewhere).
      predictions:    paper design-rule outputs (n_opt, h_opt, tau_eps)
                      from the empirical r when measured, else from the
                      configured spec.r.
      extras:         backend-specific observability (engine name, drop
                      counts, controller retune path, launch losses...).
      metrics:        `repro.obs.RunMetrics` -- the structured metrics
                      block (compile/execute wall split, message/byte
                      counters, retune history, step-time quantiles,
                      r-hat trajectory). Populated by every `repro.run()`
                      on every backend; optional in the JSON schema so
                      pre-metrics result files still load.
    """

    spec: ExperimentSpec
    backend: ComponentSpec
    trace: SimTrace
    wall_s: float
    eps_value: float | None = None
    time_to_target: float | None = None
    r_measurement: RMeasurement | None = None
    predictions: dict[str, Any] | None = None
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: RunMetrics | None = None

    @property
    def final_f(self) -> float:
        return self.trace.fvals[-1]

    def to_dict(self) -> dict:
        pred = None
        if self.predictions is not None:
            pred = {k: (dataclasses.asdict(v)
                        if dataclasses.is_dataclass(v) else v)
                    for k, v in self.predictions.items()}
        d = {
            "result_version": RESULT_VERSION,
            "spec": self.spec.to_dict(),
            "backend": self.backend.to_dict(),
            "trace": {f: list(getattr(self.trace, f))
                      for f in TRACE_FIELDS},
            "wall_s": self.wall_s,
            "eps_value": self.eps_value,
            "time_to_target": self.time_to_target,
            "r_measurement": (None if self.r_measurement is None
                              else dataclasses.asdict(self.r_measurement)),
            "predictions": pred,
            "extras": self.extras,
            "metrics": (None if self.metrics is None
                        else self.metrics.to_dict()),
        }
        return json_sanitize(d)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_dict(cls, d: dict) -> "RunResult":
        version = d.get("result_version", RESULT_VERSION)
        if version != RESULT_VERSION:
            raise ValueError(f"unsupported result_version {version!r}")
        meas = d.get("r_measurement")
        metrics = d.get("metrics")
        return cls(
            spec=ExperimentSpec.from_dict(d["spec"]),
            backend=ComponentSpec.from_dict(d["backend"]),
            trace=SimTrace(**{f: list(d["trace"].get(f, []))
                              for f in TRACE_FIELDS}),
            wall_s=d["wall_s"],
            eps_value=d.get("eps_value"),
            time_to_target=d.get("time_to_target"),
            r_measurement=None if meas is None else RMeasurement(**meas),
            predictions=d.get("predictions"),
            extras=dict(d.get("extras") or {}),
            metrics=None if metrics is None else RunMetrics.from_dict(metrics),
        )

    @classmethod
    def from_json(cls, text: str) -> "RunResult":
        return cls.from_dict(json.loads(text))
