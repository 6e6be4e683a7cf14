"""Declarative experiment specification with exact JSON round-trip.

An `ExperimentSpec` is pure data: every pluggable piece is a
`ComponentSpec` -- a registry kind plus JSON-able kwargs -- and the scalar
knobs (T, seed, r, ...) are plain fields. `to_json`/`from_json` round-trip
EXACTLY (`spec == ExperimentSpec.from_json(spec.to_json())`, property-tested
in tests/test_experiments.py), which is what lets checked-in manifests under
benchmarks/manifests/ serve as the paper figures' experiment definitions:
the file IS the experiment.

The spec deliberately contains no callables and no built objects --
`repro.experiments.run` builds everything fresh per run, so mutable
schedules (PiecewisePeriodic splice history) can never leak between runs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = ["ComponentSpec", "ExperimentSpec", "SPEC_VERSION"]

SPEC_VERSION = 1

_JSON_SCALARS = (str, int, float, bool, type(None))


def _normalize(value: Any, where: str) -> Any:
    """Coerce to exact-round-trip JSON values: tuples -> lists, numpy
    scalars -> Python scalars; reject anything json.dumps would mangle or
    refuse (sets, arrays, callables)."""
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return value
    if isinstance(value, int):
        return int(value)
    if isinstance(value, float):
        return float(value)
    if (hasattr(value, "item")
            and getattr(value, "shape", None) == ()):  # numpy scalar
        return _normalize(value.item(), where)
    if isinstance(value, (list, tuple)):
        return [_normalize(v, where) for v in value]
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError(f"{where}: dict keys must be str, got {k!r}")
            out[k] = _normalize(v, f"{where}.{k}")
        return out
    raise TypeError(
        f"{where}: {type(value).__name__} is not JSON-serializable "
        f"(specs hold plain data; build objects at run time)")


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    """One registry-resolved component: a kind string + builder kwargs."""

    kind: str
    params: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not isinstance(self.kind, str) or not self.kind:
            raise TypeError("ComponentSpec.kind must be a non-empty string")
        object.__setattr__(
            self, "params", _normalize(dict(self.params), self.kind))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Any) -> "ComponentSpec":
        if isinstance(d, str):  # shorthand: "complete" == {"kind": "complete"}
            return cls(kind=d)
        unknown = set(d) - {"kind", "params"}
        if unknown:
            raise ValueError(f"component has unknown keys {sorted(unknown)}")
        return cls(kind=d["kind"], params=dict(d.get("params") or {}))

    def replace(self, **params: Any) -> "ComponentSpec":
        """New ComponentSpec with `params` merged over the existing ones."""
        return ComponentSpec(self.kind, {**self.params, **params})


def _component(value) -> ComponentSpec:
    if isinstance(value, ComponentSpec):
        return value
    return ComponentSpec.from_dict(value)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Everything one run needs, as data.

    Fields:
      name:      manifest/run identifier (used in output filenames).
      problem:   problems-registry component; carries n and d.
      topology:  topologies-registry component (n is supplied by the
                 problem at build time, so params hold only k/seed/length).
      schedule:  schedules-registry component. Must be kind "adaptive" when
                 a controller is attached.
      backends:  one or more backends this spec declares it runs on, in
                 preference order; `run(spec)` uses the first unless told
                 otherwise. Params are backend-specific (scenario knobs for
                 netsim, mesh/arch knobs for launch).
      stepsize:  stepsizes-registry component for a(t).
      controller: optional adaptive-controller component ("adaptive" kind:
                 AdaptiveController knobs for netsim, "dense_adaptive":
                 DenseController knobs for the dense wall-clock loop).
      faults:    optional faultplans-registry component ("plan": explicit
                 FaultPlan fields, "churn": rotating crash/restart waves).
                 Netsim backends only; the builder receives the problem's n.
      compression: optional compressors-registry component ("topk",
                 "randk", "int8"; "none" is the same as leaving it unset).
                 Dense backend: compressed gossip with error feedback
                 inside the scanned program (sparse mix path when the
                 topology allows). Netsim: sender-side compression plus
                 wire_bytes scaling, so bandwidth-limited links feel the
                 ratio. Enters the serve cache signature and vmap lane
                 key like every other top-level field.
      T:         iterations per node (launch: training steps).
      eval_every: trace evaluation cadence (iterations per node).
      seed:      run RNG seed (problem seeds live in problem params).
      r:         configured communication/computation tradeoff: the dense
                 time charge, the netsim link serialization time, the
                 launch r_estimate (paper eq. 9 units).
      eps_frac:  optional accuracy target F* + eps_frac*(F(0)-F*); enables
                 time_to_target in the RunResult.
      time_limit: optional event-clock cap (netsim only).
      profile_dir: optional directory for a `jax.profiler` trace captured
                 around the dense backend's scanned program (dense only;
                 see repro.obs.profile_ctx). None (default) disables
                 profiling entirely.
    """

    name: str
    problem: ComponentSpec
    topology: ComponentSpec
    schedule: ComponentSpec
    backends: tuple[ComponentSpec, ...]
    stepsize: ComponentSpec = dataclasses.field(
        default_factory=lambda: ComponentSpec("sqrt", {"A": 1.0}))
    controller: ComponentSpec | None = None
    faults: ComponentSpec | None = None
    compression: ComponentSpec | None = None
    T: int = 1000
    eval_every: int = 25
    seed: int = 0
    r: float = 0.0
    eps_frac: float | None = None
    time_limit: float | None = None
    profile_dir: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "problem", _component(self.problem))
        object.__setattr__(self, "topology", _component(self.topology))
        object.__setattr__(self, "schedule", _component(self.schedule))
        object.__setattr__(self, "stepsize", _component(self.stepsize))
        if self.controller is not None:
            object.__setattr__(self, "controller",
                               _component(self.controller))
        if self.faults is not None:
            object.__setattr__(self, "faults", _component(self.faults))
        if self.compression is not None:
            object.__setattr__(self, "compression",
                               _component(self.compression))
        backends = tuple(_component(b) for b in self.backends)
        if not backends:
            raise ValueError("spec must declare at least one backend")
        object.__setattr__(self, "backends", backends)
        if self.T < 1:
            raise ValueError("T must be >= 1")
        if self.eval_every < 1:
            raise ValueError("eval_every must be >= 1")
        if self.r < 0:
            raise ValueError("r must be >= 0")
        object.__setattr__(self, "r", float(self.r))
        if self.eps_frac is not None:
            object.__setattr__(self, "eps_frac", float(self.eps_frac))
        if self.time_limit is not None:
            object.__setattr__(self, "time_limit", float(self.time_limit))
        if self.profile_dir is not None and not isinstance(self.profile_dir,
                                                           str):
            raise TypeError("profile_dir must be a path string or None")

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "spec_version": SPEC_VERSION,
            "name": self.name,
            "problem": self.problem.to_dict(),
            "topology": self.topology.to_dict(),
            "schedule": self.schedule.to_dict(),
            "backends": [b.to_dict() for b in self.backends],
            "stepsize": self.stepsize.to_dict(),
            "controller": (None if self.controller is None
                           else self.controller.to_dict()),
            "faults": (None if self.faults is None
                       else self.faults.to_dict()),
            "compression": (None if self.compression is None
                            else self.compression.to_dict()),
            "T": self.T,
            "eval_every": self.eval_every,
            "seed": self.seed,
            "r": self.r,
            "eps_frac": self.eps_frac,
            "time_limit": self.time_limit,
            "profile_dir": self.profile_dir,
        }
        return d

    def to_json(self, indent: int | None = 2) -> str:
        # allow_nan=False: a spec with inf/nan knobs would not round-trip
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        version = d.pop("spec_version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(f"unsupported spec_version {version!r} "
                             f"(this build reads {SPEC_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"spec has unknown keys {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- sweeps --------------------------------------------------------------

    def with_value(self, axis: str, value: Any) -> "ExperimentSpec":
        """New spec with one dotted-path field replaced.

        Axes: a scalar field ("T", "r", "seed", ...), a component kind
        ("schedule.kind"), or a component param ("schedule.params.h",
        "problem.params.n", "backends.0.params.engine"). This is the
        substrate of `run_sweep`: the paper's n/h/r grids are one axis each.
        """
        parts = axis.split(".")
        d = self.to_dict()
        cur: Any = d
        for p in parts[:-1]:
            cur = cur[int(p)] if isinstance(cur, list) else cur[p]
        leaf = parts[-1]
        if isinstance(cur, list):
            cur[int(leaf)] = value
        else:
            # new keys are legal inside a component's params (sweeping h
            # onto a schedule that used the default); top-level and
            # component fields must already exist (catches axis typos)
            in_params = len(parts) >= 2 and parts[-2] == "params"
            if leaf not in cur and not in_params:
                raise KeyError(f"axis {axis!r}: {leaf!r} not in "
                               f"{sorted(cur)}")
            cur[leaf] = value
        return ExperimentSpec.from_dict(d)
