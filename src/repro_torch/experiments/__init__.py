"""One experiment API on the port: declarative `ExperimentSpec` ->
`repro_torch.run()`, the same specs and the same `RunResult` as
`repro.experiments`.

    import repro_torch

    spec = repro_torch.ExperimentSpec.from_file(
        "benchmarks/manifests/expander_periodic.json")
    result = repro_torch.run(spec)                 # on the CUDA card
    result = repro_torch.run(spec, device="cpu")   # only when asked

    results = repro_torch.run_sweep(spec, "schedule.params.h",
                                    [1, 2, 4, 8, 16], parallel="vmap")

Every backend of the reference runs: dense (uncompressed and
compressed, with its sweeps), netsim and launch.
"""

from repro_torch.experiments.components import (LMProblem, Problem,
                                                problems, schedules,
                                                stepsizes, topologies)
from repro_torch.experiments.registry import Registry
from repro_torch.experiments.result import RunResult
from repro_torch.experiments.runner import (backends, run, run_all,
                                           run_sweep)
from repro_torch.experiments.spec import ComponentSpec, ExperimentSpec


def __getattr__(name):
    # lazy: repro_torch.faults.plan and repro_torch.compress import this
    # package's registry module, so an eager import here would be circular
    # when either loads first
    if name in ("FaultPlan", "faultplans"):
        from repro_torch.faults.plan import FaultPlan, faultplans
        return {"FaultPlan": FaultPlan, "faultplans": faultplans}[name]
    if name in ("Compressor", "compressors"):
        from repro_torch.compress import Compressor, compressors
        return {"Compressor": Compressor, "compressors": compressors}[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ComponentSpec",
    "Compressor",
    "ExperimentSpec",
    "FaultPlan",
    "LMProblem",
    "Problem",
    "Registry",
    "RunResult",
    "backends",
    "compressors",
    "faultplans",
    "problems",
    "run",
    "run_all",
    "run_sweep",
    "schedules",
    "stepsizes",
    "topologies",
]
