"""Every kernel wrapper's launch counters, in one registry.

Each wrapper counts, in Python, the kernels it launches: module-level
integers (`LAUNCHES`, K3's `FLAT_LAUNCHES`, K4's launches by route, K5's
and K6's `KERNELS`) and K1's `FORM_LAUNCHES`, a dict by kernel. A CUDA
graph's replay runs no Python, so the run program (`core/dda.py`) takes a
snapshot of every counter before and after it captures a body and adds the
difference once per replay; chip_smoke.py sets them all to 0 around a run.
Both read `COUNTERS`, so a kernel counted there is counted on replay too.

A snapshot is flat: {(module, attribute): n} for an integer counter and
{(module, attribute, key): n} for each key of a dict counter.
"""

from __future__ import annotations

import importlib

__all__ = ["COUNTERS", "add", "delta", "restore", "snapshot", "zero"]

#: (module of repro_torch.kernels, attribute): every launch counter
COUNTERS = (("gossip_mix", "LAUNCHES"),
            ("gossip_mix", "FORM_LAUNCHES"),
            ("gossip_mix", "FLAT_LAUNCHES"),
            ("compress_mix", "LAUNCHES"),
            ("flash_attention", "LAUNCHES"),
            ("flash_attention", "SM90_LAUNCHES"),
            ("flash_attention", "TF32X3_LAUNCHES"),
            ("ssd_scan", "LAUNCHES"),
            ("ssd_scan", "KERNELS"),
            ("selective_scan", "LAUNCHES"),
            ("selective_scan", "KERNELS"))


def _module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def snapshot() -> dict[tuple, int]:
    """Every counter's value now, flat."""
    counts = {}
    for mod, attr in COUNTERS:
        value = getattr(_module(mod), attr)
        if isinstance(value, dict):
            for key, n in value.items():
                counts[(mod, attr, key)] = n
        else:
            counts[(mod, attr)] = value
    return counts


def restore(counts: dict[tuple, int]) -> None:
    """Set the counters named in `counts` to its values."""
    for key, n in counts.items():
        module = _module(key[0])
        if len(key) == 2:
            setattr(module, key[1], n)
        else:
            getattr(module, key[1])[key[2]] = n


def zero() -> None:
    """Set every counter to 0."""
    restore(dict.fromkeys(snapshot(), 0))


def delta(before: dict[tuple, int], after: dict[tuple, int]
          ) -> dict[tuple, int]:
    """What each counter grew by from `before` to `after`."""
    return {key: after[key] - before[key] for key in before}


def add(counts: dict[tuple, int], times: int = 1) -> None:
    """Add `counts` (a `delta`) `times` times to the counters."""
    now = snapshot()
    restore({key: now[key] + times * n for key, n in counts.items()})
