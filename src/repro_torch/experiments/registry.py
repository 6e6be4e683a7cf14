"""Minimal string-keyed component registry.

The experiment layer (`repro.experiments`) resolves every pluggable piece of
a run -- problem, topology, schedule, stepsize, backend -- through one of
these registries, so an `ExperimentSpec` can name components as plain
`(kind, params)` data and stay serializable. Follows the resolve-by-id
pattern of `models/registry.py` (`--arch <id>`), generalized: builders are
registered callables instead of one module per id, because experiment
components are small closures rather than config files.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Iterable

__all__ = ["Registry"]


class Registry:
    """Name -> builder mapping with aliases and kwargs filtering.

    Builders are plain callables; `build(name, **kwargs)` resolves the name
    (or any registered alias) and calls the builder. Unknown names raise
    `KeyError` listing what IS registered -- the error a typo in a checked-in
    manifest should produce.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._builders: dict[str, Callable[..., Any]] = {}
        self._aliases: dict[str, str] = {}

    def register(self, name: str, *, aliases: Iterable[str] = ()) -> Callable:
        """Decorator: `@registry.register("periodic")`."""
        def deco(fn: Callable) -> Callable:
            if name in self._builders or name in self._aliases:
                raise ValueError(f"{self.kind} {name!r} already registered")
            self._builders[name] = fn
            for a in aliases:
                if a in self._builders or a in self._aliases:
                    raise ValueError(f"{self.kind} alias {a!r} already taken")
                self._aliases[a] = name
            return fn
        return deco

    def canonical(self, name: str) -> str:
        """Resolve aliases to the registered name (raises on unknown)."""
        if name in self._builders:
            return name
        if name in self._aliases:
            return self._aliases[name]
        raise KeyError(
            f"unknown {self.kind} {name!r}; registered: {self.names()}")

    def builder(self, name: str) -> Callable[..., Any]:
        return self._builders[self.canonical(name)]

    def build(self, name: str, **kwargs: Any) -> Any:
        return self.builder(name)(**kwargs)

    def accepted(self, name: str, kwargs: dict[str, Any]) -> dict[str, Any]:
        """Subset of `kwargs` the builder's signature accepts.

        Back-compat helper for legacy shims (`core.schedules.make_schedule`
        uses it to keep `make_schedule("every", h=...)` legal) that
        historically passed every knob to every kind; new callers should
        pass exact params and get loud TypeErrors instead.
        """
        sig = inspect.signature(self.builder(name))
        if any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values()):
            return dict(kwargs)
        return {k: v for k, v in kwargs.items() if k in sig.parameters}

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._builders))

    def __contains__(self, name: str) -> bool:
        return name in self._builders or name in self._aliases
