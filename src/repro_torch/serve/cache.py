"""Compile cache: warm `DDASimulator` instances keyed by program shape, on
the port (`repro.serve.cache` over the port's `ExperimentSpec`).

What a cold dense run pays once per shape on a card, and the server
amortizes, is the run program's set-up: the kernel library's first load,
the warm-up, and the capture of the comm, idle and statistics bodies as
CUDA graphs (`core.dda._LaneProgram`). A simulator keeps its programs,
with their graphs, keyed by x0's shape and the lane count -- so holding
the *simulator* across requests is holding that set-up, and a hit
captures nothing. `CompileCache` does exactly that: one simulator per
**cache signature**, leased to one run at a time.

The signature is the run program's shape identity -- everything that
changes what gets built or the constants baked into it:

  * the problem component verbatim (kind AND params: n, d and the data
    seed -- the problem's tensors are what its closures read);
  * the topology component verbatim (k, graph seed -- the mixing
    weights);
  * the stepsize component verbatim (a(t) constants);
  * T and eval_every (the run's length and its segments);
  * the schedule component's KIND only -- its params (h, p) are the comm
    MASK, which is host data the run picks its bodies from, not shape;
    the kind stays in the key as the reference keys it;
  * the resolved backend component (mix / loop / compress_keep shape the
    program);
  * controller presence/params (an adaptive run drives the closed loop's
    chunks; a plain run drives the whole run).

Deliberately NOT in the key -- the per-request knobs a warm simulator is
rebound with before each run: `seed`, `r` (host-side time-axis
bookkeeping), `eps_frac`/`name` (host-side bookkeeping). The signature is
the reference's string for the same spec.

Thread-safety: a global lock guards the table; each entry has its own
RLock held for the duration of a lease, so two requests with the same
signature serialize on the simulator (its runs use its buffers) while
different signatures run concurrently. Eviction is LRU over non-leased
entries only, and an evicted simulator is released (`release()`: its
graphs freed alone on the card, `core.dda.DEVICE_LOCK`) outside the
table's lock, since that release waits for other threads' runs.
"""

from __future__ import annotations

import contextlib
import json
import threading
from collections import OrderedDict
from typing import Any, Callable, Iterator

from repro_torch.experiments.spec import ComponentSpec, ExperimentSpec

__all__ = ["CompileCache", "cache_signature"]

#: spec fields that never shape the run program (rebound per lease)
CACHE_FREE_FIELDS = ("name", "seed", "r", "eps_frac")


def cache_signature(spec: ExperimentSpec,
                    backend: ComponentSpec | None = None) -> str:
    """Canonical JSON string identifying the run-program family a dense
    spec runs on; see the module docstring for what is in and out. Two
    specs with equal signatures can safely share one warm `DDASimulator`
    (per-request knobs rebound under the lease)."""
    d = spec.to_dict()
    d.pop("spec_version", None)
    for f in CACHE_FREE_FIELDS:
        d.pop(f, None)
    d.pop("backends", None)  # the RESOLVED backend is keyed instead
    d["schedule"] = d["schedule"]["kind"]  # params are mask data
    b = backend.to_dict() if backend is not None else None
    return json.dumps([d, b], sort_keys=True)


class _Entry:
    __slots__ = ("sim", "lock", "active", "hits")

    def __init__(self):
        self.sim: Any = None
        self.lock = threading.RLock()
        self.active = 0  # leases currently held (never evict while > 0)
        self.hits = 0


class CompileCache:
    """LRU table of warm simulators, one per cache signature.

    `lease(spec, backend, factory)` is the whole API: a context manager
    yielding `(sim, hit)`. On a miss `factory()` builds the simulator
    (under the entry lock, so concurrent first requests for one signature
    build once and the rest wait and hit). The caller must treat the
    simulator as exclusively theirs for the lease's duration and rebind
    any per-request knobs (`sim.schedule`, `sim.r`) before running.
    """

    def __init__(self, max_entries: int = 32):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @contextlib.contextmanager
    def lease(self, spec: ExperimentSpec, backend: ComponentSpec,
              factory: Callable[[], Any]) -> Iterator[tuple[Any, bool]]:
        sig = cache_signature(spec, backend)
        with self._lock:
            entry = self._entries.get(sig)
            hit = entry is not None
            if hit:
                self._entries.move_to_end(sig)
                self.hits += 1
                entry.hits += 1
            else:
                entry = _Entry()
                self._entries[sig] = entry
                self.misses += 1
            entry.active += 1
        try:
            with entry.lock:
                if entry.sim is None:
                    entry.sim = factory()
                yield entry.sim, hit
        finally:
            with self._lock:
                entry.active -= 1
                victims = self._evict_locked()
            for victim in victims:
                release = getattr(victim.sim, "release", None)
                if release is not None:
                    release()

    def _evict_locked(self) -> list[_Entry]:
        victims = []
        while len(self._entries) > self.max_entries:
            sig = next((sig for sig, e in self._entries.items()
                        if e.active == 0), None)
            if sig is None:  # every entry leased: nothing evictable now
                break
            victims.append(self._entries.pop(sig))
            self.evictions += 1
        return victims

    def stats(self) -> dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "capacity": self.max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
            }
