"""Scenario presets for the event-driven cluster simulator.

A `Scenario` bundles everything the driver needs about the *cluster*
(topology, link models, node speeds, message size) -- the *problem*
(gradients, objective, stepsize) stays with `NetSimulator`. All presets are
parameterized by the paper's r: the per-message transmit time in full-grad
units, realized as link bandwidth = message_bytes / r so that a lossless
homogeneous run reproduces eq. (9)'s 1/n + k*r per-iteration cost exactly.
Every preset accepts `graph=` to override its default topology with a
prebuilt CommGraph/GraphSequence -- the repro_torch.experiments runner resolves
topologies through its registry and hands the built graph in.

Presets:
  * homogeneous            -- identical nodes, perfect links (the paper's
                              idealized cluster; calibration baseline).
  * straggler              -- `n_slow` nodes compute `slow_factor`x slower
                              (section I's "unrelated tasks" motivation).
  * lossy                  -- i.i.d. packet loss on every link.
  * time_varying_expander  -- the expander is rewired every `rewire_every`
                              time units (PAPERS.md: Yarmoshik-Klimenko
                              time-varying-network regime).
  * adversarial            -- everything at once: packet loss on every link,
                              `n_slow` stragglers, and periodic rewiring.
                              The worst cluster the model can express; used
                              as the engine-equivalence stress scenario
                              (tests/test_netsim_engine.py).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.graphs import (CommGraph, GraphSequence, expander_sequence,
                                     kregular_expander)
from repro_torch.netsim.network import LinkModel, Network, NodeSpec

__all__ = [
    "Scenario",
    "homogeneous",
    "straggler",
    "lossy",
    "time_varying_expander",
    "adversarial",
]

DEFAULT_MESSAGE_BYTES = 800.0  # a 100-double dual vector


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    topology: CommGraph | GraphSequence
    link: LinkModel
    node_specs: tuple[NodeSpec, ...]
    message_bytes: float = DEFAULT_MESSAGE_BYTES
    rewire_every: float | None = None   # sim-time between topology epochs

    @property
    def n(self) -> int:
        return self.topology.n

    def build_network(self) -> Network:
        return Network(self.topology, self.link, list(self.node_specs),
                       self.message_bytes)


def _link_for_r(r: float, message_bytes: float, *, latency: float = 0.0,
                jitter: float = 0.0, loss: float = 0.0, retries: int = 0,
                retry_timeout: float = 0.0) -> LinkModel:
    """Bandwidth such that one message serializes in exactly r time units."""
    if r < 0:
        raise ValueError("r must be >= 0")
    bw = message_bytes / r if r > 0 else float("inf")
    return LinkModel(latency=latency, bandwidth=bw, jitter=jitter, loss=loss,
                     retries=retries, retry_timeout=retry_timeout)


def _graph(n: int, k: int, seed: int) -> CommGraph:
    return kregular_expander(n, k=k, seed=seed)


def homogeneous(n: int, r: float, k: int = 4, seed: int = 0,
                message_bytes: float = DEFAULT_MESSAGE_BYTES,
                graph: CommGraph | None = None) -> Scenario:
    return Scenario(
        name="homogeneous",
        topology=graph if graph is not None else _graph(n, k, seed),
        link=_link_for_r(r, message_bytes),
        node_specs=tuple(NodeSpec() for _ in range(n)),
        message_bytes=message_bytes)


def straggler(n: int, r: float, slow_factor: float = 4.0, n_slow: int = 1,
              k: int = 4, seed: int = 0,
              message_bytes: float = DEFAULT_MESSAGE_BYTES,
              graph: CommGraph | GraphSequence | None = None) -> Scenario:
    if not 0 <= n_slow <= n:
        raise ValueError(f"n_slow must be in [0, {n}]")
    specs = tuple(NodeSpec.slowed(slow_factor) if i < n_slow else NodeSpec()
                  for i in range(n))
    return Scenario(
        name=f"straggler{slow_factor:g}x{n_slow}",
        topology=graph if graph is not None else _graph(n, k, seed),
        link=_link_for_r(r, message_bytes),
        node_specs=specs,
        message_bytes=message_bytes)


def lossy(n: int, r: float, loss: float = 0.2, k: int = 4, seed: int = 0,
          jitter: float = 0.0,
          message_bytes: float = DEFAULT_MESSAGE_BYTES,
          retries: int = 0, retry_timeout: float = 0.0,
          graph: CommGraph | GraphSequence | None = None) -> Scenario:
    return Scenario(
        name=f"lossy{loss:g}",
        topology=graph if graph is not None else _graph(n, k, seed),
        link=_link_for_r(r, message_bytes, jitter=jitter, loss=loss,
                         retries=retries, retry_timeout=retry_timeout),
        node_specs=tuple(NodeSpec() for _ in range(n)),
        message_bytes=message_bytes)


def adversarial(n: int, r: float, loss: float = 0.2,
                slow_factor: float = 4.0, n_slow: int = 1,
                rewire_every: float | None = None,
                k: int = 4, length: int = 4, seed: int = 0,
                message_bytes: float = DEFAULT_MESSAGE_BYTES,
                retries: int = 0, retry_timeout: float = 0.0,
                graph: CommGraph | GraphSequence | None = None) -> Scenario:
    """Loss + stragglers + (optionally) a time-varying topology, together."""
    if not 0 <= n_slow <= n:
        raise ValueError(f"n_slow must be in [0, {n}]")
    specs = tuple(NodeSpec.slowed(slow_factor) if i < n_slow else NodeSpec()
                  for i in range(n))
    topology: CommGraph | GraphSequence
    if graph is not None:
        topology = graph
    elif rewire_every is not None:
        topology = expander_sequence(n, k=k, length=length, seed=seed)
    else:
        topology = _graph(n, k, seed)
    return Scenario(
        name=f"adversarial_l{loss:g}_s{slow_factor:g}x{n_slow}",
        topology=topology,
        link=_link_for_r(r, message_bytes, loss=loss,
                         retries=retries, retry_timeout=retry_timeout),
        node_specs=specs,
        message_bytes=message_bytes,
        rewire_every=rewire_every)


def time_varying_expander(n: int, r: float, rewire_every: float,
                          k: int = 4, length: int = 4, seed: int = 0,
                          loss: float = 0.0,
                          message_bytes: float = DEFAULT_MESSAGE_BYTES,
                          graph: CommGraph | GraphSequence | None = None
                          ) -> Scenario:
    return Scenario(
        name=f"timevarying_T{rewire_every:g}",
        topology=(graph if graph is not None
                  else expander_sequence(n, k=k, length=length, seed=seed)),
        link=_link_for_r(r, message_bytes, loss=loss),
        node_specs=tuple(NodeSpec() for _ in range(n)),
        message_bytes=message_bytes,
        rewire_every=rewire_every)
