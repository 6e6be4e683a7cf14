"""Cluster model: heterogeneous nodes + lossy/jittery point-to-point links.

Everything is expressed in the paper's normalized time units (one full-data
gradient on the REFERENCE node = 1.0), so a link configured with
`serialize == r` reproduces eq. (9)'s `k * r` per-communication cost exactly
and the event timeline stays directly comparable to `core.tradeoff`.

  * `LinkModel`   -- per-link latency / bandwidth / jitter / packet loss.
  * `NodeSpec`    -- per-node compute speed: the node's
                     `core.tradeoff.HardwareSpec` relative to a reference
                     one (`SIM_NODE` by default), or an explicit
                     `compute_scale` (a straggler factor).
  * `Network`     -- the topology (a `CommGraph` or a time-varying
                     `GraphSequence`), link models with per-edge overrides,
                     and message transmission sampling.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.graphs import CommGraph, GraphSequence
from repro_torch.core.tradeoff import HardwareSpec

__all__ = ["LinkModel", "NodeSpec", "Network", "SIM_NODE"]

#: The netsim's nominal node: the reference package's simulated node, field
#: for field. It is a parameter of the simulation model, in normalized time
#: units (one full-data gradient on it = 1.0); no time of any card follows
#: from it. A straggler's scale is `peak_flops / (peak_flops / factor)`,
#: whose float depends on this mantissa, so the port keeps it to give the
#: reference's event times bit for bit.
SIM_NODE = HardwareSpec(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
                        dcn_bw=25e9, hbm_per_chip=16e9)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One directed link. All times in normalized units.

    latency:   propagation delay added to every message.
    bandwidth: bytes per time unit; serialization time = bytes / bandwidth.
               `math.inf` means serialization is free.
    jitter:    mean of an exponential extra delay (0 disables).
    loss:      i.i.d. packet drop probability in [0, 1).

    Bounded retransmission (ack + timeout, the operational form of
    "deadline gossip"): with `retries > 0`, a dropped message is re-sent up
    to `retries` times, attempt k firing `retry_timeout * retry_backoff**
    (k-1)` after the previous drop (exponential backoff). Retransmits do
    NOT occupy the sender's NIC busy time -- the engines model them as
    background re-sends whose full flight time is in the air -- and are
    counted separately (`NetSimulator.retransmits`).

    retries:       max retransmit attempts per message (0 disables).
    retry_timeout: delay before the first retransmit (> 0 when retries > 0).
    retry_backoff: multiplicative backoff per attempt (>= 1).
    """

    latency: float = 0.0
    bandwidth: float = math.inf
    jitter: float = 0.0
    loss: float = 0.0
    retries: int = 0
    retry_timeout: float = 0.0
    retry_backoff: float = 2.0

    def __post_init__(self):
        if not 0.0 <= self.loss < 1.0:
            raise ValueError(f"loss must be in [0, 1), got {self.loss}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.retries > 0 and not self.retry_timeout > 0.0:
            raise ValueError("retries > 0 needs retry_timeout > 0")
        if self.retry_backoff < 1.0:
            raise ValueError(
                f"retry_backoff must be >= 1, got {self.retry_backoff}")

    def serialize(self, nbytes: float) -> float:
        """Sender NIC occupancy per message (the paper's per-message r when
        latency == jitter == 0)."""
        return nbytes / self.bandwidth if math.isfinite(self.bandwidth) else 0.0

    def sample_flight(self, nbytes: float,
                      rng: np.random.Generator) -> float | None:
        """Send-to-arrival delay for one message, or None if dropped."""
        if self.loss > 0.0 and rng.random() < self.loss:
            return None
        flight = self.serialize(nbytes) + self.latency
        if self.jitter > 0.0:
            flight += rng.exponential(self.jitter)
        return flight


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Per-node compute speed.

    `compute_scale` multiplies the node's local-step time (1.0 = reference
    speed, 4.0 = a 4x straggler). When None it is derived from the node's
    `HardwareSpec` peak FLOPs relative to `ref` (compute-bound local steps;
    memory-bound workloads should set `compute_scale` explicitly from their
    roofline, see tradeoff.derive_r_from_roofline).
    """

    hw: HardwareSpec = SIM_NODE
    compute_scale: float | None = None
    ref: HardwareSpec = SIM_NODE

    @property
    def scale(self) -> float:
        if self.compute_scale is not None:
            return self.compute_scale
        return self.ref.peak_flops / self.hw.peak_flops

    @staticmethod
    def slowed(factor: float) -> "NodeSpec":
        """A straggler: the nominal node with `factor`x less effective
        compute (e.g. co-scheduled unrelated work, the paper's section I
        motivation)."""
        return NodeSpec(hw=dataclasses.replace(
            SIM_NODE, peak_flops=SIM_NODE.peak_flops / factor))


class Network:
    """Topology + links + node speeds; the netsim's world model."""

    def __init__(self, topology: CommGraph | GraphSequence,
                 link: LinkModel = LinkModel(),
                 node_specs: list[NodeSpec] | None = None,
                 message_bytes: float = 8.0,
                 link_overrides: dict[tuple[int, int], LinkModel] | None = None):
        if isinstance(topology, CommGraph):
            topology = GraphSequence((topology,))
        self.seq = topology
        self.epoch = 0
        self.link = link
        self.message_bytes = float(message_bytes)
        # Bytes that actually cross the wire per message. Equal to
        # `message_bytes` uncompressed; `NetSimulator` scales it by the
        # attached compressor's `wire_ratio` so bandwidth-limited links
        # (LinkModel.serialize) genuinely feel the compression ratio,
        # while `message_bytes` stays the calibration constant scenarios
        # derive link bandwidth from (bw = message_bytes / r).
        self.wire_bytes = self.message_bytes
        self.link_overrides = dict(link_overrides or {})
        n = topology.n
        self.node_specs = list(node_specs or [NodeSpec()] * n)
        if len(self.node_specs) != n:
            raise ValueError(
                f"need {n} node specs, got {len(self.node_specs)}")
        self._out_cache: dict[int, list[list[int]]] = {}
        # Optional (n, n) override of the stale-gossip mixing weights: when
        # set (by an AdaptiveController with reweight_gossip=True), row i of
        # this matrix replaces the graph's uniform self/edge weights in the
        # nodes' stale mix -- the straggler-aware effective P acts on the
        # ACTUAL gossip, not just on the lambda2 estimate. None (the
        # default) keeps the configured uniform weights and the engines'
        # bit-identity contract untouched. Must be row-stochastic with the
        # current graph's support; weight of undelivered neighbors still
        # folds into the self weight, so rows stay convex combinations.
        self.mix_weights: np.ndarray | None = None

    @property
    def n(self) -> int:
        return self.seq.n

    @property
    def graph(self) -> CommGraph:
        return self.seq.at(self.epoch)

    def rewire(self) -> CommGraph:
        """Advance to the next graph in the time-varying sequence."""
        self.epoch += 1
        return self.graph

    # -- topology queries ---------------------------------------------------

    def in_neighbors(self, i: int) -> list[int]:
        """Sources node i receives from, one entry per permutation slot
        (the mixing weight is edge_weight per slot)."""
        g = self.graph
        return [perm[i] for perm in g.perms]

    def out_neighbors(self, i: int) -> list[int]:
        """Destinations node i sends to (one message per slot per round)."""
        idx = self.epoch % len(self.seq)
        if idx not in self._out_cache:
            g = self.seq.at(idx)
            out: list[list[int]] = [[] for _ in range(g.n)]
            for perm in g.perms:
                for dst in range(g.n):
                    out[perm[dst]].append(dst)
            self._out_cache[idx] = out
        return self._out_cache[idx][i]

    # -- timing -------------------------------------------------------------

    def link_for(self, src: int, dst: int) -> LinkModel:
        return self.link_overrides.get((src, dst), self.link)

    def serialize_time(self, src: int, dst: int) -> float:
        return self.link_for(src, dst).serialize(self.wire_bytes)

    def send_busy_time(self, i: int) -> float:
        """NIC occupancy for one full gossip round from node i (the k*r
        term of eq. 9): messages leave serially over the node's uplink."""
        return sum(self.serialize_time(i, d) for d in self.out_neighbors(i))

    def sample_flight(self, src: int, dst: int,
                      rng: np.random.Generator) -> float | None:
        return self.link_for(src, dst).sample_flight(self.wire_bytes, rng)

    def local_step_time(self, i: int) -> float:
        """One local (sub)gradient step on node i's 1/n data shard."""
        return self.node_specs[i].scale / self.n
