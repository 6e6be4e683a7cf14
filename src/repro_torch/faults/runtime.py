"""FaultRuntime: executes a `FaultPlan` inside both netsim engines.

The runtime is engine-agnostic: engines hand it the event queue and a small
adapter surface (`fault_state`, `fault_apply_node`, `fault_clear_inbox`,
`fault_activate`, `fault_deactivate`, `fault_splice_graph`,
`fault_next_comm`, `fault_notify_membership`, `fault_notify_heal`) and the
runtime keeps ALL fault bookkeeping -- alive/member masks, step
generations, the blocked-link matrix, counters, the fault RNG -- in shared
code, so the object and vectorized engines stay bit-identical under every
plan by construction: every handler runs at the same sim time in the same
queue order on both engines, mutates the same numpy state, and consumes
the same draws from the plan's private RNG stream.

Semantics:

- **crash**: the node stops stepping (its pending step event goes stale via
  a per-node generation counter), its inbox entries vanish on BOTH sides so
  neighbors fold the missing weight back into their self-loop -- exactly
  the deadline-degraded round's stale-mix semantics -- and messages
  that arrive while it is down are silently dropped. Messages still in
  flight when the crash fires are only dropped if they land during the
  downtime window: network asynchrony means the wire cannot know the
  sender died, and DDA's stale-stamp mixing tolerates a late pre-crash
  packet by design.
- **restart**: the node resumes from the latest in-sim checkpoint
  (`restore="checkpoint"`) or warm-starts from the survivors' consensus
  average (`restore="warm"`, the `elastic.rescale_state` rule: mean state,
  min iteration counter). Its next comm step is re-derived from the live
  schedule so adaptive retunes that happened during the downtime apply.
- **leave / join**: membership changes; the live topology is replaced by a
  freshly built regular expander over the current members (embedded into
  the original n with identity self-loops for non-members, so every mixing
  row stays stochastic) and spliced into the network's `GraphSequence`.
  The controller is told about the SUB-graph -- feeding it the embedded
  full-size graph would poison h_opt with the identity rows' lambda2.
- **partition / heal**: every directed link crossing the cut blocks at
  SEND time (before any loss/jitter draw, so the optimization RNG stream
  is untouched); heal unblocks everything and nudges the controller to
  retune immediately against the reconnected topology.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graphs import CommGraph, random_regular_expander
from repro_torch.faults.plan import FaultPlan

__all__ = ["FaultRuntime", "embed_subgraph"]


def embed_subgraph(sub: CommGraph, n: int, members: np.ndarray) -> CommGraph:
    """Lift an m-node CommGraph onto n nodes: members wire through `sub`,
    non-members keep identity self-loops (perm[i] = i) so every row of the
    mixing matrix stays stochastic and `GraphSequence` splicing is legal."""
    members = np.asarray(members, dtype=np.int64)
    perms = []
    for perm in sub.perms:
        full = np.arange(n, dtype=np.int64)
        full[members] = members[np.asarray(perm, dtype=np.int64)]
        perms.append(tuple(int(v) for v in full))
    return CommGraph(f"{sub.name}_embed{len(members)}", n, tuple(perms),
                     sub.self_weight, sub.edge_weight)


class FaultRuntime:
    """Shared fault machinery both engines drive through `handle()`."""

    def __init__(self, plan: FaultPlan, n: int, tracer=None):
        self.plan = plan
        self.n = n
        self.alive = np.ones(n, dtype=bool)
        self.member = np.ones(n, dtype=bool)
        self.step_gen = np.zeros(n, dtype=np.int64)
        self.blocked = np.zeros((n, n), dtype=bool)
        # the fault stream: ONLY fault handlers draw from it, and handlers
        # fire in identical order on both engines
        self.rng = np.random.default_rng(plan.seed)
        self.crashes = 0
        self.restarts = 0
        self.joins = 0
        self.leaves = 0
        self.downtime_sim = 0.0
        self.partition_epochs = 0
        self.link_flaps = 0
        self.checkpoints = 0
        self.blocked_sends = 0
        self._crash_time: dict[int, float] = {}
        self._part_pairs: set[tuple[int, int]] = set()
        self._flap_down: dict[tuple[int, int], bool] = {}
        self._ckpt: dict | None = None
        self._ckpt_seq = 0
        self._rebuilds = 0
        self._mgr = None
        if plan.checkpoint_every > 0.0 and plan.checkpoint_dir is not None:
            from repro_torch.checkpoint.manager import CheckpointManager
            self._mgr = CheckpointManager(plan.checkpoint_dir,
                                          keep=plan.checkpoint_keep)
        self._tr = tracer if (tracer is not None
                              and getattr(tracer, "detail", False)) else None
        self.eng = None
        self._base_degree = 0

    def bind(self, engine) -> None:
        self.eng = engine
        self._base_degree = engine.net.graph.degree

    def stats(self) -> dict:
        return {"crashes": int(self.crashes),
                "restarts": int(self.restarts),
                "joins": int(self.joins),
                "leaves": int(self.leaves),
                "downtime_sim": float(self.downtime_sim),
                "partition_epochs": int(self.partition_epochs),
                "link_flaps": int(self.link_flaps),
                "checkpoints": int(self.checkpoints),
                "blocked_sends": int(self.blocked_sends)}

    def record_mask(self) -> np.ndarray | None:
        """Rows to include in trace records: live members only (a trace
        point must not average in a crashed node's frozen iterate). None
        when nobody is up -- callers fall back to all rows."""
        m = self.alive & self.member
        return m if (m.any() and not m.all()) else (m if m.any() else None)

    # -- scheduling ----------------------------------------------------------

    def schedule_initial(self, q) -> None:
        """Seed the queue: explicit plan events verbatim, then the first
        renewal draw of each stochastic process in a FIXED order (MTBF
        crash, then flap links in declaration order) so the fault stream is
        consumed identically on both engines."""
        for ev in self.plan.events:
            q.schedule(ev.time, "fault", action=ev.action, node=ev.node,
                       group=ev.group)
        if self.plan.crash_mtbf > 0.0:
            q.schedule(float(self.rng.exponential(self.plan.crash_mtbf)),
                       "fault", action="mtbf")
        for link in self.plan.flap_links:
            q.schedule(float(self.rng.exponential(self.plan.flap_mtbf)),
                       "fault", action="flap", link=link)
        if self.plan.checkpoint_every > 0.0:
            q.schedule(self.plan.checkpoint_every, "fault",
                       action="checkpoint")

    def handle(self, q, data: dict) -> None:
        act = data["action"]
        if act == "crash":
            self._crash(q, data["node"])
        elif act == "restart":
            self._restart(q, data["node"])
        elif act == "join":
            self._join(q, data["node"])
        elif act == "leave":
            self._leave(q, data["node"])
        elif act == "partition":
            self._partition(q, data["group"])
        elif act == "heal":
            self._heal(q)
        elif act == "mtbf":
            self._mtbf(q)
        elif act == "flap":
            self._flap(q, data["link"])
        elif act == "checkpoint":
            self._checkpoint(q)
        else:  # pragma: no cover - plan validation rejects these earlier
            raise ValueError(f"unknown fault action {act!r}")

    # -- node lifecycle ------------------------------------------------------

    def _crash(self, q, j: int) -> None:
        if not (self.alive[j] and self.member[j]):
            return  # already down / not a member: deterministic no-op
        self.alive[j] = False
        self.step_gen[j] += 1
        self._crash_time[j] = q.now
        self.crashes += 1
        self.eng.fault_deactivate(j)
        self.eng.fault_clear_inbox(j)
        self._instant(q, "fault_crash", node=j)

    def _restore_row(self, j: int) -> dict:
        """State a restarting/joining node j resumes with. Checkpoint row
        when asked for and available, else warm start: mean x/xhat/z over
        the live members, min of their iteration counters (re-running a few
        steps is safe; skipping ahead is not). Falls back to j's own frozen
        state when nobody else is up. next_comm is ALWAYS re-derived from
        the live schedule (retunes may have happened during the downtime)."""
        eng = self.eng
        if self.plan.restore == "checkpoint" and self._ckpt is not None:
            c = self._ckpt
            t = int(c["t"][j])
            return {"x": c["x"][j].copy(), "xhat": c["xhat"][j].copy(),
                    "z": c["z"][j].copy(), "t": t,
                    "comm_iters": int(c["comm_iters"][j]),
                    "next_comm": eng.fault_next_comm(t)}
        st = eng.fault_state()
        others = self.alive & self.member
        others[j] = False
        if not others.any():
            t = int(st["t"][j])
            return {"x": st["x"][j], "xhat": st["xhat"][j], "z": st["z"][j],
                    "t": t, "comm_iters": int(st["comm_iters"][j]),
                    "next_comm": eng.fault_next_comm(t)}
        t = int(st["t"][others].min())
        return {"x": st["x"][others].mean(axis=0),
                "xhat": st["xhat"][others].mean(axis=0),
                "z": st["z"][others].mean(axis=0),
                "t": t,
                "comm_iters": int(st["comm_iters"][others].min()),
                "next_comm": eng.fault_next_comm(t)}

    def _restart(self, q, j: int) -> None:
        if self.alive[j] or not self.member[j]:
            return
        row = self._restore_row(j)
        self.alive[j] = True
        self.downtime_sim += q.now - self._crash_time.pop(j, q.now)
        self.restarts += 1
        self.step_gen[j] += 1
        self.eng.fault_apply_node(j, row)
        self.eng.fault_activate(j)
        self._instant(q, "fault_restart", node=j)

    def _leave(self, q, j: int) -> None:
        if not self.member[j]:
            return
        self.member[j] = False
        self.leaves += 1
        self.step_gen[j] += 1
        if self.alive[j]:
            self.alive[j] = False
            self.eng.fault_deactivate(j)
        else:
            # a crashed node that leaves stops accruing downtime: it is
            # gone, not down
            self._crash_time.pop(j, None)
        self.eng.fault_clear_inbox(j)
        self._splice(q)
        self._instant(q, "fault_leave", node=j)

    def _join(self, q, j: int) -> None:
        if self.member[j]:
            return
        row = self._restore_row(j)  # before flipping flags: exclude j
        self.member[j] = True
        self.alive[j] = True
        self.joins += 1
        self.step_gen[j] += 1
        self.eng.fault_apply_node(j, row)
        self._splice(q)  # before activate: busy time uses the new degree
        self.eng.fault_activate(j)
        self._instant(q, "fault_join", node=j)

    def _splice(self, q) -> None:
        """Rebuild the topology over current members and splice it into
        the live GraphSequence (same n, so downstream state shapes hold)."""
        members = np.nonzero(self.member)[0]
        m = len(members)
        if m == 0:
            return  # everyone left; nothing to wire
        k = max(2, (self._base_degree // 2) * 2)
        self._rebuilds += 1
        sub = random_regular_expander(m, k=k,
                                      seed=self.plan.seed + self._rebuilds)
        self.eng.fault_splice_graph(embed_subgraph(sub, self.n, members))
        self.eng.fault_notify_membership(sub, members)

    # -- links ---------------------------------------------------------------

    def _partition(self, q, group) -> None:
        g = {int(x) for x in group}
        other = [i for i in range(self.n) if i not in g]
        for a in g:
            for b in other:
                self._part_pairs.add((a, b))
                self._part_pairs.add((b, a))
        self.partition_epochs += 1
        self._rebuild_blocked()
        self._instant(q, "fault_partition", size=len(g))

    def _heal(self, q) -> None:
        if not self._part_pairs:
            return
        self._part_pairs.clear()
        self._rebuild_blocked()
        self.eng.fault_notify_heal(q.now)
        self._instant(q, "fault_heal")

    def _flap(self, q, link) -> None:
        link = (int(link[0]), int(link[1]))
        down = not self._flap_down.get(link, False)
        self._flap_down[link] = down
        self.link_flaps += 1
        self._rebuild_blocked()
        if self.eng.active > 0:
            mean = self.plan.flap_mttr if down else self.plan.flap_mtbf
            q.schedule_in(float(self.rng.exponential(mean)), "fault",
                          action="flap", link=link)

    def _rebuild_blocked(self) -> None:
        self.blocked[:] = False
        for a, b in self._part_pairs:
            self.blocked[a, b] = True
        for (a, b), down in self._flap_down.items():
            if down:
                self.blocked[a, b] = True
                self.blocked[b, a] = True

    # -- stochastic crashes --------------------------------------------------

    def _mtbf(self, q) -> None:
        plan = self.plan
        pool = np.nonzero(self.alive & self.member)[0]
        if len(pool):  # draw order fixed: victim, repair dwell, next crash
            j = int(pool[self.rng.integers(len(pool))])
            self._crash(q, j)
            if plan.crash_mttr > 0.0:
                q.schedule_in(float(self.rng.exponential(plan.crash_mttr)),
                              "fault", action="restart", node=j)
        if ((plan.max_crashes == 0 or self.crashes < plan.max_crashes)
                and self.eng.active > 0):
            q.schedule_in(float(self.rng.exponential(plan.crash_mtbf)),
                          "fault", action="mtbf")

    # -- checkpoints ---------------------------------------------------------

    def _checkpoint(self, q) -> None:
        snap = self.eng.fault_state()
        self._ckpt = snap
        self._ckpt_seq += 1
        self.checkpoints += 1
        if self._mgr is not None:
            self._mgr.save(self._ckpt_seq, snap,
                           extra={"sim_time": float(q.now)}, blocking=True)
        if self.eng.active > 0:
            q.schedule_in(self.plan.checkpoint_every, "fault",
                          action="checkpoint")

    def _instant(self, q, name: str, **meta) -> None:
        if self._tr is not None:
            self._tr.add_instant(name, t=q.now, track="faults", **meta)
