"""Training driver, the port of `repro.launch.train`: consensus data-parallel
LM training with the paper's communication schedules and checkpoint /
restart, with a run's pods stacked on one card, or one pod a rank of a
process group ("on a real cluster each pod's process group runs exactly
this", as the reference puts it).

The schedule decides per iteration whether to run the cheap `local_step`
(no mixing) or the `fused_step` (local + consensus mixing: kernel K1 over
stacked pods, collectives across ranks): the paper's 1/n vs 1/n + kr cost
split, as two step functions.

Across ranks, rank r draws pod r's parameters from the stacked run's key
and streams pod r's data, so its pod is the stacked run's pod r; each
step's loss is the mean of the (n,) vector of pod losses in rank order,
built by an all-reduce of a zero-filled vector in which each rank writes
its own slot (adding zeros is exact, and gloo takes CUDA tensors in an
all-reduce but not in an all-gather), so every rank logs the stacked
run's float. Checkpoints are the stacked run's files: rank 0 gathers the
pods and writes them, and a restore scatters them back from rank 0.

With a data or model axis above 1 each pod's replica is sharded
(`launch.mesh`): every rank draws only its pods' shards, each element with
the bits the whole draw gives it (`init_state`, `draw_shards`: no pod and
no sharded leaf is ever whole on a rank), streams its pods' full batches,
cut by their placements (the rows over 'data'), and runs the steps under
the sharding rules
(`runtime.sharding.use_rules`), as the reference runs its program. Each
rank returns the same report: the losses are whole on every rank.
Checkpoints gather every leaf whole (`full_tensor`) and rank 0 writes the
stacked run's files; a restore cuts the shards again, so a run resumes
across layouts.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
import torch.utils._pytree as _pytree

from repro_torch.checkpoint import CheckpointManager
from repro_torch.compress import prng
from repro_torch.core.graphs import CommGraph, build_graph
from repro_torch.core.schedules import CommSchedule, EveryIteration
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh, mesh_shape
from repro_torch.launch.steps import make_consensus_steps
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig, drawing_blocks
from repro_torch.optim import Optimizer, OptState
from repro_torch.runtime import sharding as shrules
from repro_torch.runtime.sharding import is_dtensor


@dataclasses.dataclass
class TrainReport:
    steps: int
    losses: list
    comm_rounds: int
    sim_time_units: float
    resumed_from: int | None = None
    # backend-specific observability (dryrun stats, wall timings);
    # surfaced as RunResult.extras by the experiments launch backend
    extras: dict = dataclasses.field(default_factory=dict)


def init_state(cfg: ModelConfig, optimizer: Optimizer, n_pods: int, seed: int,
               device, pods=None, mesh: Mesh | None = None
               ) -> tuple[dict, OptState]:
    """Pod-stacked (params, opt_state) from `seed`, as the reference's
    `init_all` draws them: one key per pod from `split(PRNGKey(seed),
    n_pods)`, each pod's params from `transformer.init` and its optimizer
    state from `optimizer.init` (zeros and a step of 0 for every port
    optimizer, so it is built on the stacked params at once). `pods`
    (default: all) picks the pods stacked, e.g. one rank's `[rank]`.

    On a mesh whose pods are sharded (`mesh.shard_mesh`) each leaf is
    drawn as this rank's shard alone (`draw_shards`, from the rank's
    coordinates on the DeviceMesh), the bits of the whole draw cut by its
    placements (`specs.train_placements`, as `runtime.sharding.cut` cuts),
    and wrapped as a DTensor of the whole stacked leaf's shape and
    strides; no pod and no sharded leaf is whole at any time. The
    optimizer state is built on the shards. The step counter stays a
    plain tensor."""
    pods = list(range(n_pods)) if pods is None else list(pods)
    step = torch.zeros((len(pods),), dtype=torch.int32, device=device)
    if mesh is None or mesh.shard_mesh is None:
        keys = prng.split(prng.key(seed, device), n_pods)
        params = sp.pod_stack((transformer.init(keys[i], cfg)[0]
                               for i in pods), len(pods))
        return params, OptState(step, optimizer.init(params).inner)
    from torch.distributed.tensor import DTensor

    dm = mesh.shard_mesh
    p_pl, s_pl, _ = sp.train_placements(cfg, optimizer, mesh, (1, 1))
    local = draw_shards(cfg, n_pods, seed, device, mesh_shape(mesh),
                        dict(zip(dm.mesh_dim_names, dm.get_coordinate())),
                        pods)
    flat, treedef = _pytree.tree_flatten(local)
    whole = _pytree.tree_leaves(sp.params_and_axes(cfg)[0])

    def placed(t, pl, like):
        shape = (len(pods),) + tuple(like.shape)
        return DTensor.from_local(
            t, dm, pl, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    placed_leaves = [placed(t, pl, like) for t, pl, like in zip(
        flat, _placement_leaves(p_pl), whole)]
    params = _pytree.tree_unflatten(placed_leaves, treedef)
    # every optimizer state tree mirrors the params leaf for leaf
    inner = optimizer.init(local).inner
    if inner is None:  # SGD without momentum keeps no state
        return params, OptState(step, None)
    flat_s, sdef = _pytree.tree_flatten(inner)
    wrapped = [placed(t, pl, whole[i % len(whole)])
               for i, (t, pl) in enumerate(zip(
                   flat_s, _placement_leaves(s_pl.inner)))]
    return params, OptState(step, _pytree.tree_unflatten(wrapped, sdef))


def draw_shards(cfg: ModelConfig, n_pods: int, seed: int, device,
                mesh_sizes: dict[str, int], coords: dict[str, int],
                pods=None) -> dict:
    """The pod-stacked parameters' local shards of the rank at `coords`
    (its index on each dimension of the (data, model) DeviceMesh) on a
    mesh of `mesh_sizes` ({axis: size}), as plain tensors: each pod drawn
    from its own `split` key and each stacked layer from its own
    `fold_in` key, as `init_state` draws them whole, but every leaf built
    as its shard alone under the training rules' placements
    (`models.common.drawing_blocks`, `runtime.sharding.block_rule`). It
    needs the coordinates alone, no process group, so any rank of any
    mesh can be drawn on one device."""
    pods = list(range(n_pods)) if pods is None else list(pods)
    keys = prng.split(prng.key(seed, device), n_pods)
    rule = shrules.block_rule(shrules.DEFAULT_RULES, mesh_sizes,
                              tuple(coords), coords)
    with drawing_blocks(rule):
        return sp.pod_stack((transformer.init(keys[i], cfg)[0]
                             for i in pods), len(pods))


def _placement_leaves(tree) -> list:
    """The placements tuples of a tree of them, in leaf order."""
    return _pytree.tree_leaves(tree, is_leaf=shrules.is_placements_leaf)


def _stacked_batch(streams) -> dict:
    nexts = [next(s) for s in streams]  # disjoint per-pod shards
    return {"tokens": torch.stack([b["tokens"] for b in nexts]),
            "labels": torch.stack([b["labels"] for b in nexts])}


def _restore_into(state, restored) -> None:
    """Copy a restored (host) tree into the run's tensors, leaf by leaf."""
    for dst, src in zip(_pytree.tree_leaves(state),
                        _pytree.tree_leaves(restored)):
        dst.copy_(src)


def _gather_pods(tree, mesh: Mesh, n_pods: int):
    """Rank 0: the pod-stacked host tree of every rank's pod (each leaf
    broadcast from its rank in turn); other ranks: None."""
    rank, group = mesh.pod_rank, mesh.pod_group
    leaves, spec = _pytree.tree_flatten(tree)
    out = []
    for leaf in leaves:
        if leaf is None:
            out.append(None)
            continue
        host = (torch.empty((n_pods,) + tuple(leaf.shape[1:]),
                            dtype=leaf.dtype) if rank == 0 else None)
        for src in range(n_pods):
            buf = leaf.clone() if src == rank else torch.empty_like(leaf)
            dist.broadcast(buf, src=dist.get_global_rank(group, src),
                           group=group)
            if host is not None:
                host[src].copy_(buf[0])
        out.append(host)
    return _pytree.tree_unflatten(out, spec) if rank == 0 else None


def _scatter_pods(tree, stacked, mesh: Mesh, n_pods: int) -> None:
    """Each rank's pod of rank 0's pod-stacked host tree `stacked` (None on
    the other ranks), broadcast from rank 0 pod by pod, copied into
    `tree`'s leaves (leading pod dimension 1)."""
    rank, group = mesh.pod_rank, mesh.pod_group
    root = dist.get_global_rank(group, 0)
    leaves = _pytree.tree_leaves(tree)
    sources = _pytree.tree_leaves(stacked) if rank == 0 else [None] * len(
        leaves)
    for leaf, src_leaf in zip(leaves, sources):
        if leaf is None:
            continue
        for dst in range(n_pods):
            buf = (src_leaf[dst:dst + 1].to(leaf.device) if rank == 0
                   else torch.empty_like(leaf))
            dist.broadcast(buf, src=root, group=group)
            if rank == dst:
                leaf.copy_(buf)


def _restore_ranked(mgr, state, mesh: Mesh, n_pods: int) -> int | None:
    """Rank 0 reads the latest pod-stacked checkpoint (None on the other
    ranks, which hold no manager) and scatters it; returns its step on
    every rank, or None."""
    got = None
    if mesh.pod_rank == 0 and mgr is not None:
        like = _pytree.tree_map(
            lambda t: None if t is None else torch.empty(
                (n_pods,) + tuple(t.shape[1:]), dtype=t.dtype,
                device="meta"), state)
        got = mgr.restore_latest(like)
    flag = torch.tensor([-1 if got is None else got[0]], dtype=torch.int64,
                        device=mesh.device)
    dist.broadcast(flag, src=dist.get_global_rank(mesh.pod_group, 0),
                   group=mesh.pod_group)
    step = int(flag.item())
    if step < 0:
        return None
    _scatter_pods(state, got[1] if got is not None else None, mesh, n_pods)
    return step


def _gather_sharded(tree, mesh: Mesh, n_pods: int):
    """Rank 0 of the mesh's group: the pod-stacked host tree of a sharded
    run's state (each DTensor leaf gathered whole, then, with one pod a
    rank, the pods gathered over the pod axis); other ranks: None."""
    whole = _pytree.tree_map(
        lambda t: t.full_tensor() if is_dtensor(t) else t, tree)
    if mesh.pod_group is not None:
        return _gather_pods(whole, mesh, n_pods)
    if dist.get_rank(mesh.group) != 0:
        return None
    return _pytree.tree_map(lambda t: t.cpu(), whole)


def _restore_sharded(mgr, state, mesh: Mesh, n_pods: int,
                     pods: list[int]) -> int | None:
    """Rank 0 of the mesh's group reads the latest pod-stacked checkpoint
    and broadcasts it leaf by leaf to every rank, which keeps its pods'
    shards (each DTensor leaf cut by its placements, as `init_state`
    cuts them): a run resumes from a checkpoint of any layout. Returns
    its step on every rank, or None."""
    group = mesh.group
    root = dist.get_global_rank(group, 0)
    got = None
    if dist.get_rank(group) == 0 and mgr is not None:
        like = _pytree.tree_map(
            lambda t: None if t is None else torch.empty(
                (n_pods,) + tuple(t.shape[1:]), dtype=t.dtype,
                device="meta"), state)
        got = mgr.restore_latest(like)
    flag = torch.tensor([-1 if got is None else got[0]], dtype=torch.int64,
                        device=mesh.device)
    dist.broadcast(flag, src=root, group=group)
    step = int(flag.item())
    if step < 0:
        return None
    leaves = _pytree.tree_leaves(state)
    sources = (_pytree.tree_leaves(got[1]) if got is not None
               else [None] * len(leaves))
    index = torch.tensor(pods, device=mesh.device)
    for leaf, src in zip(leaves, sources):
        buf = (src.to(mesh.device) if src is not None else torch.empty(
            (n_pods,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
            device=mesh.device))
        dist.broadcast(buf, src=root, group=group)
        part = buf.index_select(0, index)
        if is_dtensor(leaf):
            part = shrules.cut(part, leaf.device_mesh,
                               leaf.placements).to_local()
            leaf = leaf.to_local()
        leaf.copy_(part)
    return step


def _mean_loss(losses: torch.Tensor, mesh: Mesh, n_pods: int) -> float:
    """The mean of the (n,) pod losses in pod order: with one pod a rank,
    each rank's loss in its own slot of a zero-filled vector, all-reduced
    over the pod axis."""
    if mesh.pod_group is None:
        return float(torch.mean(losses))
    vec = torch.zeros((n_pods,), dtype=losses.dtype, device=losses.device)
    vec[mesh.pod_rank] = losses[0]
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=mesh.pod_group)
    return float(torch.mean(vec))


def _meta_trace(cfg: ModelConfig, params, batch: dict,
                moe_groups: int) -> None:
    """One pod's `transformer.loss_fn` on the meta device, its parameters
    and batch meta tensors of the pod's shapes and dtypes, without autograd
    and without the mix: what the reference's `lower().compile()` of its
    step programs checks of the model (shapes, dtypes, the tree's keys,
    the batch's fields), so an error its trace meets is raised here with
    the same type and message. Nothing is computed or allocated."""
    def meta(t):
        return torch.empty(t.shape[1:], dtype=t.dtype, device="meta")
    with torch.no_grad():
        transformer.loss_fn(_pytree.tree_map(meta, params),
                            {k: meta(v) for k, v in batch.items()}, cfg,
                            moe_groups)


def train_consensus_lm(cfg: ModelConfig, optimizer: Optimizer, mesh: Mesh,
                       *, steps: int = 100,
                       schedule: CommSchedule | None = None,
                       topology: str = "complete",
                       graph: CommGraph | None = None,
                       r_estimate: float = 0.05,
                       batch_per_node: int = 8,
                       seq_len: int = 64,
                       ckpt_dir: str | None = None,
                       ckpt_every: int = 50,
                       seed: int = 0,
                       log_every: int = 10,
                       mix_target: str = "params",
                       dryrun: bool = False,
                       tracer=None) -> TrainReport:
    """Run consensus DP training of `cfg` on `mesh` (axes pod, data, model;
    `launch.mesh.make_mesh`: the pods stacked on the mesh's card, or one
    pod a rank of the mesh's process group, every rank calling this with
    the same arguments and getting the same losses).

    Returns per-step losses plus the simulated time-unit accounting
    (1/n per iteration + k*r per communication round, paper eq. 9/19).

    `graph` overrides the `topology` name with a prebuilt CommGraph (n must
    equal the mesh's pod-axis size). `dryrun` builds both step functions
    (cheap local, fused local+mix), traces one pod's loss on the meta
    device (`_meta_trace`, the counterpart of the reference's lowering of
    both step programs), and returns after zero training steps, the
    seconds spent building each step in `extras` (nothing compiles: they
    are timings of the build). Checkpoints (`ckpt_dir`, every `ckpt_every`
    steps) are the reference's files: a run resumes from either package's.

    `tracer` (optional `repro_torch.obs.Tracer`) receives host-clock spans
    per training step / build; the per-step walls and comm flags are also
    returned in `extras["step_walls"]` / `extras["step_comm"]`.
    """
    schedule = schedule or EveryIteration()
    axis_sizes = mesh_shape(mesh)
    n_pods = axis_sizes.get("pod", 1)
    device = mesh.device
    if graph is None:
        graph = build_graph(topology, n_pods)
    elif graph.n != n_pods:
        raise ValueError(f"graph has n={graph.n} but the mesh has "
                         f"{n_pods} pods")
    k = graph.degree

    t0 = time.perf_counter()
    # the MoE dispatch groups: one per data shard, as the reference sets
    # them (the port's one-card mesh has a data axis of 1)
    moe_groups = max(axis_sizes.get("data", 1), 1) if cfg.moe_experts else 1
    local, mix, fused = make_consensus_steps(cfg, optimizer, graph, mesh,
                                             moe_groups=moe_groups,
                                             mix_target=mix_target)
    build_s = time.perf_counter() - t0

    ranked = mesh.pod_group is not None
    sharded = mesh.shard_mesh is not None
    # the pods this process holds: all of them, or its rank's
    pods = [mesh.pod_rank] if ranked else list(range(n_pods))
    params, opt_state = init_state(cfg, optimizer, n_pods, seed, device,
                                   pods=pods,
                                   mesh=None if dryrun else mesh)
    batch_pl = (sp.train_placements(cfg, optimizer, mesh,
                                    (batch_per_node, seq_len))[2]
                if sharded and not dryrun else None)
    streams = [TokenStream(cfg.vocab_size, seq_len, batch_per_node,
                           node_index=i, num_nodes=n_pods, seed=seed,
                           device=device)
               for i in pods]
    try:
        # bytes one pod ships per gossip round per link: the mixed payload
        # is the per-pod parameter tree, so the stacked bytes divide by
        # the pods stacked
        param_bytes_per_pod = sp.param_bytes_per_pod(params, len(pods))

        if dryrun:
            _meta_trace(cfg, params, _stacked_batch(streams), moe_groups)
            extras = {"dryrun": True, "n_pods": n_pods, "k": k,
                      "param_bytes": param_bytes_per_pod}
            # one build made both step functions: each is charged it
            for name in ("local", "fused"):
                extras[f"{name}_compile_s"] = round(build_s, 2)
                if tracer is not None:
                    tracer.add_host_span(f"compile:{name}",
                                         tracer.now() - build_s, build_s,
                                         track="launch")
            return TrainReport(steps=0, losses=[], comm_rounds=0,
                               sim_time_units=0.0, extras=extras)

        # across ranks rank 0 alone writes and reads the stacked files
        writer = ckpt_dir and (mesh.group is None
                               or dist.get_rank(mesh.group) == 0)
        mgr = CheckpointManager(ckpt_dir) if writer else None
        resumed = None
        if sharded and ckpt_dir:
            resumed = _restore_sharded(mgr, (params, opt_state), mesh,
                                       n_pods, pods)
        elif ranked and ckpt_dir:
            resumed = _restore_ranked(mgr, (params, opt_state), mesh, n_pods)
        elif mgr is not None:
            got = mgr.restore_latest((params, opt_state))
            if got is not None:
                resumed, restored, _ = got
                _restore_into((params, opt_state), restored)
        start_step = resumed or 0

        losses = []
        comm_rounds = 0
        sim_time = 0.0
        step_walls: list[float] = []
        step_comm: list[bool] = []
        for t in range(start_step + 1, steps + 1):
            batch = _stacked_batch(streams)
            if sharded:
                batch = {k: shrules.cut(v, mesh.shard_mesh, batch_pl)
                         for k, v in batch.items()}
            comm = schedule.is_comm_step(t)
            step_fn = fused if comm else local
            t0 = time.perf_counter()
            with shrules.use_rules(shrules.DEFAULT_RULES, mesh):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
            sim_time += 1.0 / n_pods + (k * r_estimate if comm else 0.0)
            comm_rounds += int(comm)
            loss = _mean_loss(metrics["loss"], mesh, n_pods)  # waits
            wall = time.perf_counter() - t0
            step_walls.append(wall)
            step_comm.append(comm)
            if tracer is not None:
                tracer.add_host_span("fused_step" if comm else "local_step",
                                     tracer.now() - wall, wall,
                                     track="launch", t=t)
            losses.append(loss)
            if log_every and t % log_every == 0 and (
                    mesh.group is None or dist.get_rank(mesh.group) == 0):
                print(f"[train] step {t} loss {loss:.4f} "
                      f"comm_rounds {comm_rounds} sim_time {sim_time:.2f}",
                      flush=True)
            if ckpt_dir and t % ckpt_every == 0:
                if sharded:
                    tree = _gather_sharded((params, opt_state), mesh, n_pods)
                elif ranked:
                    tree = _gather_pods((params, opt_state), mesh, n_pods)
                else:
                    tree = (params, opt_state)
                if mgr is not None:
                    mgr.save(t, tree, extra={"step": t})
        if mgr is not None:
            mgr.wait()
    finally:
        for s in streams:
            s.close()
    return TrainReport(steps=steps, losses=losses,
                       comm_rounds=comm_rounds,
                       sim_time_units=sim_time, resumed_from=resumed,
                       extras={"param_bytes": param_bytes_per_pod,
                               "step_walls": step_walls,
                               "step_comm": step_comm})
