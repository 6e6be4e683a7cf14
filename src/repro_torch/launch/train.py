"""Training driver, the port of `repro.launch.train`: consensus data-parallel
LM training with the paper's communication schedules and checkpoint /
restart, with a run's pods stacked on one card.

The schedule decides per iteration whether to run the cheap `local_step`
(no mixing) or the `fused_step` (local + consensus mixing through kernel
K1): the paper's 1/n vs 1/n + kr cost split, as two step functions.
"""

from __future__ import annotations

import dataclasses
import time

import torch
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
from repro_torch.models.common import ModelConfig
from repro_torch.optim import Optimizer, OptState


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
               device) -> tuple[dict, OptState]:
    """Pod-stacked (params, opt_state) from `seed`, as the reference's
    `init_all` draws them: one key per pod from `split(PRNGKey(seed),
    n_pods)`, each pod's params from `transformer.init` and its optimizer
    state from `optimizer.init` (zeros and a step of 0 for every port
    optimizer, so it is built on the stacked params at once)."""
    keys = prng.split(prng.key(seed, device), n_pods)
    params = sp.pod_stack((transformer.init(k, cfg)[0] for k in keys), n_pods)
    state = optimizer.init(params)
    step = torch.zeros((n_pods,), dtype=torch.int32, device=device)
    return params, OptState(step, state.inner)


def _stacked_batch(streams) -> dict:
    nexts = [next(s) for s in streams]  # disjoint per-pod shards
    return {"tokens": torch.stack([b["tokens"] for b in nexts]),
            "labels": torch.stack([b["labels"] for b in nexts])}


def _restore_into(state, restored) -> None:
    """Copy a restored (host) tree into the run's tensors, leaf by leaf."""
    for dst, src in zip(_pytree.tree_leaves(state),
                        _pytree.tree_leaves(restored)):
        dst.copy_(src)


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
    `launch.mesh.make_mesh`: the pods stacked on the mesh's card).

    Returns per-step losses plus the simulated time-unit accounting
    (1/n per iteration + k*r per communication round, paper eq. 9/19).

    `graph` overrides the `topology` name with a prebuilt CommGraph (n must
    equal the mesh's pod-axis size). `dryrun` builds both step functions
    (cheap local, fused local+mix) and returns after zero training steps,
    the seconds spent building each in `extras` (nothing compiles: they
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

    params, opt_state = init_state(cfg, optimizer, n_pods, seed, device)
    streams = [TokenStream(cfg.vocab_size, seq_len, batch_per_node,
                           node_index=i, num_nodes=n_pods, seed=seed,
                           device=device)
               for i in range(n_pods)]
    try:
        # bytes one pod ships per gossip round per link: the mixed payload
        # is the per-pod parameter tree, so the stacked bytes divide by
        # n_pods
        param_bytes_per_pod = sp.param_bytes_per_pod(params, n_pods)

        if dryrun:
            _stacked_batch(streams)
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

        mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        start_step = 0
        resumed = None
        if mgr is not None:
            got = mgr.restore_latest((params, opt_state))
            if got is not None:
                start_step, restored, _ = got
                _restore_into((params, opt_state), restored)
                resumed = start_step

        losses = []
        comm_rounds = 0
        sim_time = 0.0
        step_walls: list[float] = []
        step_comm: list[bool] = []
        for t in range(start_step + 1, steps + 1):
            batch = _stacked_batch(streams)
            comm = schedule.is_comm_step(t)
            step_fn = fused if comm else local
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            sim_time += 1.0 / n_pods + (k * r_estimate if comm else 0.0)
            comm_rounds += int(comm)
            loss = float(torch.mean(metrics["loss"]))  # waits for the step
            wall = time.perf_counter() - t0
            step_walls.append(wall)
            step_comm.append(comm)
            if tracer is not None:
                tracer.add_host_span("fused_step" if comm else "local_step",
                                     tracer.now() - wall, wall,
                                     track="launch", t=t)
            losses.append(loss)
            if log_every and t % log_every == 0:
                print(f"[train] step {t} loss {loss:.4f} "
                      f"comm_rounds {comm_rounds} sim_time {sim_time:.2f}",
                      flush=True)
            if mgr is not None and t % ckpt_every == 0:
                mgr.save(t, (params, opt_state), extra={"step": t})
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
