"""Spawning `torch.distributed` ranks on gloo for the CPU tests, and the
work each rank does (`tests/test_torch_distributed.py`).

Each rank is a spawned process on one CPU thread (so its float sums are
those of a one-thread run in the test process), joined to the others by a
`FileStore`; it imports torch and the port only. `spawn` returns every
rank's result in rank order, or raises with the first rank's traceback.
"""

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: seconds a rank waits in a collective before gloo gives up
COLLECTIVE_TIMEOUT_S = 120


def _rank_main(target, rank, n, store_path, payload, results):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, n), rank=rank,
        world_size=n,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        results.put((rank, None, target(rank, n, payload)))
    except BaseException:  # noqa: BLE001 -- sent to the parent, which raises
        results.put((rank, traceback.format_exc(), None))
    finally:
        dist.destroy_process_group()


def spawn(target, n: int, payload=None, timeout: float = 300.0) -> list:
    """Run `target(rank, n, payload)` on n gloo ranks; their results in
    rank order. Every rank is stopped before this returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, n, store, payload, results))
             for r in range(n)]
    out: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            try:
                rank, err, value = results.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(
                    f"ranks {sorted(set(range(n)) - set(out))} gave no "
                    f"result within {timeout} s") from None
            if err is not None:
                raise AssertionError(f"rank {rank} failed:\n{err}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]


# ---------------------------------------------------------------------------
# rank work
# ---------------------------------------------------------------------------


def collectives(rank, n, payload):
    """mix_collective and mix_stale on every graph (float32, and the
    dtype kept in bf16), dda_mix_step and mix_params, on this rank's
    row of the payload's stacked inputs."""
    from repro_torch.core import consensus as C
    from repro_torch.core import dda, graphs
    from repro_torch.core.consensus_sgd import ConsensusConfig, mix_params

    z = torch.tensor(payload["z"], dtype=torch.float32)
    acc = torch.tensor(payload["acc"], dtype=torch.float32)
    out = {}
    with C.bind_axis("pod", dist.group.WORLD):
        for name in payload["graphs"]:
            g = graphs.build_graph(name, n)
            mixed, nxt = C.mix_stale(z[rank], acc[rank], g, "pod")
            low = C.mix_collective(z[rank].bfloat16(), g, "pod")
            tree = C.tree_mix_collective({"a": z[rank], "b": [acc[rank]]},
                                         g, "pod")
            out[name] = {
                "mix": C.mix_collective(z[rank], g, "pod").tolist(),
                "stale": [mixed.tolist(), nxt.tolist()],
                "bf16": [str(low.dtype), low.float().tolist()],
                "tree": [tree["a"].tolist(), tree["b"][0].tolist()],
            }
        g = graphs.build_graph(payload["dda_graph"], n)
        state = dda.DDAState(
            z={"w": z[rank], "b": acc[rank, :3]},
            x={"w": z[rank] * 0.5, "b": acc[rank, :3] * 0.5},
            xhat={"w": z[rank] * 0.25, "b": acc[rank, :3] * 0.25},
            t=torch.tensor(3.0))
        grad = {"w": acc[rank], "b": z[rank, :3]}
        new = dda.dda_mix_step(state, grad, g, "pod",
                               dda.stepsize_sqrt(0.5))
        out["dda"] = {f: {k: getattr(new, f)[k].tolist() for k in ("b", "w")}
                      for f in ("z", "x", "xhat")}
        out["dda"]["t"] = float(new.t)
        params = mix_params({"w": z[rank], "b": acc[rank]},
                            ConsensusConfig(g))
    # a process group in place of the bound name
    out["group"] = mix_params({"w": z[rank]}, ConsensusConfig(
        g, dist.group.WORLD))["w"].tolist()
    out["params"] = {k: v.tolist() for k, v in params.items()}
    return out


#: the checkpoint run's arguments
_CKPT_RUN = dict(batch_per_node=2, seq_len=32, seed=0, log_every=0)


def train(mesh, steps: int, ckpt_dir: str, mix_target: str = "params"):
    """The checkpoint case's run: llama3-8b smoke, periodic h = 2, saved
    every 2 steps (stacked in the test process, or one pod a rank); AdamW
    mixing the parameters, or dual averaging mixing z."""
    from repro_torch import optim
    from repro_torch.core.schedules import Periodic
    from repro_torch.launch.train import train_consensus_lm
    from repro_torch.models import registry

    cfg = registry.get_config("llama3-8b", "smoke")
    opt = (optim.adamw(optim.cosine_lr(3e-4, 6)) if mix_target == "params"
           else optim.dual_averaging(optim.rsqrt_lr(0.5, q=0.7)))
    return train_consensus_lm(
        cfg, opt, mesh, steps=steps, schedule=Periodic(h=2),
        ckpt_dir=ckpt_dir, ckpt_every=2, mix_target=mix_target,
        **_CKPT_RUN)


def launch(rank, n, payload):
    """run(spec) with the pods one a rank; the checkpoint run (written to
    4 steps, then a stacked run's files resumed to 6); the mesh's and the
    runner's refusals of a group of the wrong size."""
    import repro_torch
    from repro_torch.launch.mesh import make_mesh

    spec = repro_torch.ExperimentSpec.from_dict(payload["spec"])
    out = {"result": repro_torch.run(spec, device="cpu").to_dict()}
    if payload.get("ckpt"):
        mesh = make_mesh((n, 1, 1), ("pod", "data", "model"), device="cpu",
                         group=dist.group.WORLD)
        train(mesh, 4, payload["write"])
        rep = train(mesh, 6, payload["resume"])
        out["resume"] = {"resumed_from": rep.resumed_from,
                         "losses": rep.losses}
        out["z_losses"] = train(mesh, 4, payload["write_z"], "z").losses
        errors = []
        try:
            make_mesh((2 * n, 1, 1), ("pod", "data", "model"),
                      device="cpu", group=dist.group.WORLD)
        except ValueError as e:
            errors.append(str(e))
        wrong = dict(payload["spec"], backends=[
            {"kind": "launch", "params": {"mesh": [2 * n, 1, 1]}}])
        try:
            repro_torch.run(repro_torch.ExperimentSpec.from_dict(wrong),
                            device="cpu")
        except ValueError as e:
            errors.append(str(e))
        out["errors"] = errors
    return out


def stacked_inputs(n: int, d: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"z": rng.normal(size=(n, d)).astype(np.float32).tolist(),
            "acc": rng.normal(size=(n, d)).astype(np.float32).tolist()}


def sharded(rank, n, payload):
    """The sharded layouts' work (`tests/test_torch_sharded*.py`): each of
    the payload's specs through `run`; the (2, 2, 2) checkpoint run written
    to 4 steps, then a stacked run's files resumed to 6; `constrain` on a
    DTensor under the rules; qwen1.5-110b's Megatron FFN (`mlp_tp`)
    through `train_consensus_lm`."""
    import dataclasses

    import repro_torch
    from repro_torch import optim
    from repro_torch.core.schedules import Periodic
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_consensus_lm
    from repro_torch.models import registry

    out = {name: repro_torch.run(repro_torch.ExperimentSpec.from_dict(spec),
                                 device="cpu").to_dict()
           for name, spec in payload.get("specs", {}).items()}
    if payload.get("constrain"):
        out["constrain"] = _constrain_case(payload["constrain"])
    if payload.get("write"):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu",
                         group=dist.group.WORLD)
        out["written"] = train(mesh, 4, payload["write"]).losses
        if payload.get("resume"):
            rep = train(mesh, 6, payload["resume"])
            out["resume"] = {"resumed_from": rep.resumed_from,
                             "losses": rep.losses}
    if payload.get("mlp_tp"):
        cfg = dataclasses.replace(registry.get_config("qwen1.5-110b",
                                                      "smoke"), mlp_tp=True)
        mesh = make_mesh(tuple(payload["mlp_tp"]), ("pod", "data", "model"),
                         device="cpu", group=dist.group.WORLD)
        out["mlp_tp"] = train_consensus_lm(
            cfg, optim.adamw(optim.cosine_lr(3e-4, 6)), mesh, steps=6,
            schedule=Periodic(h=2), batch_per_node=2, seq_len=32, seed=0,
            log_every=0).losses
    return out


def _constrain_case(shape):
    """A replicated DTensor constrained to ("batch", "seq_sp",
    "embed_act") on a mesh of `shape` (this process group's ranks): its
    placements, `spec_for`'s, and whether its values are the input's."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import sharding as sh

    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), device="cpu",
                     group=dist.group.WORLD)
    dm = mesh.shard_mesh
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    d = distribute_tensor(x, dm, [Replicate()] * dm.ndim)
    axes = ("batch", "seq_sp", "embed_act")
    with sh.use_rules(sh.DEFAULT_RULES, mesh):
        y = sh.constrain(d, axes)
        spec = sh.spec_for(d, axes)
        kept = sh.constrain(y, axes) is y
    return {"placements": [str(p) for p in y.placements],
            "want": [str(p) for p in sh.to_placements(spec, dm)],
            "spec": list(spec), "equal": bool(torch.equal(y.full_tensor(), x)),
            "local": list(y.to_local().shape), "kept": kept,
            "without_rules": sh.constrain(d, axes) is d}
