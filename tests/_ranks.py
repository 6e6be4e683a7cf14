"""Spawning `torch.distributed` ranks on gloo for the CPU tests, and the
work each rank does (`tests/test_torch_distributed.py`).

Each rank is a spawned process on one CPU thread (so its float sums are
those of a one-thread run in the test process), joined to the others by a
`FileStore`; it imports torch and the port only. `spawn` returns every
rank's result in rank order, or raises with the first rank's traceback.
"""

import contextlib
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
import torch.utils._pytree as _pytree

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
    through `train_consensus_lm`; fused steps with gradient accumulation
    from the reference's initial state (`accumulate`)."""
    import dataclasses

    import repro_torch
    from repro_torch import optim
    from repro_torch.core.schedules import Periodic
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_consensus_lm
    from repro_torch.models import registry

    out = {"choices": {}}
    for name, spec in payload.get("specs", {}).items():
        with _recorded_choices() as choices:
            out[name] = repro_torch.run(repro_torch.ExperimentSpec.from_dict(
                spec), device="cpu").to_dict()
        out["choices"][name] = [c.tolist() for c in choices]
    for name, spec in payload.get("failing", {}).items():
        try:
            repro_torch.run(repro_torch.ExperimentSpec.from_dict(spec),
                            device="cpu")
            out.setdefault("errors", {})[name] = None
        except Exception as e:  # noqa: BLE001 -- the error is the result
            out.setdefault("errors", {})[name] = [type(e).__name__, str(e)]
    if payload.get("blocks"):
        out["blocks"] = {case: _block_case(case, payload["blocks"])
                         for case in payload["blocks"]["cases"]}
    if payload.get("sgd"):
        mesh = make_mesh(tuple(payload["sgd"]), ("pod", "data", "model"),
                         device="cpu", group=dist.group.WORLD)
        out["sgd"] = sgd_run(mesh)
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
    if payload.get("accumulate"):
        out["accumulate"] = {arch: _accumulate_case(arch,
                                                    payload["accumulate"])
                             for arch in payload["accumulate"]["archs"]}
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


def _waited(path: str, timeout: float = 600.0) -> str:
    """`path` once it exists (a file another process writes and renames
    into place)."""
    import time

    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} not written in {timeout} s")
        time.sleep(0.5)
    return path


def _reference_numpy(tree, arrays, prefix: str):
    """The reference's numpy tree of `tree`'s structure: each leaf the
    array `arrays[prefix/path]` (bf16 stored as raw 2-byte values, read
    back as ml_dtypes' bfloat16), each `OptState` a (step, inner)
    namedtuple, as `convert.lm_params_from_reference` takes them."""
    import collections

    import ml_dtypes

    state = collections.namedtuple("OptState", ("step", "inner"))
    if isinstance(tree, dict):
        return {k: _reference_numpy(v, arrays, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_reference_numpy(v, arrays, f"{prefix}/{i}")
                 for i, v in enumerate(tree)]
        return state(*items) if hasattr(tree, "_fields") else type(tree)(
            items)
    a = arrays[prefix]
    return a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V" else a


def _accumulate_case(arch: str, payload: dict) -> dict:
    """`arch` smoke at mesh (1, 2, 2) on this process group's four ranks:
    the reference's initial state (written by its subprocess) carried
    across by `convert.lm_params_from_reference` and placed by the
    training placements, then fused steps of `make_consensus_steps(...,
    microbatches=M)` on the payload's batches. Returns the losses, grad
    norms, the steps' output bytes by collective kind and each
    all-gather's input (shape, dtype, the mesh dim it gathers over)."""
    from repro_torch import optim
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.core.graphs import build_graph
    from repro_torch.launch import specs as sp
    from repro_torch.launch.dryrun import CollectiveBytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_consensus_steps
    from repro_torch.launch.train import init_state
    from repro_torch.models import registry
    from repro_torch.optim import OptState
    from repro_torch.runtime import sharding as sh

    cfg = registry.get_config(arch, "smoke")
    opt = optim.adamw(optim.cosine_lr(3e-4, 6))
    mesh = make_mesh((1, 2, 2), ("pod", "data", "model"), device="cpu",
                     group=dist.group.WORLD)
    dm = mesh.shard_mesh
    batches = np.load(payload["batches"])
    B, S = batches[f"{arch}/tokens"].shape[2:]
    arrays = np.load(_waited(payload["init"]))
    params, state = lm_params_from_reference(_reference_numpy(
        init_state(cfg, opt, 1, 0, "meta"), arrays, arch), device="cpu")
    p_pl, s_pl, b_pl = sp.train_placements(cfg, opt, mesh, (B, S))
    params = sh.place(params, p_pl, dm)
    state = OptState(state.step, sh.place(state.inner, s_pl.inner, dm))
    _, _, fused = make_consensus_steps(
        cfg, opt, build_graph("complete", 1), mesh,
        moe_groups=2 if cfg.moe_experts else 1,
        microbatches=payload["microbatches"])
    seen = CollectiveBytes()
    out = {"losses": [], "grad_norms": []}
    for t in range(payload["steps"]):
        batch = {k: sh.cut(torch.from_numpy(
            batches[f"{arch}/{k}"][t].copy()), dm, b_pl)
            for k in ("tokens", "labels")}
        with sh.use_rules(sh.DEFAULT_RULES, mesh), seen:
            params, state, metrics = fused(params, state, batch)
        out["losses"].append(metrics["loss"].tolist())
        out["grad_norms"].append(metrics["grad_norm"].tolist())
    out["collectives"] = seen.bytes
    out["gathered"] = [(shape, dtype, _mesh_dim_of(ranks, dm))
                       for shape, dtype, ranks in seen.gathered]
    return out


def _mesh_dim_of(ranks: tuple, dm) -> str:
    """The dim of `dm` whose process group has these global ranks."""
    return next(d for d in dm.mesh_dim_names
                if tuple(dist.get_process_group_ranks(dm.get_group(d)))
                == tuple(ranks))


@contextlib.contextmanager
def _recorded_choices():
    """A list that gets each of this rank's MoE calls' router choices
    (its local groups), in call order, while `repro_torch.models.mlp.
    _top_indices` is wrapped."""
    from repro_torch.models import mlp

    calls = []
    real = mlp._top_indices

    def top(probs, k):
        ids = real(probs, k)
        calls.append(ids.numpy().copy())
        return ids
    mlp._top_indices = top
    try:
        yield calls
    finally:
        mlp._top_indices = real


def tree_names(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts and lists, each path its keys and
    indices joined by "/" (the block cases' names for their arrays)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(tree_names(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _filled(tree, arrays, prefix: str):
    """`tree` with every leaf replaced by `arrays[prefix/path]`."""
    if isinstance(tree, dict):
        return {k: _filled(v, arrays, f"{prefix}/{k}") for k, v in
                tree.items()}
    if isinstance(tree, list):
        return [_filled(v, arrays, f"{prefix}/{i}") for i, v in
                enumerate(tree)]
    return torch.from_numpy(arrays[prefix].copy())


def _block_case(case: str, payload: dict) -> dict:
    """One block case of `tests/test_torch_sharded_launch.py` at mesh (1, 2,
    2) on this process group's four ranks, in float32: the parameters
    (named arrays of the payload's file, placed by their specs) and the
    input as DTensors under the sharding rules, the block's output (or the
    loss) and the gradients of sum(out * w) (or of the loss), each
    gathered whole. MoE cases also return this rank's router choices."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.compress import prng
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import grad_fn
    from repro_torch.models import attention, mlp, registry, ssm, transformer
    from repro_torch.models.common import split_axes
    from repro_torch.runtime import sharding as sh

    arch, kind = payload["cases"][case]
    arrays = np.load(payload["path"])
    cfg = dataclasses.replace(registry.get_config(arch, "smoke"),
                              dtype=torch.float32)
    mesh = make_mesh((1, 2, 2), ("pod", "data", "model"), device="cpu",
                     group=dist.group.WORLD)
    dm = mesh.shard_mesh

    def placed(t, axes):
        return distribute_tensor(t, dm, sh.to_placements(
            sh.spec_for(t, axes, sh.DEFAULT_RULES, mesh), dm))

    key = prng.key(0, "cpu")
    if kind == "loss":
        prm, axes = transformer.init(key, cfg)
    else:
        init = {"moe": mlp.moe_init, "mla": attention.mla_init,
                "mamba1": ssm.mamba1_init}[kind]
        prm, axes = split_axes(init(key, cfg))
    prm = _filled(prm, arrays, f"{case}/params")
    prm = _pytree.tree_map(placed, prm, axes)
    out = {}
    with sh.use_rules(sh.DEFAULT_RULES, mesh):
        if kind == "loss":
            batch = {k: placed(torch.from_numpy(arrays[f"{case}/{k}"].copy()),
                               ("batch", None, None)[:arrays[
                                   f"{case}/{k}"].ndim])
                     for k in ("tokens", "labels", "enc")}
            loss, grads = grad_fn(prm, batch, cfg)
            out["loss"] = float(loss)
        else:
            x = placed(torch.from_numpy(arrays[f"{case}/x"].copy()),
                       ("batch", "seq_sp", "embed_act")).requires_grad_()
            leaves, spec = _pytree.tree_flatten(prm)
            leaves = [t.detach().requires_grad_() for t in leaves]
            block = _pytree.tree_unflatten(leaves, spec)
            # plain positions and rope tables beside DTensors, forward and
            # backward, as the launcher's steps run a block
            with implicit_replication():
                if kind == "moe":
                    with _recorded_choices() as choices:
                        y = mlp.moe_apply(sh.gather_axis(block), x, cfg,
                                          groups=2)
                    out["choices"] = [c.tolist() for c in choices]
                elif kind == "mamba1":  # rows over data, channels over model
                    y = ssm.mamba1_apply(sh.gather_axis(block), x, cfg)
                else:
                    S = x.shape[1]
                    y = attention.mla_apply(sh.gather_axis(block), x, cfg,
                                            torch.arange(S).expand(x.shape[0],
                                                                   S))
                w = distribute_tensor(torch.from_numpy(
                    arrays[f"{case}/w"].copy()), dm, y.placements)
                got = torch.autograd.grad((y * w).sum(), leaves + [x])
            got = [g.redistribute(t.device_mesh, t.placements)
                   for g, t in zip(got, leaves + [x])]
            out["out"] = y.full_tensor().detach().numpy()
            out["x"] = got[-1].full_tensor().numpy()
            grads = _pytree.tree_unflatten(got[:-1], spec)
    out["grads"] = {k: v.full_tensor().numpy()
                    for k, v in tree_names(grads).items()}
    return out


def sgd_run(mesh) -> list:
    """llama3-8b smoke through `train_consensus_lm` with SGD without
    momentum (no optimizer state), T = 4, periodic h = 2: its losses."""
    from repro_torch import optim
    from repro_torch.core.schedules import Periodic
    from repro_torch.launch.train import train_consensus_lm
    from repro_torch.models import registry

    return train_consensus_lm(
        registry.get_config("llama3-8b", "smoke"),
        optim.sgd(optim.cosine_lr(3e-2, 4)), mesh, steps=4,
        schedule=Periodic(h=2), batch_per_node=2, seq_len=32, seed=0,
        log_every=0).losses


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


# ---------------------------------------------------------------------------
# sharded inference (tests/test_torch_sharded_decode.py)
# ---------------------------------------------------------------------------


def _fill_cross(cache, params, cfg, enc) -> None:
    """Each cross-attention repetition's encoder K and V from `enc`, in
    place (the reference's `_prefill_cross_cache`)."""
    for i, kind in enumerate(cfg.superblock):
        if kind == "cross_attn":
            prm = params["stack"][f"slot{i}"]["attn"]
            c = cache["stack"][f"slot{i}"]
            for j in range(cfg.n_super):
                c["ek"][j].copy_(torch.einsum("bne,ehk->bnhk", enc,
                                              prm["wk"][j]).to(c["ek"].dtype))
                c["ev"][j].copy_(torch.einsum("bne,ehk->bnhk", enc,
                                              prm["wv"][j]).to(c["ev"].dtype))


def _serve_mesh(axes, shape):
    from repro_torch.launch.mesh import make_serve_mesh

    return make_serve_mesh(tuple(shape), tuple(axes), device="cpu",
                           group=dist.group.WORLD)


def _placement_names(t) -> list:
    """A DTensor's placements as "S<dim>" (a shard) or "R"."""
    return [f"S{p.dim}" if p.is_shard() else "R" for p in t.placements]


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def _serve_case(rank, payload, case) -> dict:
    """One case of the sharded inference test: the payload's float32
    parameters, tokens (and encoder states) placed by `serve_placements`
    on the case's serving mesh; the prefill step at S, then S
    teacher-forced serve steps from position 0 over a float32 cache of
    max_seq S (pos an int at even steps, a 0-d tensor at odd ones), the
    collectives of one step recorded. Every rank returns its digests;
    rank 0 the whole arrays too."""
    import dataclasses

    from repro_torch.compress import prng
    from repro_torch.launch import specs as sp
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import CollectiveBytes
    from repro_torch.models import registry, transformer
    from repro_torch.runtime import sharding as sh

    arch, axes, shape = payload["cases"][case]
    arrays = np.load(payload["path"])
    cfg = dataclasses.replace(registry.get_config(arch, "smoke"),
                              dtype=torch.float32)
    mesh = _serve_mesh(axes, shape)
    dm = mesh.device_mesh
    tokens = torch.from_numpy(arrays[f"{arch}/tokens"].copy())
    B, S = tokens.shape
    params = _filled(transformer.init(prng.key(0, "meta"), cfg)[0], arrays,
                     f"{arch}/params")
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["enc"] = torch.from_numpy(arrays[f"{arch}/enc"].copy())
    pl = sp.serve_placements(cfg, mesh, B, S, S)
    cache = transformer.init_cache(cfg, B, S, torch.float32, device="cpu")
    if "enc" in batch:
        _fill_cross(cache, params, cfg, batch["enc"])
    d_params = sh.place(params, pl["params"], dm)
    d_batch = sh.place(batch, {k: pl["batch"][k] for k in batch}, dm)
    d_cache = sh.place(cache, pl["cache"], dm)
    del params, cache
    moe_groups = dict(zip(axes, shape)).get("data", 1) if cfg.moe_experts \
        else 1
    prefill = steps.make_prefill_step(cfg, moe_groups, mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    out = {"prefill": prefill(d_params, d_batch).full_tensor()}
    logits = []
    record = payload["record_pos"]
    for pos in range(S):
        tok = sh.cut(tokens[:, pos:pos + 1], dm, pl["tokens"])
        at = torch.tensor(pos, dtype=torch.int32) if pos % 2 else pos
        if pos == record:
            seen = CollectiveBytes()
            with seen:
                step_logits, d_cache = serve(d_params, d_cache, tok, at)
            out["collectives"] = seen.bytes
            out["gathered_shapes"] = [shape for shape, _, _ in seen.gathered]
        else:
            step_logits, d_cache = serve(d_params, d_cache, tok, at)
        logits.append(step_logits.full_tensor()[:, 0])
    out["logits"] = torch.stack(logits, dim=1)
    out["logits_placements"] = _placement_names(step_logits)
    out["cache"] = {k: v.full_tensor()
                    for k, v in tree_names(d_cache).items()}
    out["cache_shard_bytes"] = sum(
        v.to_local().numel() * v.to_local().element_size()
        for v in tree_names(d_cache).values())
    # each leaf's local shard, and a stacked leaf's per-layer view of it
    out["cache_shard_shapes"] = [
        list(shape) for name, v in tree_names(d_cache).items()
        for shape in ((v.to_local().shape, v.to_local().shape[1:])
                      if name.startswith("stack/") else
                      (v.to_local().shape,))]
    out["cache_placements"] = {k: _placement_names(v)
                               for k, v in tree_names(d_cache).items()}
    out["param_shard_shapes"] = _param_shard_shapes(d_params)
    digests = {"prefill": _digest(out["prefill"]),
               "logits": _digest(out["logits"]),
               "cache": {k: _digest(v) for k, v in out["cache"].items()}}
    keep = {k: v for k, v in out.items() if k not in ("prefill", "logits",
                                                       "cache")}
    keep["digests"] = digests
    if rank == 0:
        keep.update({"prefill": out["prefill"].numpy(),
                     "logits": out["logits"].numpy(),
                     "cache": {k: v.numpy() for k, v in out["cache"].items()}})
    return keep


def _merged(shape: tuple) -> list:
    """`shape` and every shape that merges adjacent dims of it (the views
    an einsum may take of a tensor before it is gathered)."""
    if len(shape) <= 1:
        return [tuple(shape)]
    out = []
    for rest in _merged(shape[1:]):
        out.append((shape[0],) + rest)
        out.append((shape[0] * rest[0],) + rest[1:])
    return out


def _param_shard_shapes(d_params) -> list:
    """The shapes of the sharded parameters' local shards (a stacked
    leaf's per-layer view of it too), each with its merged views."""
    shapes = set()
    for name, v in tree_names(d_params).items():
        if not any(pl.is_shard() and v.device_mesh.size(d) > 1
                   for d, pl in enumerate(v.placements)):
            continue
        local = tuple(v.to_local().shape)
        for shape in ((local, local[1:]) if name.startswith("stack/")
                      else (local,)):
            shapes.update(_merged(shape))
    return sorted(list(s) for s in shapes)


def _gate_case(arch: str, axes, shape, path: str) -> dict:
    """The reference's decode gate (tests/test_models.py
    test_decode_matches_forward) with the decode on the sharded path:
    bf16 weights from the port's init, the gate's tokens and encoder
    states (the payload's file), a float32 cache of the tokens' length, a
    drop-free MoE capacity; the teacher-forced forward's logits on the
    whole parameters, the sharded serve steps' (gathered) beside them."""
    import dataclasses

    from repro_torch.compress import prng
    from repro_torch.launch import specs as sp
    from repro_torch.launch import steps
    from repro_torch.models import registry, transformer
    from repro_torch.runtime import sharding as sh

    cfg = dataclasses.replace(registry.get_config(arch, "smoke"),
                              dtype=torch.bfloat16)
    if cfg.moe_experts:
        cfg = dataclasses.replace(cfg,
                                  moe_capacity_factor=float(cfg.moe_experts))
    params = transformer.init(prng.key(0, "cpu"), cfg)[0]
    arrays = np.load(path)
    tokens = torch.from_numpy(arrays[f"gate/{arch}/tokens"].copy())
    B, S = tokens.shape
    enc = None
    if cfg.family == "vlm":
        enc = torch.from_numpy(arrays[f"gate/{arch}/enc"].copy()).to(
            cfg.dtype)
    with torch.no_grad():
        full = transformer.forward(params, tokens, cfg, enc=enc).float()
    mesh = _serve_mesh(axes, shape)
    dm = mesh.device_mesh
    pl = sp.serve_placements(cfg, mesh, B, S, S)
    cache = transformer.init_cache(cfg, B, S, torch.float32, device="cpu")
    if enc is not None:
        _fill_cross(cache, params, cfg, enc)
    d_params = sh.place(params, pl["params"], dm)
    d_cache = sh.place(cache, pl["cache"], dm)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    outs = []
    for pos in range(S):
        tok = sh.cut(tokens[:, pos:pos + 1], dm, pl["tokens"])
        step_logits, d_cache = serve(d_params, d_cache, tok, pos)
        outs.append(step_logits.full_tensor()[:, 0].float())
    return {"decode": torch.stack(outs, dim=1).numpy(),
            "forward": full.numpy()}


def _write_case(axes, shape) -> dict:
    """`_write_at` into a sequence-sharded DTensor cache (B, T, C): every
    position written once, by an int `pos` and by a 0-d tensor, against
    the same writes into a plain cache; each rank's local shard against
    its slice of the plain one."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.attention import _write_at
    from repro_torch.runtime import sharding as sh

    mesh = _serve_mesh(axes, shape)
    dm = mesh.device_mesh
    B, T, C = 4, 8, 3
    pl = (Shard(0), Shard(1))
    gen = torch.Generator().manual_seed(5)
    values = torch.randn((T, B, 1, C), generator=gen)
    out = {}
    for form in ("int", "tensor"):
        plain = torch.zeros((B, T, C))
        cache = sh.cut(torch.zeros((B, T, C)), dm, pl)
        for pos in range(T):
            at = pos if form == "int" else torch.tensor(pos)
            _write_at(plain, at, values[pos])
            value = sh.cut(values[pos], dm, (Shard(0), Replicate()))
            assert _write_at(cache, at, value) is cache
        out[form] = {"equal": bool(torch.equal(cache.full_tensor(), plain)),
                     "local": bool(torch.equal(
                         cache.to_local(), sh.cut(plain, dm, pl).to_local()))}
    return out


def serving(rank, n, payload):
    """The sharded inference cases, the decode gate and the write case on
    this process group's ranks (`tests/test_torch_sharded_decode.py`)."""
    out = {"cases": {}, "gate": {}}
    for case in payload["cases"]:
        out["cases"][case] = _serve_case(rank, payload, case)
    for arch in payload["gate"]["archs"]:
        gate = _gate_case(arch, *payload["gate"]["mesh"], payload["path"])
        out["gate"][arch] = gate if rank == 0 else None
    out["write"] = _write_case(*payload["gate"]["mesh"])
    return out


# ---------------------------------------------------------------------------
# a rank's own query rows and the loss on vocab shards
# (tests/test_torch_attention_memory.py)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded_rows(module, names, rows: list):
    """Each of `module`'s functions `names` wrapped to append its first
    argument's rows (dim 1) to `rows` while the context lasts."""
    saved = {name: getattr(module, name) for name in names}

    def recording(fn):
        def wrapped(q, *args):
            rows.append(q.shape[1])
            return fn(q, *args)
        return wrapped
    try:
        for name, fn in saved.items():
            setattr(module, name, recording(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _attention_case(dm, case: dict) -> dict:
    """One attention case on the mesh `dm` (data 1, model n): q (B, S, H,
    hd) sequence-parallel over 'model', k and v (B, T, 1, hd) over their
    head dim (the constraints' layout where one kv head does not divide
    the axis); the core's local query rows, the output's placements, the
    all-gathers' inputs, the output and the gradients of q, k and v for
    the cotangent g, each whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.dryrun import CollectiveBytes
    from repro_torch.models import attention

    q, k, v, g = (torch.from_numpy(case[n]) for n in "qkvg")
    seq, head = [Replicate(), Shard(1)], [Replicate(), Shard(3)]
    qd = distribute_tensor(q, dm, seq).requires_grad_()
    kd, vd = (distribute_tensor(t, dm, head).requires_grad_()
              for t in (k, v))
    gd = distribute_tensor(g, dm, seq)
    rows: list = []
    counted = CollectiveBytes()
    if case["kind"] == "causal":
        cores = ("_sdpa_causal_streamed", "_sdpa_causal_whole")
        with _recorded_rows(attention, cores, rows), counted:
            out = attention._sdpa_causal(qd, kd, vd)
            out.backward(gd)
    else:
        with _recorded_rows(attention, ("_cross_softmax",), rows), counted:
            out = attention._on_local_heads(attention._cross_softmax, qd,
                                            kd, vd, torch.float32)
            out.backward(gd)
    return {"rows": rows, "placements": _placement_names(out),
            "gathered": [shape for shape, _, _ in counted.gathered],
            "out": out.full_tensor().detach().numpy(),
            "grads": [t.grad.full_tensor().numpy() for t in (qd, kd, vd)]}


def _loss_case(dm, case: dict) -> dict:
    """`cross_entropy_loss` of logits (B, S, V) sharded over their vocab
    on 'model' (rows replicated over 'data') and labels replicated: the
    loss and the gradient of the logits, whole, and the gradient's
    placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.common import cross_entropy_loss

    logits = distribute_tensor(torch.from_numpy(case["logits"]), dm,
                               [Replicate(), Shard(2)]).requires_grad_()
    labels = distribute_tensor(torch.from_numpy(case["labels"]), dm,
                               [Replicate(), Replicate()])
    loss = cross_entropy_loss(logits, labels)
    loss.backward()
    return {"loss": loss.full_tensor().detach().numpy(),
            "grad": logits.grad.full_tensor().numpy(),
            "grad_placements": _placement_names(logits.grad)}


def attention_rows(rank, n, payload):
    """The payload's attention and loss cases on a (data 1, model n) mesh
    of this process group's ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh("cpu", torch.arange(n).reshape(1, n),
                    mesh_dim_names=("data", "model"))
    return {"attention": {name: _attention_case(dm, case) for name, case
                          in payload.get("attention", {}).items()},
            "loss": _loss_case(dm, payload["loss"])}
