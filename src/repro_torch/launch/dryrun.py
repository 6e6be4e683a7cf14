"""Multi-pod dry-run, the port of `repro.launch.dryrun`: every (architecture
x input-shape x mesh) cell's step arguments built on the production mesh's
layout, and their per-device bytes reckoned from the logical sharding
rules.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only]

The reference lowers and compiles each cell for 512 placeholder devices
and records XLA's memory and cost analyses. Torch compiles nothing ahead
of a run, so the port builds the same arguments as meta tensors beside
their specs (`launch/specs.py`) and reckons:

  * `memory.argument_size_in_bytes`: each argument leaf's per-device shard
    bytes under its spec, summed over the leaves the step reads (found by
    running the step on the meta tensors: jit leaves an unread argument
    out, such as the prefill batch's `labels`);
  * `output_size_in_bytes` and `alias_size_in_bytes` from the same sums
    (outputs under the specs of the arguments they update, the metrics
    and logits as the port lays them; donation aliases the training state
    and the decode cache, as in the reference);
  * `temp_size_in_bytes` and `generated_code_size_in_bytes`: null, since
    torch has no compile-time memory analysis, so `bytes_per_device` is
    arguments plus unaliased outputs, without temporaries;
  * `cost.flops`: one pod's step counted by `FlopCounterMode` on the meta
    tensors (matmuls and convolutions; XLA also counts elementwise work),
    divided over the devices that run it;
  * `collectives`: rank 0's collectives in one pod's step, counted as
    they run: the step runs as DTensors on meta tensors placed by the
    reference's shardings (training: `specs.train_placements`' specs and
    `cfg.train_microbatches`; prefill and decode: `serve_placements`'
    under `serve_rules`), on the layout's DeviceMesh over a placeholder
    process group of its size (torch's "fake" backend: no
    communication; a "cuda" DeviceMesh, so DTensor picks the
    collectives it issues on the cards), and a dispatch mode adds each
    collective's output bytes on rank 0 under the reference's kinds
    (`all-gather`, `all-reduce`, `reduce-scatter`, `all-to-all`,
    `collective-permute`, as its `collective_bytes` reads them off the
    partitioned HLO): an all-gather's output is its input times the
    group's size, a reduce-scatter's its input over it. The step runs at
    1 and 2 superblocks and the bytes extend linearly to `cfg.n_super`,
    as the flops do. On the multi-pod mesh the pods serve replicas, so
    rank 0 runs its pod's share of a serving batch (a training pod its
    own batch); beside the kinds, `pod_mix`, the port's own name for the
    consensus mix: the fused step's float32 mix of each device's
    parameter shard, one all-reduce on the complete graph (k exchanges
    on a k-regular one), bytes per device per comm round. XLA counts a
    collective inside a loop once as the HLO text holds it; the port
    counts every one that runs. `hlo_collective_op_counts` is null (no
    HLO);
  * `sharding_refusals`, the port's own: the ops on DTensors in the same
    DTensor runs that torch 2.11's DTensor refuses (`refused_sharding`),
    extended as the bytes are. A cell with any is on the CLI's FAILURES
    line, whatever torch runs it, so a newer torch that carries those
    ops through still finds the fault.

`lower_s` is the seconds spent building the arguments and specs, and
`compile_s` the seconds of the meta runs (both the plain and the DTensor
one). The placeholder group is made for the cell and destroyed on the
way out; `dryrun_cell` refuses to run beside a default process group.
Writes one JSON per cell under results/dryrun_torch/.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist
import torch.utils._pytree as _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.graphs import complete_graph
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_shape
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import registry
from repro_torch.optim import adamw, cosine_lr
from repro_torch.runtime import sharding as shrules

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")

PyTree = Any


class _Reads(TorchDispatchMode):
    """Records which of the given tensors an op takes as an input."""

    def __init__(self, tensors):
        super().__init__()
        self.ids = {id(t) for t in tensors}
        self.read: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in _pytree.tree_leaves((args, kwargs)):
            if isinstance(a, torch.Tensor) and id(a) in self.ids:
                self.read.add(id(a))
        return func(*args, **kwargs)


def _leaves(tree: PyTree) -> list:
    return [t for t in _pytree.tree_leaves(tree) if t is not None]


def _specs(specs: PyTree) -> list:
    return [s for s in sp.spec_leaves(specs) if s is not None]


def _meta_run(step, args: tuple) -> tuple[float, set[int]]:
    """(flops, ids of the argument leaves read) of one call of `step` on
    meta tensors."""
    reads = _Reads(_leaves(args))
    with FlopCounterMode(display=False) as counter, reads:
        step(*args)
    return float(counter.get_total_flops()), reads.read


#: the reference's collective kinds (its `collective_bytes` keys)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
#: (namespace, op) of the collectives a step issues, by kind: the
#: functional collectives, DTensor's shard-to-shard all-to-all, and c10d's
#: own (the pod mix's all-reduce and its point-to-point exchanges, which
#: are XLA's collective-permute)
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}
#: ops of those namespaces that move no data
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "barrier")


#: the view ops a reshape or flatten of a DTensor reaches
_VIEWS = ("view", "_unsafe_view", "reshape")


def _view_groups(src, dst) -> list[list[int]]:
    """The input dims of a view from shape `src` to `dst` that meet in one
    output dim, one list per output group of more than one input dim of
    size above 1 (a flatten, or a flatten then split): the groups whose
    sizes' products match, as DTensor's `view_groups` forms them."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        if src[i] == 1 and dst[j] != 1:
            i += 1
            continue
        if dst[j] == 1 and src[i] != 1:
            j += 1
            continue
        ins, a, b = [i], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                ins.append(i)
                a *= src[i]
                i += 1
            else:
                b *= dst[j]
                j += 1
        ins = [d for d in ins if src[d] != 1]
        if len(ins) > 1:
            groups.append(ins)
    return groups


def refused_sharding(func, args, kwargs) -> str | None:
    """Why torch 2.11's DTensor refuses the op `func` on these DTensor
    arguments, or None. It refuses three patterns that later versions
    carry through `_StridedShard`: a view that merges two dims sharded
    over mesh dims of more than one rank, or merges a group of dims whose
    sharded dim is not its outermost; any op taking a `_StridedShard`
    placement (what such a view gives); and `constant_pad_nd` of a
    DTensor (its redistribute planner fails there)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    name = func.__name__.split(".")[0]
    tensors = [a for a in _pytree.tree_leaves((args, kwargs or {}))
               if isinstance(a, DTensor)]
    for t in tensors:
        if any(isinstance(pl, _StridedShard) for pl in t.placements):
            return f"{func} takes {tuple(t.placements)}"
    if name == "constant_pad_nd" and tensors:
        return f"{func} pads a DTensor {tuple(tensors[0].placements)}"
    if name not in _VIEWS or not isinstance(args[0], DTensor):
        return None
    x = args[0]
    mesh = x.device_mesh
    sharded = {pl.dim for m, pl in enumerate(x.placements)
               if pl.is_shard() and mesh.size(m) > 1}
    dst = list(args[1])
    if -1 in dst:
        known = 1
        for n in dst:
            known *= n if n != -1 else 1
        dst[dst.index(-1)] = x.numel() // known
    for group in _view_groups(list(x.shape), dst):
        hit = [d for d in group if d in sharded]
        if len(hit) > 1 or (hit and hit[0] != group[0]):
            return (f"{func} merges dims {group} of {tuple(x.shape)} "
                    f"{tuple(x.placements)} into {tuple(dst)}")
    return None


class CollectiveBytes(TorchDispatchMode):
    """Output bytes on this rank of the collectives the ops issue while
    active, by the reference's kinds (`bytes`) and by kind and process
    group (`by_group`, the group's global ranks), and each all-gather's
    input as (shape, dtype, the group's ranks) (`gathered`): the
    functional collectives (DTensor's redistributions, those inside an
    op's dispatch included, the microbatches' all-to-all, the sharded grad
    norm's all-reduce),
    DTensor's shard-to-shard all-to-all and c10d's own (a c10d op's output
    is the tensors it fills: a send's bytes are counted where they are
    received). Any other op of those namespaces raises: no collective goes
    uncounted.

    It also lists the ops on DTensors that torch 2.11 refuses
    (`refused`, `refused_sharding`'s reasons): a mode sees an op on
    DTensors only when it is the innermost, and this one is, since it
    hands such ops to DTensor's dispatch."""

    def __init__(self):
        from torch.distributed.tensor import DTensor

        super().__init__()
        self.bytes: dict[str, float] = {}
        self.by_group: dict[tuple[str, tuple[int, ...]], float] = {}
        self.gathered: list[tuple[list[int], str, tuple[int, ...]]] = []
        self.refused: list[str] = []
        self._dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            why = refused_sharding(func, args, kwargs)
            if why is not None:
                self.refused.append(why)
            # DTensor's own dispatch runs the op, and the collectives it
            # issues to redistribute the inputs come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace not in ("_c10d_functional", "_dtensor", "c10d"):
            return out
        name = func.__name__.split(".")[0]
        if name in _NOT_COLLECTIVES:
            return out
        kind = _COLLECTIVE_OPS.get((func.namespace, name))
        if kind is None:
            raise RuntimeError(f"the dry-run counts no collective {func}")
        c10d = func.namespace == "c10d"
        filled = () if name == "send" else args[0] if c10d else out
        n = float(sum(t.numel() * t.element_size()
                      for t in _pytree.tree_leaves(filled)
                      if isinstance(t, torch.Tensor)))
        group = _group_ranks(func, args, kwargs)
        self.bytes[kind] = self.bytes.get(kind, 0.0) + n
        self.by_group[kind, group] = self.by_group.get((kind, group),
                                                       0.0) + n
        if kind == "all-gather":
            given = args[1] if c10d else args[0]
            self.gathered.extend(
                (list(t.shape), str(t.dtype), group)
                for t in _pytree.tree_leaves(given)
                if isinstance(t, torch.Tensor))
        return out


def _group_ranks(func, args, kwargs) -> tuple[int, ...]:
    """The global ranks of the process group a collective runs over (by
    ranks, not by name: DTensor's sharding cache may hand back an earlier
    DeviceMesh equal to the tensors' own, whose groups have the same ranks
    under other names): a functional collective's group is named by its
    last string argument, a c10d op's is an argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    if func.namespace == "c10d":
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:  # the group, not the reduce op or the options
                    group = dist.ProcessGroup.unbox(a)
                except (AttributeError, RuntimeError):
                    continue
                return tuple(dist.get_process_group_ranks(group))
        return ()
    names = [a for a in (*args, *(kwargs or {}).values())
             if isinstance(a, str)]
    return tuple(dist.get_process_group_ranks(
        _resolve_process_group(names[-1]))) if names else ()


@contextlib.contextmanager
def placeholder_group(world: int):
    """This process as rank 0 of a placeholder process group of `world`
    ranks (torch's "fake" backend: a DeviceMesh over it places DTensors
    and issues their collectives, which move nothing), the default group
    while the context lasts, destroyed on the way out. Raises when a
    default group exists already or the backend is missing."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own placeholder process "
                           "group, and a default process group exists "
                           "already")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("torch's placeholder process group (the 'fake' "
                           "backend, torch.testing._internal.distributed."
                           "fake_pg) is missing: the dry-run cannot count "
                           "its collectives") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _placed(t: torch.Tensor, spec: tuple, dm):
    """A meta DTensor of `t`'s shape placed by `spec` on `dm`: its local
    tensor the shard of rank 0 of the group (coordinates on `dm`)."""
    from torch.distributed.tensor import DTensor

    pl = shrules.to_placements(spec, dm)
    block = shrules.local_block(t.shape, pl, dm.shape, dm.get_coordinate())
    local = torch.empty(tuple(n for _, n in block), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, dm, pl, run_check=False, shape=t.shape,
                              stride=t.stride())


def _pod_rows(cell: ShapeCell, pods: int, data: int) -> int:
    """The rows of a batch one pod's ranks hold: a training pod's own
    batch; a serving batch split over (pod, data) where its rows divide,
    else whole on every pod."""
    B = cell.global_batch
    if cell.kind == "train" or pods == 1:
        return B // pods
    rows = B // pods if B % (pods * data) == 0 else B
    if (rows % data == 0) != (B % (pods * data) == 0):
        raise ValueError(f"{cell.name}: {B} rows over {pods} serving pods "
                         f"of {data} data ranks place otherwise on one pod")
    return rows


def count_step(cfg, cell: ShapeCell, mesh, optimizer) -> CollectiveBytes:
    """Rank 0's collectives in one pod's step as meta DTensors on
    `mesh.shard_mesh` (a mesh whose DeviceMesh stands on a placeholder
    group), the step's arguments placed by the specs of one pod's (data,
    model) layout at the pod's rows (`_pod_rows`)."""
    sizes = mesh_shape(mesh)
    single = Mesh(("data", "model"), (sizes["data"], sizes["model"]),
                  torch.device("meta"))
    rows = _pod_rows(cell, sizes.get("pod", 1), sizes["data"])
    built = _cell_args(cfg, dataclasses.replace(cell, global_batch=rows),
                       single, False, optimizer)
    dm = mesh.shard_mesh
    flat, treedef = _pytree.tree_flatten(built["args"])
    args = _pytree.tree_unflatten(
        [None if t is None else _placed(t, s, dm)
         for t, s in zip(flat, sp.spec_leaves(built["specs"]))], treedef)
    rules = (shrules.DEFAULT_RULES if cell.kind == "train"
             else sp.serve_rules(single))
    counted = CollectiveBytes()
    with shrules.use_rules(rules, single), counted:
        built["step"](*args)
    return counted


def pod_mix_bytes(param_shard_bytes_f32: int, graph) -> int:
    """Bytes a device ships per comm round in the pod mix: one all-reduce
    of its parameter shard on the complete graph, k exchanges of it on a
    k-regular graph."""
    rounds = 1 if graph.name == "complete" else graph.degree
    return rounds * param_shard_bytes_f32


def _cell_args(cfg, cell: ShapeCell, mesh, multi_pod: bool,
               optimizer) -> dict:
    """A cell's step, its arguments on the meta device beside their specs
    (pod-stacked on the multi-pod mesh for training), the arguments of one
    pod's call of the step, and the devices that call runs on."""
    sizes = mesh_shape(mesh)
    moe_groups = sizes["data"] if cfg.moe_experts else 1
    params, pspecs = sp.param_specs(cfg, mesh)
    out = {"params": params, "pspecs": pspecs, "run_devices": mesh.size}
    if cell.kind == "train":
        state, sspecs = sp.opt_state_specs(optimizer, params, pspecs)
        batch, bspecs = sp.batch_specs(cfg, cell, mesh, consensus=multi_pod)
        out["step"] = make_train_step(cfg, optimizer, moe_groups=moe_groups,
                                      microbatches=cfg.train_microbatches)
        if multi_pod:  # consensus: one pod's step on its slice
            n_pods = sizes["pod"]
            out["pod_args"] = (params, state,
                               {k: v[0] for k, v in batch.items()})
            params, pspecs = sp.pod_stack_specs(params, pspecs, n_pods)
            state, sspecs = sp.pod_stack_specs(state, sspecs, n_pods)
            out["run_devices"] = mesh.size // n_pods
        out["args"] = (params, state, batch)
        out["specs"] = (pspecs, sspecs, bspecs)
    elif cell.kind == "prefill":
        batch, bspecs = sp.batch_specs(cfg, cell, mesh, consensus=False)
        out["step"] = make_prefill_step(cfg, moe_groups=moe_groups)
        out["args"], out["specs"] = (params, batch), (pspecs, bspecs)
    else:  # decode
        cache, cspecs = sp.cache_specs(cfg, cell, mesh)
        toks, tspecs = sp.decode_token_specs(cell, mesh)
        out["step"] = make_serve_step(cfg, moe_groups=1)
        out["args"] = (params, cache, toks["tokens"], toks["pos"])
        out["specs"] = (pspecs, cspecs, tspecs["tokens"], tspecs["pos"])
    out.setdefault("pod_args", out["args"])
    return out


def _meta_runs(cfg, cell: ShapeCell, mesh, multi_pod: bool, optimizer
               ) -> tuple[float, list, dict, int]:
    """(flops of one pod's step, which of its argument leaves it reads, by
    position, rank 0's collective output bytes by kind, the ops on
    DTensors torch 2.11 refuses). The superblock repetitions are identical
    work, so the step runs on meta at 1 and 2 repetitions, plainly for the
    flops and the reads and as DTensors on `mesh.shard_mesh` for the
    collectives and the refusals, and the counts extend linearly to
    `cfg.n_super`, exactly; the leaves read are the same at any depth."""
    runs = []
    for n in ((1, 2) if cfg.n_super > 2 else (cfg.n_super,)):
        part_cfg = dataclasses.replace(cfg, n_super=n)
        part = _cell_args(part_cfg, cell, mesh, multi_pod, optimizer)
        flops, read = _meta_run(part["step"], part["pod_args"])
        counted = count_step(part_cfg, cell, mesh, optimizer)
        runs.append((flops, [[id(t) in read for t in _leaves(a)]
                             for a in part["pod_args"]],
                     counted.bytes, len(counted.refused)))
    flops, read, coll, refused = runs[0]
    if len(runs) == 2:
        flops += (cfg.n_super - 1) * (runs[1][0] - flops)
        refused += (cfg.n_super - 1) * (runs[1][3] - refused)
        coll = {k: coll.get(k, 0.0) + (cfg.n_super - 1) * (
            runs[1][2].get(k, 0.0) - coll.get(k, 0.0))
            for k in KINDS if k in coll or k in runs[1][2]}
    return flops, read, coll, refused


def dryrun_cell(arch: str, cell: ShapeCell, multi_pod: bool,
                *, save: bool = True, donate: bool = True,
                verbose: bool = True, cfg_override=None) -> dict:
    """Build one (arch, shape, mesh) cell on meta tensors, reckon its
    per-device bytes and count rank 0's collectives (over a placeholder
    process group made and destroyed here: it raises beside a default
    process group); return the record."""
    cfg = cfg_override or registry.get_config(arch, "full")
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    sizes = mesh_shape(mesh)
    rec: dict[str, Any] = {"arch": arch, "shape": cell.name,
                           "mesh": mesh_name, "kind": cell.kind,
                           "seq_len": cell.seq_len,
                           "global_batch": cell.global_batch}
    t0 = time.time()
    optimizer = adamw(cosine_lr(3e-4, 10000),
                      moment_dtype=(torch.bfloat16 if cfg.opt_moments_bf16
                                    else torch.float32))
    built = _cell_args(cfg, cell, mesh, multi_pod, optimizer)
    args, specs = built["args"], [_specs(s) for s in built["specs"]]
    leaves = [_leaves(a) for a in args]
    rec["lower_s"] = round(time.time() - t0, 1)

    t1 = time.time()
    with placeholder_group(mesh.size) as group:
        flops, read, collectives, refused = _meta_runs(
            cfg, cell, make_production_mesh(multi_pod=multi_pod, group=group),
            multi_pod, optimizer)
    rec["compile_s"] = round(time.time() - t1, 1)

    def total(i, only_read=False):
        return sum(sp.shard_bytes(t, s, mesh) for t, s, r in
                   zip(leaves[i], specs[i], read[i]) if r or not only_read)

    arg_bytes = sum(total(i, only_read=True) for i in range(len(args)))
    if cell.kind == "train":
        state_bytes = total(0) + total(1)
        n_metrics = sizes["pod"] if multi_pod else 1
        out_bytes = state_bytes + 2 * 4 * n_metrics  # loss, grad_norm
        alias_bytes = state_bytes if donate else 0
        if multi_pod:
            # the fused step's float32 mix of each device's parameter shard
            shard_f32 = sum(sp.shard_bytes(t, s, mesh) // t.element_size()
                            * 4 for t, s in zip(_leaves(built["params"]),
                                                _specs(built["pspecs"])))
            collectives["pod_mix"] = float(
                pod_mix_bytes(shard_f32, complete_graph(sizes["pod"])))
    elif cell.kind == "prefill":
        # the last position's logits (B, V), B as the batch is laid out
        B = cell.global_batch
        logits = torch.empty((B, cfg.vocab_size), dtype=cfg.dtype,
                             device="meta")
        out_bytes = sp.shard_bytes(logits, built["specs"][1]["tokens"][:1],
                                   mesh)
        alias_bytes = 0
    else:
        # logits (B, 1, V), B as the tokens are laid out, and the cache
        B = cell.global_batch
        logits = torch.empty((B, 1, cfg.vocab_size), dtype=cfg.dtype,
                             device="meta")
        cache_bytes = total(1)
        out_bytes = cache_bytes + sp.shard_bytes(
            logits, built["specs"][2][:1], mesh)
        alias_bytes = cache_bytes if donate else 0
    rec["memory"] = {"argument_size_in_bytes": float(arg_bytes),
                     "output_size_in_bytes": float(out_bytes),
                     "temp_size_in_bytes": None,
                     "generated_code_size_in_bytes": None,
                     "alias_size_in_bytes": float(alias_bytes)}
    rec["cost"] = {"flops": flops / built["run_devices"]}
    rec["collectives"] = collectives
    rec["hlo_collective_op_counts"] = None
    # the port's own: ops on DTensors torch 2.11 refuses (0 to build there)
    rec["sharding_refusals"] = refused
    rec["bytes_per_device"] = float(arg_bytes
                                    + max(out_bytes - alias_bytes, 0))
    rec["devices"] = mesh.size
    if verbose:
        print(f"[dryrun] {arch} {cell.name} {mesh_name}: "
              f"build {rec['lower_s']}s meta run {rec['compile_s']}s  "
              f"mem/dev {rec['bytes_per_device'] / 2 ** 30:.2f} GiB "
              f"(no temporaries)  flops {rec['cost']['flops']:.3g}  "
              f"refused {refused}", flush=True)
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        fname = RESULTS / f"{arch}__{cell.name}__{mesh_name}.json"
        fname.write_text(json.dumps(rec, indent=1))
    return rec


def dryrun_cell_with_cfg(arch: str, cfg, cell: ShapeCell, multi_pod: bool,
                         *, save: bool = False, verbose: bool = False) -> dict:
    """Probe variant: `cell` under an explicit (modified) config."""
    return dryrun_cell(arch, cell, multi_pod, save=save, verbose=verbose,
                       cfg_override=cfg)


def iter_cells(multi_pod_only=False, arch_filter=None, shape_filter=None):
    for arch in registry.ARCH_IDS:
        if arch_filter and arch != arch_filter:
            continue
        for cell in registry.get_shapes(arch).values():
            if shape_filter and cell.name != shape_filter:
                continue
            if cell.skip:
                yield arch, cell, None
                continue
            meshes = [True] if multi_pod_only else [False, True]
            for mp in meshes:
                yield arch, cell, mp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)

    failures = []
    for arch, cell, mp in iter_cells(args.multi_pod_only, args.arch,
                                     args.shape):
        if mp is None:
            print(f"[dryrun] SKIP {arch} {cell.name}: {cell.skip}")
            continue
        if args.single_pod_only and mp:
            continue
        try:
            rec = dryrun_cell(arch, cell, mp, save=not args.no_save)
        except Exception:  # noqa: BLE001 -- reported, then counted
            failures.append((arch, cell.name, mp))
            traceback.print_exc()
            continue
        if rec["sharding_refusals"]:  # builds here, not on torch 2.11
            print(f"[dryrun] {arch} {cell.name}: {rec['sharding_refusals']} "
                  f"ops on DTensors that torch 2.11 refuses")
            failures.append((arch, cell.name, mp))
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells built OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
