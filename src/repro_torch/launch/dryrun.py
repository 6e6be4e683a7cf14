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
    and the decode cache, as in the reference: the train step overwrites
    the state it is given and the serve step its cache);
  * `temp_size_in_bytes`: rank 0's peak temporaries in one pod's step,
    counted on the DTensor run that counts the collectives (below) by
    `StepMemory`: the most bytes alive at once of the storages rank 0's
    local ops make, a collective's output (a gathered layer, a gathered
    activation) included, leaving out the arguments' storages and the
    ones the step returns. Meta tensors take the card's branches
    (`attention._bmm_f32`). `bytes_per_device` is the reference's
    `argument + temp + max(output - alias, 0)`;
  * `generated_code_size_in_bytes`: null. Torch compiles nothing ahead
    of a run: an eager step launches kernels that ship in its libraries;
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
    2 and 3 superblocks (`DEPTHS`) and the bytes, the calls and the
    temporaries extend linearly to `cfg.n_super`, as the flops do, the
    temporaries phase by phase, but for a train step's tail (its update
    and grad norm follow the largest leaf), which is counted alone at
    `cfg.n_super` (`_meta_runs`, `extended`). On the multi-pod mesh
    the pods serve replicas, so rank 0 runs its pod's share of a serving
    batch (a training pod its own batch); beside the kinds, `pod_mix`,
    the port's own name for the consensus mix: the fused step's float32
    mix of each device's parameter shard, one all-reduce on the complete
    graph (k exchanges on a k-regular one), bytes per device per comm
    round (its float32 copy of a leaf is not in the temporaries). XLA
    counts a collective inside a loop once as the HLO text holds it; the
    port counts every one that runs;
  * `hlo_collective_op_counts`: rank 0's collective calls in that step
    under the reference's five kinds, counted as they run, where XLA's
    HLO text holds a loop body's ops once (the port's training counts are
    per layer and microbatch where XLA's are per loop body);
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
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.shapes import ShapeCell
from repro_torch.core.graphs import complete_graph
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (Mesh, make_production_mesh, mesh_shape,
                                     placed_on)
from repro_torch.launch.steps import (apply_update, make_prefill_step,
                                      make_serve_step, make_train_step)
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


def _bmm_flops(a_shape, b_shape, *_, **__) -> int:
    """`torch.bmm`'s flops, its `out_dtype` overload's too (whose third
    argument torch's own formula takes for the output's shape)."""
    (b, m, k), n = a_shape, b_shape[-1]
    return 2 * b * m * n * k


def _meta_run(step, args: tuple) -> tuple[float, set[int]]:
    """(flops, ids of the argument leaves read) of one call of `step` on
    meta tensors."""
    reads = _Reads(_leaves(args))
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.bmm: _bmm_flops}) as counter, reads:
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
#: those of them whose output is their input on a device (a meta tensor's
#: is a new one)
_ALIASES = ("wait_tensor", "_wrap_tensor_autograd")


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
    group (`by_group`, the group's global ranks), the calls by kind
    (`calls`), and each all-gather's
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
        self.calls: dict[str, int] = {}
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
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.by_group[kind, group] = self.by_group.get((kind, group),
                                                       0.0) + n
        if kind == "all-gather":
            given = args[1] if c10d else args[0]
            self.gathered.extend(
                (list(t.shape), str(t.dtype), group)
                for t in _pytree.tree_leaves(given)
                if isinstance(t, torch.Tensor))
        return out


def _local_leaves(tree: PyTree) -> list:
    """The tensors of `tree`, each DTensor as its local tensor."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepMemory(CollectiveBytes):
    """`CollectiveBytes` that also follows the storages the ops on this
    rank's local tensors make while active, for a step's peak
    temporaries (`finish`). Each output's storage is keyed by its
    StorageImpl (`StorageWeakRef.cdata`: a meta storage has no data
    pointer), so a view is its storage's; a storage seen for the first
    time is born there, and it dies at the first op that finds its weak
    reference `expired()`. The weak references are held to the end, so
    no storage takes a dead one's key. The storages of `args` (a
    DTensor's local tensor's) are not temporaries and are skipped, and
    so are the ops DTensor runs on fake tensors to propagate shapes: they
    allocate nothing on a device. Neither does a functional collective's
    op that returns its input there (`_ALIASES`): its new meta output is
    counted as its input.

    The step's phases are told apart as they run: a phase ends where the
    ops pass into or out of an autograd backward (a training step's
    forward, its backward, then what follows the last microbatch's
    backward), and where `mark` is called (`count_step` marks the train
    step's tail, `steps.apply_update`, whose phase is `tail`);
    `phase_peaks` holds each one's peak, the bytes alive at its fullest
    moment, and `phase_bases` the bytes alive where it starts."""

    def __init__(self, args: PyTree):
        from torch._subclasses.fake_tensor import FakeTensor

        super().__init__()
        self._fake = FakeTensor
        self._refs = [StorageWeakRef(t.untyped_storage())
                      for t in _local_leaves(args)]
        self._args = {ref.cdata for ref in self._refs}
        self._live: dict[int, int] = {}  # key -> birth
        self._holders: dict[int, int] = {}  # birth -> its keys alive
        self._born: list[int] = []  # bytes a birth
        # birth i as i + 1, its death as -(i + 1), in the order they ran;
        # the timeline's index where each phase after the first starts
        self._timeline: list[int] = []
        self._starts: list[int] = []
        self._backward = False
        self.phase_peaks: list[int] = []
        self.phase_bases: list[int] = []
        self.tail: int | None = None
        self.temp: int | None = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        outs = [t for t in _pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if any(isinstance(t, self._fake) for t in outs):
            return out
        # a dead storage keeps its key while its weak reference is held, so
        # a storage not seen before is a new one
        new = [(t, ref) for t, ref in ((t, StorageWeakRef(t.untyped_storage()))
                                       for t in outs)
               if ref.cdata not in self._args and ref.cdata not in self._live]
        backward = torch._C._current_graph_task_id() != -1
        if not new and backward == self._backward:
            return out  # the peak moves only where storages are born
        # the inputs are alive while the op runs: what died since the last
        # op that made a storage died before this op's outputs were made
        self._poll()
        if backward != self._backward:
            self._backward = backward
            self._starts.append(len(self._timeline))
        alias = (func.namespace == "_c10d_functional"
                 and func.__name__.split(".")[0] in _ALIASES)
        for t, ref in new:
            key = ref.cdata
            if key in self._live:  # an op's two outputs on one storage
                continue
            self._refs.append(ref)
            src = self._storage_key(args[0]) if alias else None
            if src in self._args:
                self._args.add(key)
                continue
            if src in self._live:  # the input's, held as long as this one
                birth = self._live[src]
            else:
                birth = len(self._born)
                self._born.append(t.untyped_storage().nbytes())
                self._timeline.append(birth + 1)
            self._live[key] = birth
            self._holders[birth] = self._holders.get(birth, 0) + 1
        return out

    def _poll(self) -> None:
        """Records the deaths of the storages whose weak references have
        expired."""
        expired = torch.Storage._expired
        for key in [k for k in self._live if expired(k)]:
            birth = self._live.pop(key)
            self._holders[birth] -= 1
            if not self._holders[birth]:
                self._timeline.append(-1 - birth)

    def mark(self) -> None:
        """Starts a phase here and makes it `tail`."""
        self._poll()
        self._backward = torch._C._current_graph_task_id() != -1
        self._starts.append(len(self._timeline))
        self.tail = len(self._starts)

    @staticmethod
    def _storage_key(t: torch.Tensor) -> int:
        return StorageWeakRef(t.untyped_storage()).cdata

    def finish(self, returned: PyTree) -> int:
        """Sets `phase_peaks` and `phase_bases` and returns `temp`, the
        largest peak: the most bytes alive at once of the storages born
        while active, the ones `returned` (the step's outputs) holds left
        out; drops the weak references."""
        out = {self._live.get(self._storage_key(t))
               for t in _local_leaves(returned)}
        starts = iter(self._starts)
        start = next(starts, None)
        live, peaks, bases = 0, [0], [0]
        for i, event in enumerate(self._timeline + [0]):
            while start == i:
                peaks.append(live)
                bases.append(live)
                start = next(starts, None)
            if event and abs(event) - 1 not in out:
                n = self._born[abs(event) - 1]
                live += n if event > 0 else -n
                peaks[-1] = max(peaks[-1], live)
        self.phase_peaks, self.phase_bases = peaks, bases
        self.temp = max(peaks)
        self._refs, self._live, self._holders = [], {}, {}
        self._born, self._timeline = [], []
        return self.temp


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


def _pod_step(cfg, cell: ShapeCell, mesh, optimizer) -> tuple:
    """One pod's step on `mesh.shard_mesh` (a mesh whose DeviceMesh stands
    on a placeholder group): the step, its arguments as meta DTensors
    placed by the specs of one pod's (data, model) layout at the pod's
    rows (`_pod_rows`), and the sharding rules it runs under."""
    sizes = mesh_shape(mesh)
    single = Mesh(("data", "model"), (sizes["data"], sizes["model"]),
                  torch.device("meta"))
    rows = _pod_rows(cell, sizes.get("pod", 1), sizes["data"])
    built = cell_args(cfg, dataclasses.replace(cell, global_batch=rows),
                      single, False, optimizer)
    dm = mesh.shard_mesh
    flat, treedef = _pytree.tree_flatten(built["args"])
    args = _pytree.tree_unflatten(
        [None if t is None else _placed(t, s, dm)
         for t, s in zip(flat, sp.spec_leaves(built["specs"]))], treedef)
    rules = (shrules.DEFAULT_RULES if cell.kind == "train"
             else sp.serve_rules(single))
    return built["step"], args, rules, single


def count_step(cfg, cell: ShapeCell, mesh, optimizer, memory: bool = False
               ) -> CollectiveBytes:
    """Rank 0's collectives and refusals in one pod's step as meta
    DTensors (`_pod_step`); with `memory` a `StepMemory` that also holds
    the step's peak temporaries, the train step's tail
    (`steps.apply_update`) marked as a phase of its own (`tail`)."""
    counted = None
    if memory and cell.kind == "train":
        inner = optimizer

        def update_(grads, state, params):
            counted.mark()
            inner.update_(grads, state, params)
        optimizer = dataclasses.replace(inner, update_=update_)
    step, args, rules, single = _pod_step(cfg, cell, mesh, optimizer)
    counted = StepMemory(args) if memory else CollectiveBytes()
    with shrules.use_rules(rules, single), counted:
        out = step(*args)
    if memory:
        counted.finish(out)
    return counted


def count_tail(cfg, cell: ShapeCell, mesh, optimizer) -> int:
    """Rank 0's peak temporaries in the train step's tail alone
    (`steps.apply_update`): on one pod's arguments placed as `count_step`
    places them, beside gradients placed as the parameters (as `grad_fn`
    places them), in their dtype or, where the step accumulates
    microbatches, in float32; the gradients are arguments, not
    temporaries."""
    from torch.distributed.tensor import DTensor

    _, (params, state, _), rules, single = _pod_step(cfg, cell, mesh,
                                                     optimizer)
    dtype = torch.float32 if cfg.train_microbatches > 1 else None

    def grad(p):
        local = torch.empty(p.to_local().shape, dtype=dtype or p.dtype,
                            device="meta")
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    grads = _pytree.tree_map(grad, params)
    counted = StepMemory((grads, state, params))
    with shrules.use_rules(rules, single), counted:
        norm = apply_update(optimizer, grads, state, params)
    return counted.finish(norm)


def pod_mix_bytes(param_shard_bytes_f32: int, graph) -> int:
    """Bytes a device ships per comm round in the pod mix: one all-reduce
    of its parameter shard on the complete graph, k exchanges of it on a
    k-regular graph."""
    rounds = 1 if graph.name == "complete" else graph.degree
    return rounds * param_shard_bytes_f32


def cell_args(cfg, cell: ShapeCell, mesh, multi_pod: bool, optimizer
              ) -> dict:
    """A cell's step (a training step overwrites the state it is given),
    its arguments on the meta device beside their specs (pod-stacked on
    the multi-pod mesh for training), the arguments of one pod's call of
    the step, and the devices that call runs on."""
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


#: the depths (superblocks) the dry-run counts a step at, from which its
#: counts extend to a config's: a step's peak grows by a fixed amount a
#: superblock only from the second on (the first takes the embedding's
#: output)
DEPTHS = (2, 3)


def _meta_runs(cfg, cell: ShapeCell, mesh, multi_pod: bool, optimizer
               ) -> dict:
    """One pod's step counted on meta: its `flops`, which of its argument
    leaves it `read` (by position), and rank 0's collective output bytes
    by kind (`collectives`), collective calls by kind (`calls`), peak
    temporaries (`temp`) and ops on DTensors torch 2.11 refuses
    (`refused`). The superblock repetitions are identical work, so the
    step runs on meta at the `DEPTHS`, plainly for the flops and the
    reads and as DTensors on `mesh.shard_mesh` for the rest, and the
    counts extend to `cfg.n_super` (`extended`; at most as deep: run
    there), a train step's tail counted alone at each of those depths
    (`count_tail`). The leaves read are the same at any depth."""
    runs = []
    deep = cfg.n_super > DEPTHS[-1]
    for n in DEPTHS if deep else (cfg.n_super,):
        part_cfg = dataclasses.replace(cfg, n_super=n)
        part = cell_args(part_cfg, cell, mesh, multi_pod, optimizer)
        flops, read = _meta_run(part["step"], part["pod_args"])
        run = {"flops": flops, **counts(count_step(
            part_cfg, cell, mesh, optimizer, memory=True))}
        if deep and cell.kind == "train":
            run["tail_temp"] = count_tail(part_cfg, cell, mesh, optimizer)
        runs.append(run)
        read = [[id(t) in read for t in _leaves(a)] for a in part["pod_args"]]
    tail_temp = (count_tail(cfg, cell, mesh, optimizer)
                 if deep and cell.kind == "train" else None)
    return {**extended(runs, cfg.n_super, tail_temp), "read": read}


def counts(counted: StepMemory) -> dict:
    """A DTensor run's counts that extend to depth: collective bytes and
    calls by kind, each phase's peak and starting bytes, which phase is
    the train step's tail, refusals."""
    return {"collectives": counted.bytes, "calls": counted.calls,
            "phases": counted.phase_peaks, "bases": counted.phase_bases,
            "tail": counted.tail, "refused": len(counted.refused)}


def extended(runs: list[dict], n_super: int,
             tail_temp: int | None = None) -> dict:
    """`runs`' counts (`counts`, with "flops" where counted) at the
    `DEPTHS`, extended linearly to `n_super` superblocks, with `temp`, the
    largest phase's peak (one run: at `n_super` itself). The sums extend
    as they are; the peak phase by phase, then the largest, since the
    phases grow by different amounts a superblock (a training step's
    backward by its checkpointed inputs, an inference step's peak not at
    all). A train step's tail (`steps.apply_update`) holds the gradients
    and the optimizer's float32 temporaries for one leaf's chunk at a
    time, and its grad norm's for one whole leaf: those follow the
    largest leaf, which may be another at `n_super` (a stacked leaf
    overtakes the embedding), so its phase is the bytes alive where it
    starts, extended, plus `tail_temp`, the tail counted alone at
    `n_super` (`count_tail`); each run's tail phase must be its bases
    plus its own "tail_temp", else this raises. tests/test_torch_dryrun.py
    holds the extension to a count at a depth past them."""
    if len(runs) == 1:
        return {**runs[0], "temp": max(runs[0]["phases"])}
    one, two = runs
    if len(one["phases"]) != len(two["phases"]) or one["tail"] != two["tail"]:
        raise RuntimeError(f"the step's phases at {DEPTHS} superblocks "
                           f"differ")

    def extend(a, b):
        return a + (n_super - DEPTHS[0]) * (b - a)
    out = {k: extend(one[k], two[k]) for k in ("flops", "refused")
           if k in one}
    peaks = [extend(a, b) for a, b in zip(one["phases"], two["phases"])]
    tail = one["tail"]
    if tail is not None:
        for run in runs:
            if run["phases"][tail] != run["bases"][tail] + run["tail_temp"]:
                raise RuntimeError(
                    f"the train step's tail peaks at {run['phases'][tail]} "
                    f"B where its bases {run['bases'][tail]} B and its "
                    f"count alone {run['tail_temp']} B sum otherwise")
        peaks[tail] = extend(one["bases"][tail],
                             two["bases"][tail]) + tail_temp
    out["temp"] = max(peaks)
    for k in ("collectives", "calls"):
        out[k] = {kind: extend(one[k].get(kind, 0), two[k].get(kind, 0))
                  for kind in KINDS if kind in one[k] or kind in two[k]}
    return out


def reckon(cfg, cell: ShapeCell, layout: Mesh, multi_pod: bool, optimizer
           ) -> dict:
    """A cell's reckoned fields (memory, cost, collectives and their
    calls, refusals, bytes_per_device, devices, lower_s, compile_s) on
    `layout`, a Mesh of the meta device whose (pod,) data and model axes
    are the production mesh's or any other's, counted over a placeholder
    process group of its size made and destroyed here (it raises beside
    a default process group)."""
    sizes = mesh_shape(layout)
    rec: dict[str, Any] = {}
    t0 = time.time()
    built = cell_args(cfg, cell, layout, multi_pod, optimizer)
    args, specs = built["args"], [_specs(s) for s in built["specs"]]
    leaves = [_leaves(a) for a in args]
    rec["lower_s"] = round(time.time() - t0, 1)

    t1 = time.time()
    with placeholder_group(layout.size) as group:
        runs = _meta_runs(cfg, cell, placed_on(layout, group), multi_pod,
                          optimizer)
    rec["compile_s"] = round(time.time() - t1, 1)
    read, collectives = runs["read"], runs["collectives"]

    def total(i, only_read=False):
        return sum(sp.shard_bytes(t, s, layout) for t, s, r in
                   zip(leaves[i], specs[i], read[i]) if r or not only_read)

    arg_bytes = sum(total(i, only_read=True) for i in range(len(args)))
    if cell.kind == "train":
        state_bytes = total(0) + total(1)
        n_metrics = sizes["pod"] if multi_pod else 1
        out_bytes = state_bytes + 2 * 4 * n_metrics  # loss, grad_norm
        alias_bytes = state_bytes
        if multi_pod:
            # the fused step's float32 mix of each device's parameter shard
            shard_f32 = sum(sp.shard_bytes(t, s, layout) // t.element_size()
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
                                   layout)
        alias_bytes = 0
    else:
        # logits (B, 1, V), B as the tokens are laid out, and the cache
        B = cell.global_batch
        logits = torch.empty((B, 1, cfg.vocab_size), dtype=cfg.dtype,
                             device="meta")
        cache_bytes = total(1)
        out_bytes = cache_bytes + sp.shard_bytes(
            logits, built["specs"][2][:1], layout)
        alias_bytes = cache_bytes
    temp = float(runs["temp"])
    rec["memory"] = {"argument_size_in_bytes": float(arg_bytes),
                     "output_size_in_bytes": float(out_bytes),
                     "temp_size_in_bytes": temp,
                     "generated_code_size_in_bytes": None,
                     "alias_size_in_bytes": float(alias_bytes)}
    rec["cost"] = {"flops": runs["flops"] / built["run_devices"]}
    rec["collectives"] = collectives
    rec["hlo_collective_op_counts"] = {k: runs["calls"].get(k, 0)
                                       for k in KINDS}
    # the port's own: ops on DTensors torch 2.11 refuses (0 to build there)
    rec["sharding_refusals"] = runs["refused"]
    rec["bytes_per_device"] = float(arg_bytes + temp
                                    + max(out_bytes - alias_bytes, 0))
    rec["devices"] = layout.size
    return rec


def dryrun_cell(arch: str, cell: ShapeCell, multi_pod: bool,
                *, save: bool = True, verbose: bool = True,
                cfg_override=None) -> dict:
    """Build one (arch, shape, mesh) cell on meta tensors and reckon its
    per-device bytes, temporaries and rank 0's collectives on the
    production mesh (`reckon`); return the record."""
    cfg = cfg_override or registry.get_config(arch, "full")
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict[str, Any] = {"arch": arch, "shape": cell.name,
                           "mesh": mesh_name, "kind": cell.kind,
                           "seq_len": cell.seq_len,
                           "global_batch": cell.global_batch}
    optimizer = adamw(cosine_lr(3e-4, 10000),
                      moment_dtype=(torch.bfloat16 if cfg.opt_moments_bf16
                                    else torch.float32))
    rec.update(reckon(cfg, cell, make_production_mesh(multi_pod=multi_pod),
                      multi_pod, optimizer))
    if verbose:
        print(f"[dryrun] {arch} {cell.name} {mesh_name}: "
              f"build {rec['lower_s']}s meta run {rec['compile_s']}s  "
              f"mem/dev {rec['bytes_per_device'] / 2 ** 30:.2f} GiB "
              f"(temp {rec['memory']['temp_size_in_bytes'] / 2 ** 30:.2f})"
              f"  flops {rec['cost']['flops']:.3g}  "
              f"refused {rec['sharding_refusals']}", flush=True)
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
