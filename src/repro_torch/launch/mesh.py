"""The launcher's mesh, the port of `repro.launch.mesh`.

The reference lays a run out on a (pod, data, model) mesh of chips: the
`pod` axis carries the paper's consensus graph, `data` and `model` shard
each pod's replica (FSDP and tensor parallelism). The port's layouts:

  * `make_mesh(shape, axes)`: a run's pods stacked on one card (a leading
    pod dimension on every leaf), mixed by kernel K1, each pod whole;
  * `make_mesh(shape, axes, group=g)` with data = model = 1: the pod axis
    spans the ranks of a `torch.distributed` process group, one pod per
    rank (rank r holds pod r), mixed by the collectives of
    `core.consensus`;
  * `make_mesh(shape, axes, group=g)` with a data or model axis above 1:
    each pod's replica is sharded over a `torch.distributed` DeviceMesh
    (`Mesh.shard_mesh`, axes data and model) as DTensors placed by the
    sharding rules (`runtime.sharding.to_placements`). With a group of
    pod x data x model ranks every axis spans ranks, one pod a rank, and
    the pods mix over the DeviceMesh's `pod` sub-group; with a group of
    data x model ranks the pods stack on every rank and K1 mixes each
    rank's local shards.

`make_serve_mesh` lays inference out over a process group: every axis
spans ranks, the pods as further data ranks (the reference's serving
replicates the parameters across pods and splits the batch over them).

`make_production_mesh` gives the reference's production layouts on the
`meta` device, to reckon per-device bytes on (the dry-run), not to run on;
over a placeholder process group it carries their DeviceMesh, on which
the dry-run runs a step as meta DTensors to count its collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import resolve_device

#: axes a pod's replica would be sharded over
_SHARD_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a run's layout, the device this process runs
    on, the process group its ranks form (None: one process), and the
    DeviceMesh of the axes that span ranks when a pod is sharded."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device: torch.device
    #: the process group the mesh's ranks form (None: pods stacked on one
    #: device)
    group: Any = None
    #: the DeviceMesh of the axes that span ranks: (pod, data, model) with
    #: one pod a rank, (data, model) with the pods stacked on every rank;
    #: None when each pod lies whole on its device
    device_mesh: Any = None

    @property
    def size(self) -> int:
        """Devices the layout holds (the reference's `devices.size`)."""
        return math.prod(self.shape)

    @property
    def shard_mesh(self):
        """The (data, model) DeviceMesh a pod's leaves lie on as DTensors,
        or None when each pod lies whole on one device."""
        dm = self.device_mesh
        if dm is None or "pod" not in dm.mesh_dim_names:
            return dm
        return dm["data", "model"]

    @property
    def pod_group(self):
        """The process group the pod axis spans (None: the pods stack on
        every rank)."""
        if self.group is None:
            return None
        if self.device_mesh is None:
            return self.group
        if "pod" in self.device_mesh.mesh_dim_names:
            return self.device_mesh.get_group("pod")
        return None

    @property
    def pod_rank(self) -> int:
        """The pod this process holds (0 when the pods are stacked)."""
        group = self.pod_group
        return 0 if group is None else dist.get_rank(group)

    @contextlib.contextmanager
    def bind(self):
        """Bind the axis name "pod" to the pod axis's group for the
        collectives of `core.consensus` (the counterpart of the reference's
        shard_map over the axis)."""
        from repro_torch.core.consensus import bind_axis

        with bind_axis("pod", self.pod_group):
            yield


def make_production_mesh(*, multi_pod: bool = False, group=None) -> Mesh:
    """The reference's production layout on the meta device: (data=16,
    model=16), or (pod=2, data=16, model=16) for the multi-pod mesh. With
    a process group of the layout's size (the dry-run's placeholder
    group, whose ranks hold no device) it also carries a DeviceMesh of
    that shape over the group's ranks, on which meta DTensors run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = Mesh(axes, shape, torch.device("meta"))
    return mesh if group is None else placed_on(mesh, group)


def placed_on(layout: Mesh, group) -> Mesh:
    """`layout` (a Mesh on the meta device) with a "cuda" DeviceMesh of its
    axes over the ranks of `group` (the dry-run's placeholder group, of
    the layout's size), on which meta DTensors run."""
    if dist.get_world_size(group) != layout.size:
        raise ValueError(f"the layout {layout.shape} needs a group of "
                         f"{layout.size} ranks, not "
                         f"{dist.get_world_size(group)}")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.tensor(dist.get_process_group_ranks(group)).reshape(
        layout.shape)
    return dataclasses.replace(layout, group=group, device_mesh=DeviceMesh(
        "cuda", ranks, mesh_dim_names=layout.axis_names))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device=None, group=None) -> Mesh:
    """A mesh of `shape` over `axes`. With `group=None` the pods stack on
    `device` (None: the CUDA card), each whole: a data or model axis above
    1 raises `ValueError`, naming the process group it needs. With a
    `torch.distributed` process group, whose every rank makes the mesh
    (the DeviceMesh builds its sub-groups collectively), of
      * pod ranks, data = model = 1: one pod a rank, each whole;
      * data x model ranks: the pods stacked on every rank, each pod's
        replica sharded over a (data, model) DeviceMesh;
      * pod x data x model ranks: one pod a rank, sharded over the
        (data, model) sub-mesh of a (pod, data, model) DeviceMesh;
    any other size raises `ValueError`. `device` is this rank's (None: the
    current CUDA device, which the caller sets per rank with
    `torch.cuda.set_device`)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an axis below 1")
    sizes = dict(zip(axes, shape))
    n_pods = sizes.get("pod", 1)
    wide = {a: s for a, s in sizes.items() if a in _SHARD_AXES and s > 1}
    shards = math.prod(sizes.get(a, 1) for a in _SHARD_AXES)
    if group is None:
        if wide:
            raise ValueError(
                f"mesh {sizes}: the data/model axes {sorted(wide)} shard "
                f"each pod over ranks, so the mesh needs a process group "
                f"(group=) of {n_pods * shards} ranks (one pod a rank) or "
                f"{shards} ranks (the pods stacked on every rank)")
        return Mesh(axes, shape, resolve_device(device))
    size = dist.get_world_size(group)
    device = resolve_device(device)
    if not wide:
        if size == n_pods:
            return Mesh(axes, shape, device, group)
        if size != 1:
            raise ValueError(f"the process group has {size} ranks but the "
                             f"mesh's pod axis {n_pods}: one pod a rank")
    data_model = (sizes.get("data", 1), sizes.get("model", 1))
    if size == shards:
        dims, names = data_model, _SHARD_AXES
    elif size == n_pods * shards:
        dims, names = (n_pods,) + data_model, ("pod",) + _SHARD_AXES
    else:
        raise ValueError(
            f"the process group has {size} ranks but the mesh {sizes} "
            f"needs {n_pods * shards} (one pod a rank) or {shards} (the "
            f"pods stacked on every rank)")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.tensor(dist.get_process_group_ranks(group)).reshape(dims)
    return Mesh(axes, shape, device, group,
                DeviceMesh(device.type, ranks, mesh_dim_names=names))


def make_serve_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
                    group, device=None) -> Mesh:
    """The mesh inference runs on: every axis spans the ranks of `group`,
    whose size must be the mesh's, the pods as further data ranks
    (serving replicates the parameters over them and splits the batch
    and the caches' rows over ('pod', 'data'), `launch.specs.
    serve_placements`). Its DeviceMesh is (data, model) with the pods
    folded into the data dim, pod-major: two mesh dims, over which
    DTensor plans its first calls in seconds (over three, with the rows
    sharded over two of them, its search took minutes). Pods beside a
    data axis of several ranks are refused: the folded dim would spread
    the parameters' data shards over the pods, which the reference
    replicates. Every rank makes it (the DeviceMesh builds its
    sub-groups collectively); one rank serves on (data 1, model 1).
    `device` is this rank's (None: the current CUDA device)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or not set(axes) <= {"pod", *_SHARD_AXES}:
        raise ValueError(f"a serving mesh's axes are among pod, data and "
                         f"model, one size each: {axes}, {shape}")
    sizes = dict(zip(axes, shape))
    pods, data, model = (sizes.get(a, 1) for a in ("pod", *_SHARD_AXES))
    if pods > 1 and data > 1:
        raise ValueError(
            f"a serving mesh folds its {pods} pods into the data ranks, "
            f"which keeps the reference's placements (the parameters "
            f"replicated over the pods) only where the data axis has one "
            f"rank: {sizes}")
    size = dist.get_world_size(group)
    if size != math.prod(shape):
        raise ValueError(f"the process group has {size} ranks but the "
                         f"serving mesh {sizes} needs {math.prod(shape)}")
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    ranks = torch.tensor(dist.get_process_group_ranks(group)).reshape(
        pods * data, model)
    return Mesh(axes, shape, device, group,
                DeviceMesh(device.type, ranks, mesh_dim_names=_SHARD_AXES))


def mesh_shape(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def num_pods(mesh: Mesh) -> int:
    return mesh_shape(mesh).get("pod", 1)
