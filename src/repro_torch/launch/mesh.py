"""The launcher's mesh, the port of `repro.launch.mesh`.

The reference lays a run out on a (pod, data, model) mesh of chips: the
`pod` axis carries the paper's consensus graph, `data` and `model` shard
each pod's replica (FSDP and tensor parallelism). The port has two
layouts that run:

  * `make_mesh(shape, axes)`: a run's pods stacked on one card (a leading
    pod dimension on every leaf), mixed by kernel K1;
  * `make_mesh(shape, axes, group=g)`: the pod axis spans the ranks of a
    `torch.distributed` process group, one pod per rank (rank r holds pod
    r), mixed by the collectives of `core.consensus`.

Either way each pod lies whole on one device: data and model axes above 1
are refused on a real device until they execute (DTensor placements, the
multi-card slice). `make_production_mesh` gives the reference's
production layouts on the `meta` device, to reckon per-device bytes on
(the dry-run), not to run on.
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
    """Axis names and sizes of a run's layout, the device each pod runs
    on, and, when the pod axis spans processes, their group."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device: torch.device
    #: the process group the pod axis spans (None: pods stacked on one
    #: device)
    group: Any = None

    @property
    def size(self) -> int:
        """Devices the layout holds (the reference's `devices.size`)."""
        return math.prod(self.shape)

    @property
    def pod_rank(self) -> int:
        """The pod this process holds (0 when the pods are stacked)."""
        if self.group is None:
            return 0
        return dist.get_rank(self.group)

    @contextlib.contextmanager
    def bind(self):
        """Bind the axis name "pod" to the mesh's group for the
        collectives of `core.consensus` (the counterpart of the reference's
        shard_map over the axis)."""
        from repro_torch.core.consensus import bind_axis

        with bind_axis("pod", self.group):
            yield


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout on the meta device: (data=16,
    model=16), or (pod=2, data=16, model=16) for the multi-pod mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, torch.device("meta"))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device=None, group=None) -> Mesh:
    """A mesh of `shape` over `axes`. With `group=None` the pods stack on
    `device` (None: the CUDA card). With a `torch.distributed` process
    group, the pod axis spans its ranks: its size must equal the pod axis
    (`ValueError` otherwise), and `device` is this rank's (None: the
    current CUDA device, which the caller sets per rank with
    `torch.cuda.set_device`). Raises `ValueError` for a data or model axis
    larger than 1."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an axis below 1")
    wide = {a: s for a, s in zip(axes, shape) if a in _SHARD_AXES and s > 1}
    if wide:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))}: the port holds each pod whole "
            f"on one card (stacked, or one pod a rank) and does not shard "
            f"a pod; the data/model axes {sorted(wide)} come with the "
            f"multi-card slice")
    if group is not None:
        n_pods = dict(zip(axes, shape)).get("pod", 1)
        size = dist.get_world_size(group)
        if size != n_pods:
            raise ValueError(f"the process group has {size} ranks but the "
                             f"mesh's pod axis {n_pods}: one pod a rank")
    return Mesh(axes, shape, resolve_device(device), group)


def mesh_shape(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def num_pods(mesh: Mesh) -> int:
    return mesh_shape(mesh).get("pod", 1)
