"""The launcher's mesh, the port of `repro.launch.mesh`, on one card.

The reference lays a run out on a (pod, data, model) mesh of chips: the
`pod` axis carries the paper's consensus graph, `data` and `model` shard
each pod's replica (FSDP and tensor parallelism). The port stacks a run's
pods on one card (a leading pod dimension on every leaf) and mixes them
with kernel K1, so its mesh records the axis sizes and the device, and
accepts only data and model axes of size 1: sharding a pod across cards
comes with the multi-card slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device

#: axes a pod's replica would be sharded over
_SHARD_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a run's layout, and the one card it runs
    on."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device: torch.device


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device=None) -> Mesh:
    """A mesh of `shape` over `axes` on `device` (None: the CUDA card).
    Raises `ValueError` for a data or model axis larger than 1."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an axis below 1")
    wide = {a: s for a, s in zip(axes, shape) if a in _SHARD_AXES and s > 1}
    if wide:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))}: the port stacks a run's pods "
            f"on one card and does not shard a pod; the data/model axes "
            f"{sorted(wide)} come with the multi-card slice")
    return Mesh(axes, shape, resolve_device(device))


def mesh_shape(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))
